#!/usr/bin/env python3
"""Chip smoke run of lra_tpu_torch, the PyTorch/CUDA port of lra_tpu.

    python3 chip_smoke.py      # from the repository root, one CUDA GPU
    python3 chip_smoke.py --save-k4 PATH   # also save each path's largest
                                           # K4 input (tools/kernel_compare.py)
    python3 chip_smoke.py --save-k2 PATH   # the same for K2
    python3 chip_smoke.py --save-k6 PATH   # every K6 launch of each path
    python3 chip_smoke.py --save-p1 PATH   # every P1 launch of each path
    python3 chip_smoke.py --save-k3 PATH   # every K3 launch of each path
    python3 chip_smoke.py --save-k8 PATH   # K8's / K9's input in the
    python3 chip_smoke.py --save-k9 PATH   # mesh phase (kernels line)

Needs a CUDA device and nvcc (the kernels are built from csrc/ at first
use); exits non-zero without a result line otherwise, and on any
failure.  Phases:

1. the card's name and power limit; the parallel nvcc build of every
   kernel source, and ptxas's registers and spills for each kernel;
2. kernels: each hand-written kernel against its plain torch twin on
   seeded inputs at a spread of shapes — exact equality — with median
   CUDA-event times (K2 at both tiers and every launch plan, N = 64 to
   8192, B = 1 to 4096, on invalid rows that keep lane bits, empty
   problems and tie-dense problems; K4 and K5 at every K tier, off-tier
   K up to 1023,
   S 16 to 2048 and the edge problems of sim.refine_problems, with each
   of their launch plans; K6 with every plan of og.plan_variants at
   (K, D) buckets up to 2052 lanes, the tier edges K = 16, 32, 64, D 16
   to 4096 (past the shared memory of the planes), B across the
   warps-a-problem edge, buckets of pad rows and tie-dense problems, in
   both closure regimes with gaps of 200 bp to 50 kb; K3 with every plan
   at N = 64..8192 on K2's outputs and on sim.mask_problems' edges; P1
   with every plan at S = 16..14528 on sim.rowsync_problems' edges, its
   decoded blocks equal to K4's; K7 at N = 1280..40960 with W =
   64..16384, B = 1..3, on an instance where the far term wins and on
   tie-dense instances), K7's cluster size and how many such clusters fit
   on the card; K8 (chain_scores) with every plan of
   sdp.scan_plan_variants at B 1-512, N 1-9472 on sim.scan_bucket's
   kinds (invalid rows, unsorted, tie-dense, one lane or both, scores
   near 2^25), a zero-slope piece and a piece of negative penalty; K9
   (banded_global_kernel) with every plan of ak.arrows_plan_variants at K
   4-1100, S 12-512 and B=65536 S=16 K=30, kband None and per problem,
   edge rows (qlen 0, tlen 0, |qlen - tlen| > K), its arrows walked ==
   K4's ops;
3. end to end, through align_reads(..., device="cuda"), each path run
   with the launch counts reset just before and read just after, device
   stage times from CUDA events; a path fails if one of its kernels was
   not launched, or if the SHA-256 of its SAM lines is not the one
   recorded in RECORDED_SHA:
   - on one 2 Mb random genome (numpy seed 0), each path a recorded
     warm-up (the largest input each kernel got, the job mix) and then a
     timed run: CCS with use_pallas=True and in the default
     configuration (bench.py's shapes: 256 reads of 8 kb, snp 0.003,
     ins/del 0.001, numpy seed 0); ONT (384 reads of 12 kb, snp 0.03,
     ins/del 0.01, seed 1, one batch) and CLR (256 reads of 10 kb, snp
     0.072, ins/del 0.024, seed 2, batches of 128): bench.py's shapes and
     error split;
   - CONTIG, each path one recorded, counted and timed run: (a) bench.py's
     shape, 8 contigs of 500 kb with a 5 kb DEL and a 2 kb INS (numpy seed
     3) on the 2 Mb genome; (b) the 2.5 Mb draft contig of
     tests/test_golden.py (0.4 % one-base indels, 0.1 % SNPs, a 5 kb DEL,
     a 2 kb INS; seed 5, 5.5 Mb genome), whose SDP-2 problem exceeds 8192
     fragments and runs on K7; (c) a 7 Mb draft contig of the same recipe
     (seed 5, 10 Mb genome), whose SDP-2 problem exceeds SHARD_N = 32768
     fragments and is solved in q-range shard rounds on K7;
4. K3 on a driver path: copies of the CCS batch's SDP-2 problems with
   need_full=False through solve_problems; best_chain and chain_vmax
   must equal the need_full=True results;
5. the recorded main-path inputs: each kernel against its plain twin
   again (exact), timed, beside its bound; K5 and K4 on the largest
   input of each path, exact and timed with each launch plan, whole and
   with the walk skipped, and every K4 launch's (B, S, K) per path; K2's
   (B, N, need_full) per path, and K2 on each path's largest input,
   exact with each launch plan, timed per call and back to back; every K6
   launch's (B, K, D, real problems, longest shorter side) per path, and
   K6 on each path's largest input and the one with the most rows a
   problem, exact with every plan, timed per call and back to back; every
   P1 launch's (B, S, K) per path, and P1 on each of them, exact with
   every plan and its blocks equal to K4's, timed per call and back to
   back; K3's (B, N) on the driver path, exact with every plan; K7 on
   the largest input of CONTIG (b) and of (c), exact and timed with
   clusters of 8 and 16 CTAs;
5b. the data-parallel mesh (mesh_phase): (a) combined_device_step,
   sharded_chain_scores, sharded_banded_align and K8 through run_shards
   at dryrun_multichip's shapes, on ONT's K2 bucket and on K4's largest
   bucket, on make_mesh() and on [cuda:0] x MESH_N, each equal to its
   unsharded call, the counts reset just before the sharded calls (K8's
   and K9's launches for the kernels line); (b) CCS in both
   configurations, ONT and CONTIG (c) through align_reads under the
   [cuda:0] x MESH_N mesh: SAM lines and their SHA-256 equal to the
   unsharded run's and the recorded ones, launches MESH_N x the
   unsharded run's, walls beside the unsharded ones; (c)
   dryrun_multichip's q-range contig under that mesh;
6. SAM lines byte-equal between device="cpu" (the plain twins) and
   device="cuda": the first 16 CCS reads in both configurations, the
   first 4 ONT and CLR reads, and a 500 kb draft contig on the 2 Mb
   genome with the port's buckets cut to (64,) and SHARD_N to 2048 for
   that call, so that K7 and the shard rounds lie on the compared path;
7. the -t N stream: CCS (default configuration), ONT and CLR at their
   full sizes through align_stream(..., device="cuda") in batches of 64
   reads at 1, 2 and 4 workers, each batch awaited with a time limit:
   SAM lines byte-equal to phase 3's, launches per kernel 1 x the
   sequential run's (no mesh), and at 2 and 4 workers every launch on
   its worker's own non-default stream (a wrapper of ops/_ext.launch
   records them), two streams at least; reads/s at each worker count;
8. device-round statistics (utils/devstats.py on): one warm batch each
   of CCS, ONT and CLR, the pack / compute / copy / post split of every
   round, the host time inside the kernel launches, launches per round;
9. the command line, `python -m lra_tpu_torch.cli` in a temporary
   directory on the 2 Mb genome and 64 CCS reads: `index`, `align -t 4`
   (records = align_reads' lines), two `align --nproc 2` processes
   sharing the card and `merge` (= the single run but @PG), `-p p` and
   `-p b` (= align_reads' lines), `qti`;
10. one more run each of CCS in both configurations, ONT, CLR and
   CONTIG (b), and of CCS, ONT and CLR through the stream at 4 workers,
   under torch.profiler: the device's busy share and the device time and
   launches of the hand kernels against all other kernels.

Also: the path and ABI version of the native host library it loaded
(built first if stale; a failed build ends the run); the full CCS
use_pallas run's SAM lines equal to the full CCS default run's; a JSON line
{"sam_sha256": {path: SHA-256 of its full SAM lines}} before the card's
name.  The line before the last is the kernels JSON object; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, full 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores.  The DP and SDP kernels do
# f32/int32 scalar work, so the f32 rate is the operation bound.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# operations per unit of work, counted from the kernels' inner loops:
# a linear-gap DP cell (substitution select, two adds, max, masks,
# closure add+max, two arrow compares), a refine DP cell (two lanes,
# two closures, five-way arrow), a one-gap DP cell (K6: ~20 for the
# substitution, masks, border seeds, row and five-way arrow, plus an
# add and a max per doubling step of the closure, see one_gap_bound),
# an SDP fragment pair (both lanes: masks, |d| + 1, PWL piece select,
# multiply, add, floor, clamps, V + w, max), and a K3 row (mask, compare,
# select).
OPS_PER_CELL = {"banded_global_traced_packed": 10,
                "banded_pallas_rowsync": 10,
                "banded_global_kernel": 10,
                "banded_refine_traced_packed": 18,
                "one_gap_traced": 20}
OPS_PER_PAIR = 40
OPS_PER_MASK_ROW = 3
BACK_TO_BACK = 20           # launches between two events, back to back

KERNELS = {
    "chain_scores_blocked": ("lra_tpu_torch/csrc/sdp_blocked.cu",
                             "lra_tpu/ops/sdp_blocked.py:33"),
    "chain_mask_from_scores": ("lra_tpu_torch/csrc/chain_mask.cu",
                               "lra_tpu/ops/sdp_blocked.py:143"),
    "banded_global_traced_packed": ("lra_tpu_torch/csrc/banded_global.cu",
                                    "lra_tpu/ops/affine_kernel.py:206"),
    "banded_refine_traced_packed": ("lra_tpu_torch/csrc/banded_refine.cu",
                                    "lra_tpu/ops/affine_kernel.py:546"),
    "one_gap_traced": ("lra_tpu_torch/csrc/one_gap.cu",
                       "lra_tpu/ops/one_gap.py:434"),
    "banded_pallas_rowsync": ("lra_tpu_torch/csrc/banded_global.cu",
                              "lra_tpu/ops/affine_pallas.py:225"),
    "chain_scores_windowed": ("lra_tpu_torch/csrc/sdp_windowed.cu",
                              "lra_tpu/ops/sdp_windowed.py:111"),
    # no align_reads path calls these two: the mesh phase drives them
    "chain_scores": ("lra_tpu_torch/csrc/sdp_blocked.cu",
                     "lra_tpu/ops/sdp.py:52"),
    "banded_global_kernel": ("lra_tpu_torch/csrc/banded_global.cu",
                             "lra_tpu/ops/affine_kernel.py:142"),
}
MESH_KERNELS = ("chain_scores", "banded_global_kernel")
# each path's SHA-256 of its full SAM lines as an earlier run of this
# script printed them (its {"sam_sha256": ...} line, NVIDIA H100 80GB
# HBM3), before the mesh existed: every run, sharded or not, is held to
# them
RECORDED_SHA = {
    "ccs use_pallas=True":
    "3bad4d86ff08c2f75de05928ee03b010da2a1dcd2c5aa55a83b912e9c165edd6",
    "ccs": "3bad4d86ff08c2f75de05928ee03b010da2a1dcd2c5aa55a83b912e9c165edd6",
    "ont": "383cffb8dee3d32a9c9c0a0835e5f7d4d3d7ea29ecceaf6f7617fb3c52d532cb",
    "clr": "5718a8510804835a0d294a5e0d4a0a45891bc3dad795b35bc649fd9b842ec893",
    "contig bench":
    "ba1c43636983a0f212ee0bb668b10738df9ec69c5716038519ecd98781daf6db",
    "contig 2.5 Mb":
    "0347e8078069281d3c2e8aefd9a36e71ef4e014f6c156fac58299d2766100c79",
    "contig 7 Mb":
    "8aa5ec5c8048533ccdc52f3298cdd4f83fa4625b10629dbdb9bbadaf37c4fbe5",
}
# the mesh phase: entries of the one-card mesh ([cuda:0] * MESH_N) and
# the paths it runs through align_reads
MESH_N = 4
MESH_PATHS = ("ccs use_pallas=True", "ccs", "ont", "contig 7 Mb")
M, MM, IND = 4, -3, -4      # CCS local_match / local_mismatch / local_indel
DEV = "cuda"                # the device every path runs on
T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        ts.append(timed(fn)[1])
    return statistics.median(ts)


def timed(fn) -> tuple:
    """(fn(), its CUDA-event time in ms) for one run."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def exact(name, a, b) -> float:
    """Raise unless kernel output a equals plain output b bit for bit;
    returns max |a - b| (0.0 once they are equal)."""
    import torch

    bits_a, bits_b = a, b
    if a.dtype == torch.float32:
        bits_a, bits_b = a.view(torch.int32), b.view(torch.int32)
    if a.shape != b.shape or not torch.equal(bits_a, bits_b):
        diff = (bits_a != bits_b).nonzero() if a.shape == b.shape else []
        raise AssertionError(f"{name}: kernel != plain twin at "
                             f"{diff[:5].tolist()} ({len(diff)} elements)")
    return float((a.double() - b.double()).abs().max()) if a.numel() \
        else 0.0


# one launch a round on the round's device, mesh or not: its regions are
# no [B, ...] bucket for the mesh to shard
UNSHARDED = ("refine_shaped",)


def expect_launches(tag, counts, base, factor) -> None:
    """Raise unless every kernel's launches are factor x base's: 1 for a
    run on one device (no mesh active: the stream phase's workers share
    the card), n for a mesh of n entries (each bucket's kernel runs once
    a shard); the UNSHARDED kernels' as base's either way."""
    want = {k: (1 if k in UNSHARDED else factor) * v
            for k, v in base.items()}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {factor} x the "
                             f"unsharded run's {base}")


# ------------------------------------------------------------- inputs ---

def banded_inputs(rng, B, S, K, dev):
    """Seeded gap-like problems: t random, q = t with SNPs and one indel,
    lengths drifting within the band."""
    import torch

    t = rng.integers(0, 4, (B, S)).astype(np.int8)
    q = t.copy()
    for b in range(B):
        for _ in range(int(rng.integers(0, max(2, S // 32)))):
            p = int(rng.integers(0, S))
            q[b, p] = (q[b, p] + 1) % 4
        if rng.random() < 0.7:
            p = int(rng.integers(1, S - 1))
            q[b, p:] = np.roll(q[b, p:], int(rng.integers(1, 3)))
    qlen = rng.integers(S // 2, S + 1, B).astype(np.int32)
    drift = min(K, 12)
    tlen = np.clip(qlen + rng.integers(-drift, drift + 1, B), 1,
                   S).astype(np.int32)
    kb = np.minimum(np.abs(qlen - tlen) + rng.integers(0, K + 1, B),
                    K).astype(np.int32)
    kb = np.maximum(kb, np.abs(qlen - tlen)).astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (q, t, qlen, tlen, kb)]


def one_gap_inputs(rng, B, K, D, query_longer, gaps, dev, kind="random",
                   pads=1):
    """K6's seven tensors for B one-long-gap problems of a (K, D) bucket
    and `pads` of gap_align's pad rows (qlen 1, tlen 4, kband 1):
    lra_tpu_torch.sim.one_gap_problems, random or tie-dense (kind)."""
    import torch

    from lra_tpu_torch.ops.one_gap import pack_one_gap_bucket
    from lra_tpu_torch.sim import one_gap_problems

    qs, ts, kbs = one_gap_problems(rng, B, K, D, query_longer, gaps, kind,
                                   pads)
    packed = pack_one_gap_bucket(qs, ts, K, D)
    return [torch.from_numpy(a).to(dev)
            for a in list(packed) + [np.asarray(kbs, np.int32)]]


def sdp_inputs(rng, B, N, dev, nvalid=None):
    import torch

    ln = rng.integers(15, 60, (B, N))
    qS = np.sort(rng.integers(0, 40 * N, (B, N)), axis=1)
    tS = (qS + rng.integers(-1500, 1500, (B, N))).clip(0)
    strand = rng.random((B, N)) < 0.8
    valid = np.ones((B, N), bool)
    if nvalid is not None:
        for b in range(B):
            valid[b, nvalid[b]:] = False
    arrs = [qS.astype(np.int32), (qS + ln).astype(np.int32),
            tS.astype(np.int32), (tS + ln).astype(np.int32),
            (ln * 2.0).astype(np.float32), strand, ~strand, valid]
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs]


def blocked_inputs(rng, B, N, kind, dev):
    """K2's arguments: sim.sdp_bucket ("edges"), tie-dense problems at the
    driver's padding ("tie": sim.tie_dense_chain_arrays, collectors tying
    across every root in both lanes), or sdp_inputs ("random")."""
    import torch

    from lra_tpu_torch.chain import driver
    from lra_tpu_torch.sim import sdp_bucket, tie_dense_chain_arrays

    if kind == "random":
        return sdp_inputs(rng, B, N, dev)
    if kind == "tie":
        plist = [driver.ChainProblem(*tie_dense_chain_arrays(
            rng, int(rng.integers(1, N // 4 + 2)),
            int(rng.integers(1, N // 2 + 1)))) for _ in range(B)]
        arrays = driver.pad_problems(plist, B, N)
    else:
        arrays = sdp_bucket(rng, B, N)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in arrays]


def windowed_inputs(rng, sizes, N, dev, kind="contig"):
    """K7's 17 arguments at the driver's padding, [B = len(sizes), N], of
    contig-like problems, of the repeat-dense FAR-sentinel instance
    (lra_tpu_torch.sim.contig_chain_arrays) or of tie-dense problems of
    (roots, collectors) (sim.tie_dense_chain_arrays)."""
    import torch

    from lra_tpu_torch.chain import driver
    from lra_tpu_torch.sim import contig_chain_arrays, tie_dense_chain_arrays

    if kind == "tie":
        plist = [driver.ChainProblem(*tie_dense_chain_arrays(rng, *n))
                 for n in sizes]
    else:
        plist = [driver.ChainProblem(*contig_chain_arrays(
            rng, n, kind == "repeat")) for n in sizes]
    arrays = driver.pad_problems(plist, len(plist), N) + \
        driver.pad_far_schedules(plist, len(plist), N)
    return [torch.from_numpy(a).to(dev) for a in arrays]


# ------------------------------------------------------------ bounds ---

def bound(nbytes, ops) -> tuple:
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(tb, to) * 1e3, "bytes" if tb > to else "operations"


def dp_bound(name, K, q, t, tlen, out) -> tuple:
    """Least time for the DP rows this data needs (rows 0..tlen of the
    band per problem): max(bytes / HBM rate, operations / f32 rate)."""
    rows = int((tlen.clamp(max=t.shape[1]).long() + 1).sum())
    ops = rows * (2 * K + 1) * OPS_PER_CELL[name]
    nbytes = q.numel() + t.numel() + 3 * 4 * q.shape[0] + out.numel()
    return bound(nbytes, ops)


def one_gap_rows(args, K, D) -> tuple:
    """Per problem of a K6 call: the prefix rows 1..min(D+K-1,
    tBoundary-1) and the suffix rows up to tlen (those that hold a valid
    cell; the kernel computes no other row)."""
    qlen, tlen, kb = (a.long() for a in args[4:7])
    diag = qlen.minimum(tlen)
    prow = (diag + kb - 1).minimum(tlen).clamp(0, D + K - 1)
    tlow = (tlen - diag - kb - 2).clamp(min=0)
    return prow, (tlen - tlow).clamp(0, D + K + 2)


def one_gap_real(args):
    """The problems of a K6 call that hold a job: all but gap_align's pad
    rows (qlen 1, tlen 4, kband 1)."""
    return ~((args[4] == 1) & (args[5] == 4) & (args[6] == 1))


def one_gap_bound(args, K, D, L, ops_out) -> tuple:
    """K6 on this data: the rows of one_gap_rows, 2K+1 prefix and 2K+4
    suffix cells each, each cell's int8 arrow written once, one arrow
    read per traceback op; inputs read and outputs written once."""
    prow, srow = one_gap_rows(args, K, D)
    cells = int((prow * (2 * K + 1) + srow * (2 * K + 4)).sum())
    steps = int((ops_out >= 0).sum())
    per_cell = OPS_PER_CELL["one_gap_traced"] + \
        2 * math.ceil(math.log2(2 * K + 4))
    nbytes = sum(4 * a.numel() for a in args) + ops_out.numel() + \
        8 * args[4].numel() + cells + steps
    return bound(nbytes, cells * per_cell)


def k6_picks(calls) -> dict:
    """A path's two K6 inputs: the largest by work, B x (D + K) x K (the
    main-path recorder's measure), and the one with the most valid rows
    in one problem (one warp's serial chain)."""
    def rows(a):
        p, s = one_gap_rows(a, a[7], a[8])
        return int((p + s).max())
    work = max(calls, key=lambda a: a[0].numel() * a[7])
    longest = max(calls, key=rows)
    out = {"largest": work}
    if longest is not work:
        out["longest rows"] = longest
    return out


def sdp_bound(args) -> tuple:
    qS, valid = args[0], args[7]
    n = valid.sum(dim=1).double()
    pairs = float((n * (n - 1) / 2).sum())
    nbytes = qS.numel() * (4 * 4 + 4 + 3 + 3 * 4)
    return bound(nbytes, pairs * OPS_PER_PAIR)


def scan_bound(args) -> tuple:
    """K8 on this data: every row i (invalid ones too: their bp and lane
    are outputs) against the valid rows j < i, OPS_PER_PAIR each; inputs
    read once (23 bytes a row, the 48 PWL constants), V, bp and lane
    written once."""
    valid = args[7]
    before = valid.long().cumsum(1) - valid.long()
    pairs = float(before.sum())
    nbytes = valid.numel() * (23 + 12) + 2 * 24 * 4
    return bound(nbytes, pairs * OPS_PER_PAIR)


def windowed_bound(args, W) -> tuple:
    """K7 on this data: per block of 64 rows, its valid rows against the
    valid rows of its near window [b0 - W, b0) (the kernel skips the
    front pad and invalid rows) and the in-block triangle, both at
    OPS_PER_PAIR; the 6 squarings of the 64 x 64 closure (an add and a max
    per term); the two prefix-max scans over N per refresh round.  Each
    input read once, V/bp/lane written once."""
    import torch

    from lra_tpu_torch.ops.sdp_windowed import _refresh_blocks

    valid = args[7]
    B, N = valid.shape
    L = 64
    per_block = valid.reshape(B, N // L, L).sum(2).double()
    cum = torch.cat([torch.zeros(B, 1, dtype=torch.float64,
                                 device=valid.device),
                     valid.double().cumsum(1)], 1)
    b0 = torch.arange(0, N, L, device=valid.device)
    window = cum[:, b0] - cum[:, (b0 - W).clamp(min=0)]
    pairs = float((per_block * window + per_block * (per_block - 1) / 2)
                  .sum())
    nb = N // L
    ops = pairs * OPS_PER_PAIR + B * nb * 6 * L ** 3 * 2 + \
        B * (nb // _refresh_blocks(L, W, N)) * 2 * N * 2
    nbytes = B * N * (10 * 4 + 4 + 5 + 3 * 4) + B * nb * 4
    return bound(nbytes, ops)


def mask_bound(V, bits) -> tuple:
    """K3: V and valid read once, one bp read per chain row the walk
    visits, vmax and the bit words written once."""
    visited = int(sum(bin(int(w) & 0xFFFFFFFF).count("1")
                      for w in bits.flatten().tolist()))
    nbytes = V.numel() * 5 + 4 * visited + 4 * V.shape[0] + 4 * bits.numel()
    return bound(nbytes, V.numel() * OPS_PER_MASK_ROW + visited)


# ------------------------------------------------------------- phases ---

def rowsync_plan_str(plan) -> str:
    return ("PPC {PPC} R {R} smem {smem}, " + ("shared" if plan["smem_plane"]
                                               else "device") + " plane"
            ).format(**plan)


def rowsync_check(tag, a, K, scores=(M, MM, IND)) -> tuple:
    """P1 on a (q, t, qlen, tlen, kband) against its plain twin, through
    the wrapper and with every plan of ap.rowsync_plan_variants: the P
    plane equal byte for byte; its decoded blocks equal K4's on the same
    inputs.  Returns (the twin's ms, the plans' names)."""
    import torch

    from lra_tpu_torch.ops import affine_kernel as ak
    from lra_tpu_torch.ops import affine_pallas as ap

    S = a[0].shape[1]
    ref, pms = timed(lambda: ap.banded_pallas_rowsync_plain(
        *a[:4], K, *scores, a[4]))
    got = ap.banded_pallas_rowsync(*a[:4], K, *scores, kband=a[4])
    torch.cuda.synchronize()
    exact(f"banded_pallas_rowsync {tag}", got, ref)
    names = []
    for name, plan in ap.rowsync_plan_variants(S):
        out = ap._rowsync_cuda(*a[:4], a[4], K, *scores, plan=plan)
        torch.cuda.synchronize()
        exact(f"banded_pallas_rowsync {tag} {name}", out, ref)
        names.append(name)
    ops = ak.banded_global_traced_packed(*a[:4], K, *scores, kband=a[4])
    ql, tl = a[2].cpu().numpy(), a[3].cpu().numpy()
    rs = ap.blocks_from_rowsync(got.cpu().numpy(), ql, tl, S)
    k4 = ak.blocks_from_ops_batch(ak.unpack_ops(ops.cpu().numpy()))
    if rs != k4:
        bad = [b for b, (x, y) in enumerate(zip(rs, k4)) if x != y]
        raise AssertionError(f"banded_pallas_rowsync {tag}: decoded blocks "
                             f"differ from K4's at problems {bad[:5]}")
    return pms, names


def mask_check(tag, args) -> None:
    """K3 on (V, bp, valid) against its plain twin, through the wrapper
    and with every plan of sb.mask_plan_variants: vmax (as int32 bits)
    and the words equal; logs the wrapper's time beside the twin's."""
    import torch

    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import sdp_blocked as sb

    B, N = args[0].shape
    ref, pms = timed(lambda: sb.chain_mask_from_scores_plain(*args))
    runs = [("wrapper", lambda: sb.chain_mask_from_scores(*args))]
    runs += [(name, lambda plan=plan: sb._chain_mask_from_scores_cuda(
        *args, plan=plan)) for name, plan in sb.mask_plan_variants(N)]
    for name, fn in runs:
        got = fn()
        torch.cuda.synchronize()
        exact(f"chain_mask_from_scores {tag} {name} vmax", got[0], ref[0])
        exact(f"chain_mask_from_scores {tag} {name} bits", got[1], ref[1])
    ms = cuda_ms(runs[0][1], 5)
    plan = sb.mask_plan(N, B, _ext.sm_count(0))
    log(f"kernel chain_mask_from_scores {tag} (tier {plan['tier']}, "
        f"{plan['ppb']} a block, {plan['threads']} threads): exact with "
        f"{', '.join(n for n, _ in runs[1:])}; {ms:.4f} ms (plain "
        f"{pms:.1f} ms)")


def scan_checks(dev, rng) -> None:
    """K8 against its twin, exact, through the wrapper and with every plan
    of sdp.scan_plan_variants (the warp tier, the CTA tier, tier 2 with
    the lists in device scratch): sim.scan_bucket's kinds (sorted on both
    lanes or one lane a strand, invalid rows that still get bp and lane,
    unsorted fragments, tie-dense problems, scores near 2^25 on fragments
    that are predecessors on both lanes at once) at B 1-512 and N 1-9472
    (N off the blocks of 64: 1, 63, 100, 9472), a zero-slope piece of
    nonzero intercept (pwl_jnp's formula, not K2's table of effective
    pieces) and a piece of negative penalty (no pruning).  Beside K8's
    time, K2's on the same bucket where K2 takes it (N a multiple of 64
    up to 8192, the preset's pieces; on them both compute one function,
    but for the lane where V + w1 and V + w2 round equal)."""
    import torch

    from lra_tpu_torch import preset
    from lra_tpu_torch.ops import sdp
    from lra_tpu_torch.ops import sdp_blocked as sb
    from lra_tpu_torch.ops.gapcost import from_options
    from lra_tpu_torch.sim import negative_piece, scan_bucket, zero_slope_piece

    gp = from_options(preset("ccs"))
    pieces = {"preset": (gp.slope, gp.inter),
              "zero-slope piece": zero_slope_piece(gp.slope, gp.inter),
              "negative piece": negative_piece(gp.slope, gp.inter)}
    for B, N, kind, piece in ((512, 64, "invalid", "preset"),
                              (512, 512, "both_lanes", "preset"),
                              (512, 512, "one_lane", "preset"),
                              (64, 512, "unsorted", "preset"),
                              (16, 1024, "tie", "preset"),
                              (13, 2048, "invalid", "zero-slope piece"),
                              (4, 4096, "unsorted", "preset"),
                              (1, 8192, "both_lanes", "preset"),
                              (2, 9472, "invalid", "preset"),
                              (5, 1, "unsorted", "preset"),
                              (7, 63, "unsorted", "negative piece"),
                              (4, 100, "unsorted", "zero-slope piece"),
                              (3, 512, "big_scores", "preset"),
                              (64, 512, "both_lanes", "negative piece"),
                              (2, 2048, "unsorted", "negative piece")):
        a = [torch.from_numpy(x).to(dev) for x in scan_bucket(rng, B, N,
                                                             kind)]
        sl, it = (torch.from_numpy(x).to(dev) for x in pieces[piece])
        pwl = (sl, it, gp.ceiling1, gp.ceiling2)
        ref, pms = timed(lambda: sdp.chain_scores_plain(*a, *pwl))
        runs = [("wrapper", lambda: sdp.chain_scores(*a, *pwl))]
        runs += [(name, lambda plan=plan: sdp._chain_scores_cuda(
            *a, *pwl, plan=plan)) for name, plan in
            sdp.scan_plan_variants(N)]
        for name, fn in runs:
            got = fn()
            torch.cuda.synchronize()
            for nm, x, y in zip(("V", "bp", "lane"), got, ref):
                exact(f"chain_scores B={B} N={N} {kind} {piece} {name} "
                      f"{nm}", x, y)
        ms = cuda_ms(runs[0][1], 3)
        bnd, by = scan_bound(a)
        k2 = ""
        if piece == "preset" and N % 64 == 0 and N <= 8192:
            k2ms = cuda_ms(lambda: sb.chain_scores_blocked(
                *a, gp.static_key()), 3)
            k2 = f", K2 on this bucket {k2ms:.4f} ms"
        log(f"kernel chain_scores B={B} N={N} {kind} {piece} "
            f"({scan_plan_str(sdp.scan_plan(N))}; prunes "
            f"{sdp.scan_prune_np(*pieces[piece], gp.ceiling1, gp.ceiling2)}"
            f"): exact, and with "
            f"{', '.join(scan_plan_str(p) for _, p in sdp.scan_plan_variants(N))}"
            f"; {ms:.4f} ms (plain {pms:.1f} ms, bound {bnd:.5f} ms, {by}"
            f"{k2})")


def scan_plan_str(plan) -> str:
    return ("tier {tier} threads {threads} smem {smem} scratch {scratch}"
            .format(**plan))


def arrows_plan_str(plan, K, T) -> str:
    from lra_tpu_torch.ops import affine_kernel as ak

    sp, smem = ak.arrows_launch(plan, K, T)
    if plan["tier"] == "cta":
        return f"CTA tier, {plan['threads']} threads, smem {smem}"
    return ("CPT {CPT} WP {WP} PPC {PPC}, ".format(**plan)
            + (f"planes staged ({sp} B a problem)" if sp
               else "rows written directly") + f", smem {smem}")


def arrows_checks(dev, rng) -> None:
    """K9 against its twin, exact (score bits, arrows), through the wrapper
    and with every plan of ak.arrows_plan_variants: banded_inputs at K
    4-1100 (K4's warp rows at CPT 2, 9 and WP 5; the CTA tier past K =
    1023) and S 12-512, kband None and per problem, then the same buckets
    with their first rows at the edges (qlen 0, tlen 0, |qlen - tlen| > K
    both ways: the wrapped and clamped score cell); planes staged in
    shared memory and, where a block's planes exceed its stage bytes (S
    = 256 and 512 at 8 problems a block), written row by row; K4's
    largest main-path bucket, B=65536 S=16 K=30 (68 MB of arrows).  On
    the unedited buckets up to K = 1023, K9's arrows walked by
    _traceback_ops_plain == K4's ops (banded_global_traced) on the same
    inputs."""
    import torch

    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import affine_kernel as ak

    for B, S, K in ((13, 16, 4), (64, 64, 10), (256, 128, 30),
                    (16, 512, 30), (2048, 256, 30), (200, 40, 100),
                    (6, 24, 600), (5, 12, 1100), (65536, 16, 30)):
        q, t, ql, tl, kb = banded_inputs(rng, B, S, K, dev)
        score, arrows = ak.banded_global_kernel(q, t, ql, tl, K, M, MM, IND,
                                                kband=kb)
        if K <= 1023:
            walk = ak._traceback_ops_plain(arrows.permute(1, 0, 2), ql, tl,
                                           K, 2 * S)
            k4 = ak.banded_global_traced(q, t, ql, tl, K, M, MM, IND,
                                         kband=kb)
            torch.cuda.synchronize()
            exact(f"banded_global_kernel B={B} S={S} K={K}: walked arrows "
                  "vs K4's ops", walk, k4)
        ql2, tl2 = ql.clone(), tl.clone()
        for b, (x, y) in enumerate(((0, 5), (5, 0), (S, max(1, S - K - 3)),
                                    (3, S))):
            ql2[b], tl2[b] = x, y
        plans = ak.arrows_plan_variants(K)
        for tag, qlen, tlen in (("", ql, tl), (" edges", ql2, tl2)):
            for kband in (None, kb):
                full = kband if kband is not None else \
                    torch.full_like(ql, K)
                ref, pms = timed(lambda: ak.banded_global_kernel_plain(
                    q, t, qlen, tlen, K, M, MM, IND, full))
                runs = [("wrapper", lambda: ak.banded_global_kernel(
                    q, t, qlen, tlen, K, M, MM, IND, kband=kband))]
                runs += [(name, lambda plan=plan: ak._arrows_cuda(
                    q, t, qlen, tlen, full, K, M, MM, IND, plan=plan))
                    for name, plan in plans]
                what = "None" if kband is None else "per problem"
                for name, fn in runs:
                    got = fn()
                    torch.cuda.synchronize()
                    lab = (f"banded_global_kernel B={B} S={S} K={K}{tag} "
                           f"kband {what} {name}")
                    exact(f"{lab} score", got[0], ref[0])
                    exact(f"{lab} arrows", got[1], ref[1])
        ms = cuda_ms(lambda: ak.banded_global_kernel(q, t, ql, tl, K, M, MM,
                                                     IND, kband=kb), 5)
        bnd, by = dp_bound("banded_global_kernel", K, q, t, tl, arrows)
        plan = ak.arrows_plan(K, B, _ext.sm_count(0))
        log(f"kernel banded_global_kernel B={B} S={S} K={K} "
            f"({arrows_plan_str(plan, K, S)}): exact, kband None and per "
            f"problem, edge rows, with "
            f"{', '.join(arrows_plan_str(p, K, S) for _, p in plans)}"
            + ("; walk == K4's ops" if K <= 1023 else "")
            + f"; {ms:.4f} ms (plain {pms:.1f} ms, bound {bnd:.5f} ms, "
            f"{by})")


def kernel_phase(dev) -> None:
    import torch

    from lra_tpu_torch import preset
    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import affine_kernel as ak
    from lra_tpu_torch.ops import affine_pallas as ap
    from lra_tpu_torch.ops import one_gap as og
    from lra_tpu_torch.ops import sdp_blocked as sb
    from lra_tpu_torch.ops import sdp_windowed as sw
    from lra_tpu_torch.ops.gapcost import from_options
    from lra_tpu_torch.sim import (mask_problems, refine_problems,
                                   rowsync_problems)

    rng = np.random.default_rng(0)
    key = from_options(preset("ccs")).static_key()
    # K2 at every tier (a warp a problem at N = 64, a block above), B = 1,
    # 13, 512 and 4096 (more blocks than fit at once), N up to 8192, on
    # sim.sdp_bucket's edge rows (invalid
    # rows that keep lane bits, an all-invalid problem with lane bits, an
    # empty problem) and tie-dense problems, with every launch plan; the
    # last case (B=16 N=8192, the earlier kernel phase's) feeds K3 below
    for B, N, kind in ((4096, 64, "edges"), (512, 64, "edges"),
                       (13, 64, "edges"),
                       (1, 64, "edges"), (13, 128, "edges"),
                       (512, 512, "edges"), (13, 512, "edges"),
                       (1, 2048, "edges"), (13, 2048, "edges"),
                       (1, 8192, "edges"), (13, 64, "tie"), (13, 128, "tie"),
                       (3, 512, "tie"), (2, 2048, "tie"),
                       (16, 8192, "random")):
        a = blocked_inputs(rng, B, N, kind, dev)
        ref, pms = timed(lambda: sb.chain_scores_blocked_plain(*a, key))
        got = sb.chain_scores_blocked(*a, key)
        torch.cuda.synchronize()
        for nm, x, y in zip(("V", "bp", "lane"), got, ref):
            exact(f"chain_scores_blocked B={B} N={N} {kind} {nm}", x, y)
        for plan in sb.plan_variants(N):
            out = sb._chain_scores_blocked_cuda(*a, key, 64, plan=plan)
            torch.cuda.synchronize()
            for nm, x, y in zip(("V", "bp", "lane"), out, ref):
                exact(f"chain_scores_blocked B={B} N={N} {kind} "
                      f"{sb.plan_str(plan)} {nm}", x, y)
        ms = cuda_ms(lambda: sb.chain_scores_blocked(*a, key), 5)
        bnd, by = sdp_bound(a)
        log(f"kernel chain_scores_blocked B={B} N={N} {kind} "
            f"({sb.plan_str(sb.sdp_plan(N))}): exact, and "
            f"with each launch plan; {ms:.4f} ms (plain {pms:.1f} ms, "
            f"bound {bnd:.5f} ms, {by})")
    # K3 on K2's last outputs (real backpointers; a prefix of a problem is
    # a problem, bp[i] < i) with valid prefixes, then on sim.mask_problems'
    # buckets (no valid row, vmax < 0, vmax = 0, ties for vmax, a chain of
    # all N rows) at N = 64 to 8192, B across the warp tier's edge of 8
    # problems a block; every plan
    V, bp = got[0], got[1]
    valid = torch.arange(N, device=dev)[None, :] < \
        torch.from_numpy(rng.integers(1, N + 1, 16)).to(dev)[:, None]
    full = 8 * _ext.sm_count(0)
    cases = [(f"K2 outputs B=16 N={NN}", [x[:, :NN].contiguous()
                                         for x in (V, bp, valid)])
             for NN in (64, 512, N)]
    cases += [(f"B={Bm} N={Nm}", [torch.from_numpy(x).to(dev) for x in
                                  mask_problems(rng, Bm, Nm)])
              for Bm, Nm in ((13, 64), (full - 1, 64), (full, 64),
                             (13, 512), (full, 512), (13, 1024),
                             (full, 1024), (13, 2048), (5, 4096),
                             (300, 8192))]
    for name, args in cases:
        mask_check(name, args)
    # K7: driver-padded contig-like problems (a block count that is no
    # multiple of the cluster, windows of fewer blocks than the cluster's
    # CTAs, three clusters), one where the far term wins (FAR1/FAR2
    # sentinels), and tie-dense problems whose first-index and lane ties
    # cross CTAs
    ckey = from_options(preset("contig")).static_key()
    for W in (64, 4096, 16384):
        log(f"K7 cluster at W={W}: {sw.cluster_info(W)}")
    for sizes, N, W, kind in (((8000, 3000), 8192, 4096, "contig"),
                              ((16000,), 16384, 16384, "contig"),
                              ((40000,), 40960, 4096, "contig"),
                              ((0,), 1664, 64, "repeat"),
                              ((8200,), 8256, 4096, "contig"),
                              ((3000,), 3072, 128, "contig"),
                              ((5000, 2000), 5120, 256, "contig"),
                              ((9000, 4000, 6000), 9216, 4096, "contig"),
                              (((2000, 3000),), 5056, 1024, "tie"),
                              (((700, 500), (300, 400)), 1280, 256, "tie")):
        a = windowed_inputs(rng, sizes, N, dev, kind)
        got = sw.chain_scores_windowed(*a, ckey, W=W)
        torch.cuda.synchronize()
        ref, pms = timed(lambda: sw.chain_scores_windowed_plain(*a, ckey,
                                                                W=W))
        for nm, x, y in zip(("V", "bp", "lane"), got, ref):
            exact(f"chain_scores_windowed {sizes} N={N} W={W} {nm}", x, y)
        far = int((ref[1] < -1).sum())
        if kind != "contig" and not far:
            raise AssertionError(f"chain_scores_windowed: the far term won "
                                 f"nowhere on the {kind} instance")
        ms = cuda_ms(lambda: sw.chain_scores_windowed(*a, ckey, W=W), 3)
        bnd, by = windowed_bound(a, W)
        log(f"kernel chain_scores_windowed B={len(sizes)} N={N} W={W} "
            f"({kind}, {far} FAR sentinels): exact; {ms:.3f} ms (plain "
            f"{pms:.1f} ms, bound {bnd:.4f} ms, {by})")
    # K4 and K5 on the same buckets: banded_inputs at K 30 and 64 (and K4
    # at 128 and 512); then sim.refine_problems (indels of 1-6 bases, the
    # edge rows) at every K tier, off-tier K (100, 700, 1023) and S
    # 16-2048, B no multiple of the problems a block holds
    banded = [(banded_inputs(rng, 8, S, K, dev), K)
              for K in (30, 64) for S in (256, 1024)]
    for B, S, K in ((13, 16, 30), (64, 64, 30), (13, 128, 64),
                    (13, 256, 128), (13, 200, 100), (9, 512, 256),
                    (9, 1024, 512), (7, 2048, 700), (7, 2048, 1023)):
        banded.append(([torch.from_numpy(x).to(dev) for x in
                        refine_problems(rng, B, S, K)], K))
    k4 = banded + [(banded_inputs(rng, 8, S, K, dev), K)
                   for K in (128, 512) for S in (256, 2048)]
    for a, K in k4:
        B, S = a[0].shape
        got = ak.banded_global_traced_packed(*a[:4], K, M, MM, IND,
                                             kband=a[4])
        torch.cuda.synchronize()
        ref, pms = timed(lambda: ak.banded_global_traced_packed_plain(
            *a[:4], K, M, MM, IND, a[4]))
        exact(f"banded_global_traced_packed B={B} K={K} S={S}", got, ref)
        for name, plan in plan_variants(ak.global_plan, K):
            got = ak._global_cuda(*a[:4], a[4], K, M, MM, IND, plan=plan)
            torch.cuda.synchronize()
            exact(f"banded_global_traced_packed B={B} K={K} S={S} {name}",
                  got, ref)
        ms = cuda_ms(lambda: ak.banded_global_traced_packed(
            *a[:4], K, M, MM, IND, kband=a[4]), 5)
        log(f"kernel banded_global_traced_packed B={B} K={K} S={S} "
            f"{plan_str(ak.global_plan(K, B))}: exact, and with each "
            f"launch plan; {ms:.3f} ms (plain {pms:.1f} ms)")
    for a, K in banded:
        B, S = a[0].shape
        got = ak.banded_refine_traced_packed(*a[:4], K, M, MM, IND,
                                             kband=a[4])
        torch.cuda.synchronize()
        ref, pms = timed(lambda: ak.banded_refine_traced_packed_plain(
            *a[:4], K, M, MM, IND, a[4]))
        exact(f"banded_refine_traced_packed B={B} K={K} S={S}", got, ref)
        for name, plan in plan_variants(ak.refine_plan, K):
            got = ak._refine_cuda(*a[:4], a[4], K, M, MM, IND, plan=plan)
            torch.cuda.synchronize()
            exact(f"banded_refine_traced_packed B={B} K={K} S={S} {name}",
                  got, ref)
        ms = cuda_ms(lambda: ak.banded_refine_traced_packed(
            *a[:4], K, M, MM, IND, kband=a[4]), 5)
        log(f"kernel banded_refine_traced_packed B={B} K={K} S={S} "
            f"{plan_str(ak.refine_plan(K, B))}: exact, and with each "
            f"launch plan; {ms:.3f} ms (plain {pms:.1f} ms)")
    # P1 on sim.rowsync_problems (the walk's edges, then rows with SNPs
    # and indels) at S = 16 to 2048 and at K = 15, 30 and 31 (band 63, the
    # widest P1 takes), B across the edge of 8 problems a block, S = 2048
    # where 6 problems fit a block, S = 14528 where none fits (the device
    # plane); every plan of ap.rowsync_plan_variants
    for B, S, K in ((13, 16, 30), (full - 1, 16, 30), (full, 16, 30),
                    (13, 32, 30), (2048, 32, 30), (13, 64, 15),
                    (full, 64, 30), (13, 64, 31), (13, 512, 30),
                    (full, 512, 30), (13, 2048, 30), (full, 2048, 30),
                    (8, 14528, 30)):
        a = [torch.from_numpy(x).to(dev)
             for x in rowsync_problems(rng, B, S, K)]
        pms, names = rowsync_check(f"B={B} S={S} K={K}", a, K)
        ms = cuda_ms(lambda: ap.banded_pallas_rowsync(
            *a[:4], K, M, MM, IND, kband=a[4]), 5)
        log(f"kernel banded_pallas_rowsync B={B} S={S} K={K} "
            f"({rowsync_plan_str(ap.rowsync_plan(S, B))}): exact with "
            f"{', '.join(names)}, blocks == K4's; {ms:.3f} ms (plain "
            f"{pms:.1f} ms)")
    # K6 in both closure regimes with every launch plan (og.plan_variants):
    # PR 2's (K, D) buckets up to 2052 lanes; the tier edges (K = 16 and
    # 32 the warp tier, 64 the CTA tier); D from 16 to 4096 (the planes
    # leave shared memory at K=32 D=2048 and K=16 D=4096); B across the
    # warps-a-problem edge (edge rows: a pair of warps a problem; one
    # more: one warp, 4 problems a block, the last block part-full);
    # buckets of gap_align's pad rows; tie-dense problems
    edge = og._OG_FULL_WARPS * _ext.sm_count(0) // 2
    for B, K, D, gaps, kind, pads in (
            (64, 16, 64, (200, 400), "random", 1),
            (16, 64, 1024, (1000, 50000), "random", 1),
            (4, 512, 2048, (2000, 50000), "random", 1),
            (4, 1024, 1024, (2100, 5000), "random", 1),
            (13, 16, 16, (0, 400), "random", 1),
            (13, 32, 16, (0, 400), "random", 1),
            (13, 64, 16, (0, 400), "random", 1),
            (13, 32, 64, (0, 400), "random", 1),
            (8, 32, 256, (200, 5000), "random", 1),
            (8, 32, 512, (200, 5000), "random", 1),
            (4, 32, 1024, (200, 5000), "random", 1),
            (4, 32, 2048, (200, 5000), "random", 1),
            (4, 16, 2048, (200, 5000), "random", 1),
            (2, 16, 4096, (200, 5000), "random", 1),
            (edge - 1, 16, 16, (0, 400), "random", 1),
            (edge, 16, 16, (0, 400), "random", 1),
            (1, 16, 16, (0, 400), "random", 7),
            (0, 32, 64, (0, 400), "random", 8),
            (13, 16, 64, (0, 400), "tie", 1),
            (13, 32, 256, (200, 2000), "tie", 1)):
        for query_longer in (True, False):
            a = one_gap_inputs(rng, B, K, D, query_longer, gaps, dev, kind,
                               pads)
            Bt = B + pads
            L = 2 * (D + K) + 8
            ref, pms = timed(lambda: og.one_gap_traced_plain(
                *a, K, D, M, MM, IND, L))
            gap_op = og.GAPLEFT if query_longer else og.GAPDOWN
            if int((ref[0][:B] == gap_op).sum()) != B:
                raise AssertionError(f"one_gap_traced K={K} D={D}: not "
                                     "one gap op per problem")
            names = []
            for name, plan in og.plan_variants(K, D, Bt):
                got = og._one_gap_traced_cuda(*a, K, D, M, MM, IND, L,
                                              plan=plan)
                torch.cuda.synchronize()
                for nm, x, y in zip(("ops", "jump", "score"), got, ref):
                    exact(f"one_gap_traced B={Bt} K={K} D={D} {kind} "
                          f"{name} {nm}", x, y)
                names.append(name)
            ms = cuda_ms(lambda: og.one_gap_traced(*a, K, D, M, MM, IND, L),
                         5)
            log(f"kernel one_gap_traced B={Bt} K={K} D={D} {kind} "
                f"{'GAPLEFT' if query_longer else 'GAPDOWN'} gaps "
                f"{gaps[0]}-{gaps[1]}: exact with {', '.join(names)} "
                f"({og.plan_str(og.one_gap_plan(K, D, Bt))}); {ms:.3f} ms "
                f"(plain {pms:.1f} ms)")
    # K8 and K9, the mesh's two kernels
    scan_checks(dev, rng)
    arrows_checks(dev, rng)


def clone_call(args, kw) -> tuple:
    """Copies of a call's tensor arguments (the caller may reuse them)."""
    def c(x):
        return x.clone() if hasattr(x, "clone") else x
    return [c(x) for x in args], {k: c(v) for k, v in kw.items()}


class Recorder:
    """Wraps the kernel entry points the pipeline calls and keeps the
    inputs of the largest call each kernel gets (warm-up runs only)."""

    SITES = (("lra_tpu_torch.pipeline.gap_align", "banded_global_traced_packed"),
             ("lra_tpu_torch.pipeline.gap_align", "banded_refine_traced_packed"),
             ("lra_tpu_torch.pipeline.gap_align", "banded_pallas_rowsync"),
             ("lra_tpu_torch.pipeline.gap_align", "one_gap_traced"),
             ("lra_tpu_torch.chain.driver", "chain_scores_blocked"),
             ("lra_tpu_torch.chain.driver", "chain_mask_from_scores"),
             ("lra_tpu_torch.chain.driver", "chain_scores_windowed"),
             # the driver's single-best-chain round (need_full=False):
             # K2 then K3
             ("lra_tpu_torch.chain.driver", "_chain_packed_masked"))

    def __init__(self):
        self.best: dict = {}
        self.windowed: dict = {}    # path label: K7's largest input there
        self.refine: dict = {}      # path label: K5's largest input there
        self.glob: dict = {}        # path label: K4's largest input there
        self.glob_calls: dict = {}  # path label: (B, S, K) of each K4 call
        self.blocked: dict = {}     # path label: K2's largest input there
        self.blocked_calls: dict = {}   # path label: (B, N, need_full)
        self.og_calls: dict = {}    # path label: (B, K, D, real problems,
        #                             their longest shorter side)
        self.og_inputs: dict = {}   # path label: K6's inputs of each call
        self.p1_calls: dict = {}    # path label: (B, S, K) of each P1 call
        self.p1_inputs: dict = {}   # path label: P1's inputs of each call
        self.k3_calls: dict = {}    # path label: (B, N) of each K3 call
        self.k3_inputs: dict = {}   # path label: K3's inputs of each call
        self.masked = False     # inside the driver's masked round
        self.path = None
        self.saved = []

    def __enter__(self):
        import importlib

        self.saved = []
        for mod_name, fn_name in self.SITES:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)
            self.saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, self._wrap(fn_name, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            setattr(mod, fn_name, orig)
        return False

    @staticmethod
    def work(name, args, kw) -> int:
        if name == "one_gap_traced":        # B x (D + K) x K
            return args[0].numel() * args[7]
        if name == "chain_scores_windowed":     # B x N x W
            return args[0].numel() * kw["W"]
        if name in ("chain_scores_blocked", "chain_mask_from_scores"):
            return args[0].numel()
        return args[0].numel() * args[4]    # banded: B x S x K

    def _wrap(self, name, orig):
        if name == "_chain_packed_masked":
            def masked(*args, **kw):
                self.masked = True
                try:
                    return orig(*args, **kw)
                finally:
                    self.masked = False
            return masked

        def rec(*args, **kw):
            work = self.work(name, args, kw)
            keep = [(self.best, name)]
            if name == "chain_scores_windowed":
                keep.append((self.windowed, self.path))
            if name == "banded_refine_traced_packed":
                keep.append((self.refine, self.path))
            if name == "banded_global_traced_packed":
                keep.append((self.glob, self.path))
                self.glob_calls.setdefault(self.path, []).append(
                    (args[0].shape[0], args[0].shape[1], args[4]))
            if name == "chain_scores_blocked":
                keep.append((self.blocked, self.path))
                self.blocked_calls.setdefault(self.path, []).append(
                    (args[0].shape[0], args[0].shape[1], not self.masked))
            if name == "banded_pallas_rowsync":
                self.p1_calls.setdefault(self.path, []).append(
                    (args[0].shape[0], args[0].shape[1], args[4]))
                self.p1_inputs.setdefault(self.path, []).append(
                    clone_call(args, kw))
            if name == "chain_mask_from_scores":
                self.k3_calls.setdefault(self.path, []).append(
                    tuple(args[0].shape))
                self.k3_inputs.setdefault(self.path, []).append(
                    clone_call(args, kw))
            if name == "one_gap_traced":
                real = one_gap_real(args)
                self.og_calls.setdefault(self.path, []).append(
                    (args[0].shape[0], args[7], args[8], int(real.sum()),
                     int((args[4].minimum(args[5]) * real).max())))
                self.og_inputs.setdefault(self.path, []).append(
                    [x.clone() if hasattr(x, "clone") else x for x in args])
            for store, k in keep:
                if work > store.get(k, (-1,))[0]:
                    store[k] = (work, [x.clone() if hasattr(x, "clone")
                                       else x for x in args],
                                {kk: v.clone() if hasattr(v, "clone")
                                 else v for kk, v in kw.items()})
            return orig(*args, **kw)
        return rec


class ShapedCapture:
    """Keeps the long shaped-band refine regions (q, t, qlo, qhi) each
    path sends refine_shaped_kernel (warm-up runs only), by path label."""

    def __init__(self):
        self.regions: dict = {}
        self.path = None
        self.orig = None

    def __enter__(self):
        from lra_tpu_torch.ops import refine_shaped

        self.orig = refine_shaped.pack

        def keep(regions, **kw):
            self.regions.setdefault(self.path, []).extend(regions)
            return self.orig(regions, **kw)

        refine_shaped.pack = keep
        return self

    def __exit__(self, *exc):
        from lra_tpu_torch.ops import refine_shaped

        refine_shaped.pack = self.orig
        return False


class JobMix:
    """Tallies the work each device round is given (warm-up runs only):
    chaining problems and their largest fragment count per SDP round,
    jobs and their longest side per alignment round, and the K6 buckets
    by (Kc, Dc).  Keeps the SDP-2 problems for the K3 driver phase."""

    SITES = (("lra_tpu_torch.pipeline.highacc", "solve_problems"),
             ("lra_tpu_torch.pipeline.lowacc", "solve_problems"),
             ("lra_tpu_torch.pipeline.big_gap", "resolve_big_gaps"),
             ("lra_tpu_torch.pipeline.highacc", "solve_gap_jobs"),
             ("lra_tpu_torch.pipeline.gap_align", "solve_gap_jobs"),
             ("lra_tpu_torch.pipeline.gap_align", "one_gap_traced"),
             ("lra_tpu_torch.chain.driver", "_shard_problem"),
             ("lra_tpu_torch.chain.driver", "_solve_batch"))

    def __init__(self):
        self.rounds: list = []
        self.one_gap: dict = {}
        self.sdp2: list = []
        self.shards: list = []      # (fragments, [child fragments])
        self.windowed: list = []    # (fragments, W) of the K7 problems
        self.n_sdp = 0
        self.saved = []

    def __enter__(self):
        import importlib

        self.rounds, self.one_gap, self.sdp2 = [], {}, []
        self.shards, self.windowed = [], []
        self.n_sdp = 0
        self.saved = []
        for mod_name, fn_name in self.SITES:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)
            self.saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, self._wrap(mod_name, fn_name, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            setattr(mod, fn_name, orig)
        return False

    def _wrap(self, mod_name, fn_name, orig):
        if fn_name == "one_gap_traced":
            def og(*args, **kw):
                key = (args[7], args[8])            # (Kc, Dc)
                n, b = self.one_gap.get(key, (0, 0))
                self.one_gap[key] = (n + 1, b + args[0].shape[0])
                return orig(*args, **kw)
            return og
        if fn_name == "_shard_problem":
            def shard(p, *args, **kw):
                out = orig(p, *args, **kw)
                self.shards.append((len(p.qS), [len(c[0].qS) for c in out]))
                return out
            return shard
        if fn_name == "_solve_batch":
            def solve(problems, *args, **kw):
                from lra_tpu_torch.chain import driver

                out = orig(problems, *args, **kw)
                top = driver._BUCKETS[-1]       # past it: the windowed K7
                self.windowed += [(len(p.qS), p.win_W) for p in problems
                                  if len(p.qS) > top]
                return out
            return solve

        def tally(items, *args, **kw):
            if fn_name == "solve_problems":     # per batch SDP-1, SDP-2
                name = ("SDP-1", "SDP-2")[self.n_sdp % 2]
                self.n_sdp += 1
                if name == "SDP-2":
                    self.sdp2.extend(items)
                sizes = [len(p.qS) for p in items]
                what = "problems, max fragments"
            elif fn_name == "resolve_big_gaps":
                name = "SDP-3"
                sizes = [len(t.problem.qS) for t in items]
                what = "problems, max fragments"
            elif hasattr(items, "close"):       # the batch's GapTable
                name = "gap-align"
                items.close()
                sizes = np.maximum(items.ql, items.tl).tolist()
                what = "jobs, longest side (bp)"
            else:
                name = ("refine boxes" if mod_name.endswith("gap_align")
                        else "indel-refine" if any(j.refine for j in items)
                        else "gap-align")
                sizes = [max(len(j.q), len(j.t)) for j in items]
                what = "jobs, longest side (bp)"
            self.rounds.append((name, len(items), max(sizes, default=0),
                                what))
            return orig(items, *args, **kw)
        return tally

    def lines(self) -> list:
        out = [f"{n}: {c} {w.split(',')[0]}, {w.split(', ')[1]} {m}"
               for n, c, m, w in self.rounds]
        og = ", ".join(f"(Kc={k}, Dc={d}): {n} launches, {b} problems"
                       for (k, d), (n, b) in sorted(self.one_gap.items()))
        out.append(f"K6 buckets {og or 'none'}")
        for n, kids in self.shards:
            out.append(f"shards: a problem of {n} fragments in {len(kids)} "
                       f"rounds, children of {kids} fragments")
        if self.windowed:
            out.append("windowed (K7) problems (fragments, W): "
                       + ", ".join(f"({n}, {w})" for n, w in self.windowed))
        return out


# The paths: label, workload, use_pallas, and the kernels each run must
# launch.  CCS in its two configurations: use_pallas=True (the narrow
# band tier on the row-sync kernel) and the default (that tier on
# banded_global_traced_packed); then ONT and CLR (the lowacc pipeline);
# then CONTIG (highacc) at bench.py's shape, which chains a handful of
# fragments per problem, and two draft contigs whose SDP-2 problem
# reaches K7, the second one through the q-range shards.
PATHS = (
    ("ccs use_pallas=True", "ccs", True,
     ("chain_scores_blocked", "banded_refine_traced_packed",
      "banded_pallas_rowsync", "one_gap_traced")),
    ("ccs", "ccs", False,
     ("chain_scores_blocked", "banded_refine_traced_packed",
      "banded_global_traced_packed", "one_gap_traced")),
    ("ont", "ont", False, ("chain_scores_blocked", "one_gap_traced")),
    ("clr", "clr", False, ("chain_scores_blocked", "one_gap_traced")),
    ("contig bench", "contig_bench", False, ("chain_scores_blocked",)),
    ("contig 2.5 Mb", "contig_draft", False, ("chain_scores_windowed",)),
    ("contig 7 Mb", "contig_shard", False, ("chain_scores_windowed",)),
)
# bench.py's shapes and error split (snp 60 %, ins 20 %, del 20 % of the
# error rate): reads, read length, error, numpy seed, batch size
SHAPES = {"ccs": (256, 8000, None, 0, 256),
          "ont": (384, 12000, 0.05, 1, 384),
          "clr": (256, 10000, 0.12, 2, 128)}
# bench.py's CONTIG shape (bench.py:254-255): contigs, span, DEL, INS,
# numpy seed
CONTIG_BENCH = (8, 500_000, 5000, 2000, 3)
# draft contigs (tests/test_golden.py's recipe, lra_tpu_torch.sim.
# draft_contig): contig length
DRAFTS = {"contig_draft": 2_500_000, "contig_shard": 7_000_000}


def make_genome(genome_len=2_000_000):
    """The shared 2 Mb random genome, then bench.py's CCS reads, both
    from numpy seed 0 (the CCS workload of PR 1, unchanged)."""
    from lra_tpu_torch.io.genome import Genome
    from lra_tpu_torch.sim import random_genome

    rng = np.random.default_rng(0)
    return Genome.from_seqs([("chr1", random_genome(rng, genome_len))]), rng


def sim_contigs(rng, genome, n, span, dele, ins):
    """bench.py's assembly-contig workload (bench.py:115-133): `span`-long
    genome slices, each with one DEL of `dele` bases and one INS of `ins`
    random bases."""
    contigs = []
    starts = genome.starts()
    for i in range(n):
        ci = int(rng.integers(0, genome.nseq))
        lo, hi = int(starts[ci]), int(genome.ends[ci])
        s = lo + int(rng.integers(0, hi - lo - span - dele - 1))
        seq = genome.codes[s:s + span + dele].copy()
        dpos = span // 3 + int(rng.integers(0, span // 4))
        seq = np.concatenate([seq[:dpos], seq[dpos + dele:]])
        ipos = 2 * span // 3 + int(rng.integers(0, span // 5))
        insert = rng.integers(0, 4, ins).astype(np.uint8)
        seq = np.concatenate([seq[:ipos], insert, seq[ipos:]])
        contigs.append((f"ctg{i}", seq))
    return contigs


def make_workload(kind, genome, ccs_rng):
    """(genome, batches, index, opts, genome local index) of one
    workload."""
    from lra_tpu_torch import preset
    from lra_tpu_torch.index.global_index import build_global_index
    from lra_tpu_torch.index.local_index import build_genome_local_index
    from lra_tpu_torch.io.genome import Genome
    from lra_tpu_torch.sim import draft_contig, random_genome, sample_read

    if kind in DRAFTS:
        # the draft contig on its own genome of size + 3 Mb, numpy seed 5
        size = DRAFTS[kind]
        rng = np.random.default_rng(5)
        codes = random_genome(rng, size + 3_000_000)
        ctg = draft_contig(rng, codes, 1_000_000, size)
        genome = Genome.from_seqs([("chr1", codes)])
        opts = preset("contig")
        return (genome, [[("ctg0", ctg)]], build_global_index(genome, opts),
                opts, None)
    if kind == "contig_bench":
        n, span, dele, ins, seed = CONTIG_BENCH
        opts = preset("contig")
        reads = sim_contigs(np.random.default_rng(seed), genome, n, span,
                            dele, ins)
        batches = [reads]
    else:
        n, length, err, seed, batch = SHAPES[kind]
        opts = preset(kind)
        if kind == "ccs":
            rng = ccs_rng
            snp, ind = 0.003, 0.001
        else:
            rng = np.random.default_rng(seed)
            snp, ind = err * 0.6, err * 0.2
        reads = []
        for i in range(n):
            r = sample_read(rng, genome.codes, length, snp=snp, ins=ind,
                            dele=ind)
            reads.append((f"r{i}", r.codes))
        batches = [reads[i:i + batch] for i in range(0, n, batch)]
    idx = build_global_index(genome, opts)
    gli = None
    if kind != "ccs":
        gli = build_genome_local_index(
            genome, k=min(opts.local_k, 10), w=opts.local_w,
            window=opts.local_index_window, max_freq=opts.local_max_freq)
    return genome, batches, idx, opts, gli


def align_all(batches, genome, idx, opts, gli, device, timing=None):
    from lra_tpu_torch.pipeline import align_reads

    states, lines = [], []
    for bt in batches:
        s, ln = align_reads(bt, genome, idx, opts, device=device,
                            genome_li=gli, timing=timing)
        states += s
        lines += ln
    return states, lines


def check_contig(label, kind, mix, counts) -> None:
    """CONTIG (b) and (c): a chaining problem past 8192 fragments ran on
    K7; (c): past SHARD_N, in shard rounds whose children reached K7."""
    from lra_tpu_torch.chain import driver

    if kind not in DRAFTS:
        return
    if not mix.windowed:
        raise AssertionError(f"[{label}] no chaining problem exceeded 8192 "
                             "fragments")
    if kind == "contig_shard":
        big = [(n, kids) for n, kids in mix.shards if n > driver.SHARD_N]
        if not big or len(big[0][1]) < 2:
            raise AssertionError(f"[{label}] no problem past SHARD_N = "
                                 f"{driver.SHARD_N} was sharded")
        kids = [k for _, ks in big for k in ks]
        if not all(k > driver._BUCKETS[-1] for k in kids) or \
                counts["chain_scores_windowed"] < len(kids):
            raise AssertionError(f"[{label}] shard children {kids} did not "
                                 "all reach K7")


def e2e_phase(work, rec, mixes, shaped) -> tuple:
    """Drive each path on one device (no mesh): a recorded warm-up (the
    shaped-band refine regions kept by ``shaped``), then a timed run with
    the launch counts reset just before and read just after.  Returns ({path: SAM lines}, {kernel: launches on the first
    path that launched it}, {path: launches}, {path: wall s})."""
    import torch

    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.parallel.mesh import active_mesh
    from lra_tpu_torch.utils.timing import CudaEventTiming

    if active_mesh() is not None:
        raise AssertionError("e2e phase: a mesh is active")
    all_lines, launches, path_counts, walls = {}, {}, {}, {}
    for label, kind, use_pallas, needed in PATHS:
        genome, batches, idx, opts, gli = work[kind]
        opts.use_pallas = use_pallas
        n = sum(len(b) for b in batches)
        bases = sum(len(c) for b in batches for _, c in b)
        mix = JobMix()
        rec.path = shaped.path = label
        t0 = time.perf_counter()
        with rec, mix, shaped:
            align_all(batches, genome, idx, opts, gli, DEV)
        torch.cuda.synchronize()
        log(f"e2e [{label}] warm-up: {time.perf_counter() - t0:.2f} s")
        mixes[label] = mix

        stages: dict = {}
        _ext.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, lines = [], []
        for bt in batches:
            timing = CudaEventTiming()
            s, ln = align_all([bt], genome, idx, opts, gli, DEV, timing)
            states += s
            lines += ln
            for k, v in timing.stage_ms().items():
                stages[k] = stages.get(k, 0.0) + v
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(_ext.LAUNCHES)
        for ln in mix.lines():
            log(f"  job mix {ln}")
        mapped = sum(1 for s in states if not s.unaligned)
        log(f"e2e [{label}]: {n / dt:.2f} reads/s, {bases / dt:.0f} bases/s "
            f"({dt:.3f} s for {n} reads of {bases} bases in {len(batches)} "
            f"batch(es)), mapped {mapped}/{n}, {len(lines)} SAM lines")
        for stage, ms in stages.items():
            log(f"  stage {stage:28s} {ms:10.2f} ms")
        log(f"  launches {json.dumps(counts)}")
        for k in needed:
            if counts[k] == 0:
                raise AssertionError(f"[{label}] kernel {k} was not "
                                     "launched on the main path")
        check_contig(label, kind, mix, counts)
        path_counts[label], walls[label] = counts, dt
        for k, c in counts.items():
            if c:
                launches.setdefault(k, c)
        if mapped < 0.9 * n:
            raise AssertionError(f"[{label}] only {mapped} of {n} reads "
                                 "mapped")
        for ln in lines:
            if len(ln.split("\t")) < 11:
                raise AssertionError(f"malformed SAM line: {ln[:120]}")
        all_lines[label] = lines
    return all_lines, launches, path_counts, walls


def shaped_check(tag, regions, opts) -> None:
    """refine_shaped_kernel against its twin (the host C DP over the same
    windows) on `regions`, all in one launch, exact; then the longest
    alone, timed (CUDA events, 3 runs, the fastest): us a row."""
    import torch

    from lra_tpu_torch.ops import refine_shaped as rs

    sc = (opts.local_match, opts.local_mismatch, opts.local_indel)
    p = rs.pack(regions)
    counts, out = rs.solve(p, *sc, DEV)
    got = rs.fetch_blocks(p, counts.cpu().numpy(), out)
    tc, tw = rs.solve(p, *sc, "cpu")
    want = rs.fetch_blocks(p, tc.numpy(), tw)
    bad = sum(not np.array_equal(a, b) for a, b in zip(got, want))
    log(f"  shaped {tag}: {p.R} regions, {p.rows} rows, {p.cells} cells, "
        f"widest rows {int(p.view('maxw').min())}-"
        f"{int(p.view('maxw').max())}, blocks "
        f"{int(counts.sum())}, {bad} not equal to the twin")
    if bad:
        raise AssertionError(f"shaped {tag}: {bad} regions differ from the "
                             "twin")
    one = rs.pack([max(regions, key=lambda r: len(r[1]))])
    best = 1e30
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        rs.solve(one, *sc, DEV)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    rows = one.rows - 1
    log(f"  shaped {tag}: longest region {rows} rows, {one.cells} cells, "
        f"widest row {int(one.view('maxw')[0])}: {best:.3f} ms, "
        f"{1e3 * best / rows:.4f} us a row")


def shaped_paths_phase(work, shaped) -> None:
    """The shaped-band refine kernel on each path's regions (forward
    draft contigs send none: their path stays on the diagonal band of the
    device tiers), then on a reverse-strand contig: CONTIG (b)'s draft
    contig reverse-complemented, aligned on the card with its regions
    kept, each exact against the twin, its SAM lines equal to a run on
    the CPU."""
    import hashlib

    from lra_tpu_torch import seq as sequtils

    kinds = {label: kind for label, kind, _, _ in PATHS}
    for label, regions in shaped.regions.items():
        if regions:
            shaped_check(f"[{label}]", regions, work[kinds[label]][3])
    genome, batches, idx, opts, gli = work["contig_draft"]
    name, ctg = batches[0][0]
    rev = [[(name + "_rev", sequtils.revcomp(ctg))]]
    cap = ShapedCapture()
    cap.path = "rev"
    t0 = time.perf_counter()
    with cap:
        _, lines = align_all(rev, genome, idx, opts, gli, DEV)
    dt = time.perf_counter() - t0
    regions = cap.regions.get("rev", [])
    if not regions:
        raise AssertionError("reverse-strand contig: no shaped region")
    log(f"  shaped [contig 2.5 Mb reverse]: aligned on the card in "
        f"{dt:.2f} s (warm)")
    shaped_check("[contig 2.5 Mb reverse]", regions, opts)
    _, cpu_lines = align_all(rev, genome, idx, opts, gli, "cpu")
    if cpu_lines != lines:
        raise AssertionError("reverse-strand contig: SAM lines on the card "
                             "!= on the CPU")
    log(f"  shaped [contig 2.5 Mb reverse]: SAM lines = the CPU run's "
        f"(sha256 {hashlib.sha256(chr(10).join(lines).encode()).hexdigest()})")


def chain_mask_phase(problems, opts, rec, launches) -> None:
    """K3 on a driver path: copies of the CCS SDP-2 problems with
    need_full=False through solve_problems on the card (the chain
    bitmask round); best_chain and chain_vmax must equal the
    need_full=True results the CCS run computed."""
    import torch

    from lra_tpu_torch.chain.driver import (ChainProblem, best_chain,
                                            chain_vmax, solve_problems)
    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops.gapcost import from_options

    full = [p for p in problems if p.V is not None and len(p.qS) > 1]
    if not full:
        raise AssertionError("no SDP-2 problem recorded for K3")
    masked = [ChainProblem(p.qS, p.qE, p.tS, p.tE, p.score, p.lane1,
                           p.lane2, p.order, p.tbase, need_full=False)
              for p in full]
    gp = from_options(opts)
    _ext.reset_launches()
    rec.path = "ccs SDP-2 need_full=False (K3 driver path)"
    with rec:
        solve_problems(masked, gp, True, DEV)
    torch.cuda.synchronize()
    n = _ext.LAUNCHES["chain_mask_from_scores"]
    if n == 0:
        raise AssertionError("chain_mask_from_scores was not launched on "
                             "the need_full=False driver path")
    launches["chain_mask_from_scores"] = n
    if not any(not f for _, _, f in rec.blocked_calls.get(rec.path, [])):
        raise AssertionError("no K2 launch of the need_full=False round "
                             "recorded on the K3 driver path")
    for a, b in zip(full, masked):
        if best_chain(a) != best_chain(b) or chain_vmax(a) != chain_vmax(b):
            raise AssertionError("need_full=False chain != need_full=True "
                                 "chain")
    log(f"K3 driver path: {len(masked)} SDP-2 problems with "
        f"need_full=False, {n} launches; best_chain and chain_vmax equal "
        f"to the need_full=True results")


def main_path_kernels(rec, launches) -> list:
    """Each kernel against its plain twin on the largest input the main
    path gave it; times and bounds for the JSON line."""
    import torch

    from lra_tpu_torch.ops import affine_kernel as ak
    from lra_tpu_torch.ops import affine_pallas as ap
    from lra_tpu_torch.ops import one_gap as og
    from lra_tpu_torch.ops import sdp_blocked as sb
    from lra_tpu_torch.ops import sdp_windowed as sw

    plain = {"banded_global_traced_packed":
             ak.banded_global_traced_packed_plain,
             "banded_refine_traced_packed":
             ak.banded_refine_traced_packed_plain,
             "banded_pallas_rowsync": ap.banded_pallas_rowsync_plain}
    wrap = {"banded_global_traced_packed": ak.banded_global_traced_packed,
            "banded_refine_traced_packed": ak.banded_refine_traced_packed,
            "banded_pallas_rowsync": ap.banded_pallas_rowsync}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        if name in MESH_KERNELS:
            continue
        if name not in rec.best:
            raise AssertionError(f"no main-path call of {name} recorded")
        _, args, kw = rec.best[name]
        preps = 2
        if name == "chain_scores_blocked":
            fn = lambda: sb.chain_scores_blocked(*args, **kw)
            pfn = lambda: sb.chain_scores_blocked_plain(*args, **kw)
            got, ref = fn(), pfn()
            torch.cuda.synchronize()
            err = max(exact(f"{name} (main-path input)", x, y)
                      for x, y in zip(got, ref))
            bnd, by = sdp_bound(args)
            shape = f"B={args[0].shape[0]} N={args[0].shape[1]}"
        elif name == "chain_mask_from_scores":
            fn = lambda: sb.chain_mask_from_scores(*args)
            pfn = lambda: sb.chain_mask_from_scores_plain(*args)
            got, ref = fn(), pfn()
            torch.cuda.synchronize()
            err = max(exact(f"{name} (main-path input)", x, y)
                      for x, y in zip(got, ref))
            bnd, by = mask_bound(args[0], got[1])
            shape = f"B={args[0].shape[0]} N={args[0].shape[1]}"
        elif name == "chain_scores_windowed":
            fn = lambda: sw.chain_scores_windowed(*args, **kw)
            pfn = lambda: sw.chain_scores_windowed_plain(*args, **kw)
            got, ref = fn(), pfn()
            torch.cuda.synchronize()
            err = max(exact(f"{name} (main-path input)", x, y)
                      for x, y in zip(got, ref))
            bnd, by = windowed_bound(args, kw["W"])
            shape = (f"B={args[0].shape[0]} N={args[0].shape[1]} "
                     f"W={kw['W']}")
            preps = 1
        elif name == "one_gap_traced":
            K, D, L = args[7], args[8], args[12]
            fn = lambda: og.one_gap_traced(*args)
            pfn = lambda: og.one_gap_traced_plain(*args)
            got, ref = fn(), pfn()
            torch.cuda.synchronize()
            err = max(exact(f"{name} (main-path input)", x, y)
                      for x, y in zip(got, ref))
            bnd, by = one_gap_bound(args[:7], K, D, L, got[0])
            shape = f"B={args[0].shape[0]} K={K} D={D}"
            preps = 1
        else:
            q, t, qlen, tlen, K = args[:5]
            kband = kw["kband"]
            fn = lambda: wrap[name](q, t, qlen, tlen, K, *args[5:8],
                                    kband=kband)
            pfn = lambda: plain[name](q, t, qlen, tlen, K, *args[5:8], kband)
            got, ref = fn(), pfn()
            torch.cuda.synchronize()
            err = exact(f"{name} (main-path input)", got, ref)
            bnd, by = dp_bound(name, K, q, t, tlen, got)
            shape = f"B={q.shape[0]} S={q.shape[1]} K={K}"
        ms = cuda_ms(fn, 10)
        pms = cuda_ms(pfn, preps)
        log(f"main-path {name} [{shape}]: exact (max |err| {err}); "
            f"{ms:.4f} ms, plain "
            f"{pms:.2f} ms, bound {bnd:.5f} ms ({by})")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bnd, "bound_by": by, "library_ms": None,
                     "shape": shape})
    return rows


def back_to_back(fn) -> float:
    """The card's time per launch of fn: BACK_TO_BACK calls between two
    events (the host's enqueue hidden behind the launches before it)."""
    return cuda_ms(lambda: [fn() for _ in range(BACK_TO_BACK)], 3) / \
        BACK_TO_BACK


def one_gap_paths_phase(rec) -> None:
    """K6 against its twin on each path's two recorded inputs (k6_picks),
    exact with every plan of og.plan_variants (the first the wrapper's
    choice), each timed per call and back to back, in two rounds of
    turns."""
    import torch

    from lra_tpu_torch.ops import one_gap as og

    if not rec.og_inputs:
        raise AssertionError("no main-path call of one_gap_traced recorded")
    for label, calls in rec.og_inputs.items():
        for pick, args in k6_picks(calls).items():
            K, D, B = args[7], args[8], args[0].shape[0]
            ref, pms = timed(lambda: og.one_gap_traced_plain(*args))
            plans = og.plan_variants(K, D, B)
            res = {name: [] for name, _ in plans}
            for _ in range(2):
                for name, plan in plans:
                    fn = lambda: og._one_gap_traced_cuda(*args, plan=plan)
                    got = fn()
                    torch.cuda.synchronize()
                    for nm, x, y in zip(("ops", "jump", "score"), got, ref):
                        exact(f"one_gap_traced [{label}] {pick} {name} {nm}",
                              x, y)
                    res[name].append((cuda_ms(fn, 10), back_to_back(fn)))
            prow, srow = one_gap_rows(args, K, D)
            real = one_gap_real(args)
            log(f"K6 [{label}] {pick} input B={B} K={K} D={D} "
                f"({int(real.sum())} real problems, at most "
                f"{int((prow + srow).max())} rows a problem): exact with "
                f"every plan; plain twin {pms:.1f} ms")
            for name, plan in plans:
                log(f"  K6 [{label}] {pick} {name} ({og.plan_str(plan)}): "
                    + "; ".join(f"per call {c:.4f} ms, back to back {w:.4f}"
                                for c, w in res[name]))


def rowsync_paths_phase(rec) -> None:
    """P1 against its twin on every launch each path recorded, exact with
    every plan of ap.rowsync_plan_variants and its decoded blocks equal
    to K4's (rowsync_check); each launch timed through the wrapper, per
    call and back to back, in two rounds."""
    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import affine_pallas as ap

    if not rec.p1_inputs:
        raise AssertionError("no main-path call of banded_pallas_rowsync "
                             "recorded")
    for label, calls in rec.p1_inputs.items():
        for i, (args, kw) in enumerate(calls):
            q, t, qlen, tlen, K = args[:5]
            a = [q, t, qlen, tlen, kw["kband"]]
            B, S = q.shape
            pms, names = rowsync_check(f"[{label}] #{i}", a, K,
                                       tuple(args[5:8]))
            fn = lambda: ap.banded_pallas_rowsync(*args, **kw)
            res = [(cuda_ms(fn, 10), back_to_back(fn)) for _ in range(2)]
            plan = ap.rowsync_plan(S, B, _ext.sm_count(0))
            log(f"P1 [{label}] #{i} B={B} S={S} K={K} "
                f"({int((tlen.clamp(max=S) + 1).sum())} DP rows; "
                f"{rowsync_plan_str(plan)}): exact with "
                f"{', '.join(names)}, blocks == K4's; plain twin "
                f"{pms:.1f} ms; " + "; ".join(
                    f"per call {c:.4f} ms, back to back {w:.4f}"
                    for c, w in res))


def blocked_paths_phase(rec) -> None:
    """K2 against its twin on the largest input each path gave it, exact
    with every launch plan (sb.plan_variants); timed through the wrapper
    (the main path's call, host launch work included), back to back
    (BACK_TO_BACK launches between two events: the card's time per
    launch), in two rounds of turns."""
    import torch

    from lra_tpu_torch.ops import sdp_blocked as sb

    if not rec.blocked:
        raise AssertionError("no main-path call of chain_scores_blocked "
                             "recorded")
    for label, (_, args, kw) in rec.blocked.items():
        ref, pms = timed(lambda: sb.chain_scores_blocked_plain(*args, **kw))
        B, N = args[0].shape
        for plan in sb.plan_variants(N):
            got = sb._chain_scores_blocked_cuda(*args, 64, plan=plan)
            torch.cuda.synchronize()
            for nm, x, y in zip(("V", "bp", "lane"), got, ref):
                exact(f"chain_scores_blocked [{label}] {sb.plan_str(plan)} "
                      f"{nm}", x, y)
        fn = lambda: sb.chain_scores_blocked(*args, **kw)
        res = [(cuda_ms(fn, 10), back_to_back(fn)) for _ in range(2)]
        bnd, by = sdp_bound(args)
        log(f"K2 [{label}] main-path input B={B} N={N} "
            f"({int(args[7].sum())} valid rows; "
            f"{sb.plan_str(sb.sdp_plan(N))}): exact with every plan; "
            f"plain twin {pms:.1f} ms; bound {bnd:.5f} ms ({by}); "
            + "; ".join(f"per call {c:.4f} ms, back to back {w:.4f}"
                        for c, w in res))


def windowed_paths_phase(rec) -> None:
    """K7 against its twin on the largest input each CONTIG path gave it
    (exact), timed with the cluster at 8 CTAs (portable) and at 16
    (non-portable), each beside cudaOccupancyMaxActiveClusters; the
    wrapper's CLUSTER is restored afterwards."""
    import torch

    from lra_tpu_torch.ops import sdp_windowed as sw

    if not rec.windowed:
        raise AssertionError("no main-path call of chain_scores_windowed "
                             "recorded")
    keep = sw.CLUSTER
    try:
        for label, (_, args, kw) in rec.windowed.items():
            ref = sw.chain_scores_windowed_plain(*args, **kw)
            shape = (f"B={args[0].shape[0]} N={args[0].shape[1]} "
                     f"W={kw['W']}")
            res = []
            for C in (8, 16, 8, 16):
                sw.CLUSTER = C
                info = sw.cluster_info(kw["W"], C)
                got = sw.chain_scores_windowed(*args, **kw)
                torch.cuda.synchronize()
                for nm, x, y in zip(("V", "bp", "lane"), got, ref):
                    exact(f"chain_scores_windowed [{label}] C={C} {nm}", x, y)
                ms = cuda_ms(lambda: sw.chain_scores_windowed(*args, **kw), 5)
                res.append(f"C={C} {ms:.4f} ms ({info['max_active_clusters']}"
                           f" clusters fit, {info['dyn_smem']} B dynamic "
                           "shared memory)")
            log(f"K7 [{label}] main-path input {shape}: exact at C=8 and "
                f"C=16; " + "; ".join(res))
    finally:
        sw.CLUSTER = keep


def plan_variants(plan_fn, K) -> list:
    """K4's or K5's two launch plans (ops/affine_kernel.global_plan,
    refine_plan) for a band of 2K+1 cells, by name: that of a bucket too
    small to fill the card (one problem per block, traceback chunks of up
    to 32 KB) and that of a full one (8 / WP problems per block, shorter
    chunks; 1 << 20 problems fill any card)."""
    return [("small-bucket plan", plan_fn(K, 1)),
            ("full-bucket plan", plan_fn(K, 1 << 20))]


def plan_str(plan) -> str:
    return "CPT {CPT} WP {WP} PPC {PPC} P {P} R {R} smem {smem}".format(
        **plan)


def planned_paths_phase(tag, store, plain, run, plan_fn) -> None:
    """K4 or K5 (tag) against its twin on the largest input each path
    gave it (store: the recorder's), exact and timed whole and with the
    traceback skipped (the forward rows alone; run(..., walk=False), a
    launch the main path never makes), with each plan of plan_variants
    (one of them the wrapper's choice for that bucket), in two rounds of
    turns."""
    import torch

    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import affine_kernel as ak

    if not store:
        raise AssertionError(f"no main-path call of {tag} recorded")
    for label, (_, args, kw) in store.items():
        q, t, qlen, tlen, K = args[:5]
        kband = kw["kband"]
        B = q.shape[0]
        ref, pms = timed(lambda: plain(q, t, qlen, tlen, K, *args[5:8],
                                       kband))
        chosen = plan_fn(K, B, _ext.sm_count(0))
        plans = plan_variants(plan_fn, K)
        res = {name: [] for name, _ in plans}
        for _ in range(2):
            for name, plan in plans:
                fn = lambda: run(q, t, qlen, tlen, kband, K, *args[5:8],
                                 plan=plan)
                fwd = lambda: run(q, t, qlen, tlen, kband, K, *args[5:8],
                                  walk=False, plan=plan)
                got = fn()
                torch.cuda.synchronize()
                exact(f"{tag} [{label}] {name} (main-path input)", got, ref)
                res[name].append((cuda_ms(fn, 10), cuda_ms(fwd, 10)))
        rows = int((tlen.clamp(max=t.shape[1]) + 1).sum())
        log(f"{tag} [{label}] main-path input B={B} S={q.shape[1]} K={K} "
            f"({rows} DP rows, {int((qlen > 0).sum())} problems with "
            f"qlen > 0): exact with every plan; plain twin {pms:.1f} ms")
        for name, plan in plans:
            mark = ", the wrapper's choice" if plan == chosen else ""
            log(f"  {tag} [{label}] {name} ({plan_str(plan)}{mark}): "
                + ", ".join(f"{ms:.4f} ms (forward rows alone {f:.4f}, "
                            f"walk {ms - f:.4f})" for ms, f in res[name]))


def launch_shapes(tag, calls_by_path, what) -> None:
    """Every launch's shape (what) of a kernel in each path's recorded
    run: K4's (B, S, K), K2's (B, N, need_full)."""
    for label, calls in calls_by_path.items():
        tally: dict = {}
        for c in calls:
            tally[c] = tally.get(c, 0) + 1
        log(f"{tag} [{label}] {len(calls)} launches {what}: "
            + ", ".join(f"{c}" + (f" x{n}" if n > 1 else "")
                        for c, n in sorted(tally.items(),
                                           key=lambda x: x[0][::-1])))


def save_inputs(tag, store, path) -> None:
    """Each path's largest input of a kernel (store: the recorder's), for
    tools/kernel_compare.py."""
    import torch

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({label: ([a.cpu() if hasattr(a, "cpu") else a for a in args],
                        {k: v.cpu() if hasattr(v, "cpu") else v
                         for k, v in kw.items()})
                for label, (_, args, kw) in store.items()}, path)
    log(f"{tag} path inputs saved to {path}")


def cpu_parity(work, all_lines) -> None:
    """The first reads (16 CCS, 4 ONT and CLR) on device="cpu" (plain
    twins) and on "cuda": SAM lines byte-equal to each other and to the
    full CUDA run's."""
    for label, kind, use_pallas, _ in PATHS:
        if kind not in SHAPES:
            continue
        genome, batches, idx, opts, gli = work[kind]
        opts.use_pallas = use_pallas
        sub = batches[0][:16 if kind == "ccs" else 4]
        names = {n for n, _ in sub}
        t0 = time.perf_counter()
        _, cpu_lines = align_all([sub], genome, idx, opts, gli, "cpu")
        t1 = time.perf_counter()
        _, gpu_lines = align_all([sub], genome, idx, opts, gli, DEV)
        full = [ln for ln in all_lines[label]
                if ln.split("\t", 1)[0] in names]
        if cpu_lines != gpu_lines:
            raise AssertionError(f"[{label}] SAM lines of {len(sub)} reads: "
                                 "device='cpu' != device='cuda'")
        if kind == "ccs" and cpu_lines != full:
            raise AssertionError(f"[{label}] SAM lines of 16 reads: "
                                 "device='cpu' != the full CUDA run's")
        log(f"cpu parity [{label}]: {len(cpu_lines)} SAM lines of "
            f"{len(sub)} reads byte-equal (cpu run {t1 - t0:.1f} s)")


def contig_parity(work) -> None:
    """A 500 kb draft contig (sim.draft_contig, numpy seed 3, from position
    700,000 of the 2 Mb genome) on device="cpu" and "cuda" with the port's
    buckets cut to (64,) and SHARD_N to 2048 for these two runs only, so
    that SDP-2's ~2,900 fragments are solved in shard rounds on K7 (its
    plain twin on the CPU): SAM lines byte-equal."""
    import torch

    from lra_tpu_torch.chain import driver
    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.sim import draft_contig

    genome, _, idx, opts, gli = work["contig_bench"]
    ctg = [("draft500k", draft_contig(np.random.default_rng(3), genome.codes,
                                      700_000, 500_000))]
    saved = driver._BUCKETS, driver.SHARD_N
    driver._BUCKETS, driver.SHARD_N = (64,), 2048
    try:
        mix = JobMix()
        t0 = time.perf_counter()
        with mix:
            _, cpu_lines = align_all([ctg], genome, idx, opts, gli, "cpu")
        t1 = time.perf_counter()
        _ext.reset_launches()
        _, gpu_lines = align_all([ctg], genome, idx, opts, gli, DEV)
        torch.cuda.synchronize()
        k7 = _ext.LAUNCHES["chain_scores_windowed"]
    finally:
        driver._BUCKETS, driver.SHARD_N = saved
    kids = [k for _, ks in mix.shards for k in ks]
    if len(kids) < 2 or not mix.windowed or not k7:
        raise AssertionError(f"cpu parity [contig]: shards {mix.shards}, "
                             f"windowed problems {mix.windowed}, K7 "
                             f"launches {k7}: K7 and the shards are not "
                             "on the compared path")
    if cpu_lines != gpu_lines:
        raise AssertionError("cpu parity [contig]: SAM lines of the 500 kb "
                             "draft contig: device='cpu' != device='cuda'")
    log(f"cpu parity [contig, buckets (64,), SHARD_N 2048]: "
        f"{len(cpu_lines)} SAM lines byte-equal; shards {mix.shards}, "
        f"windowed problems (fragments, W) {mix.windowed}, K7 launches on "
        f"the cuda run {k7} (cpu run {t1 - t0:.1f} s)")


def check_sha(label, lines, tag="") -> None:
    """Raise, naming the path, unless the SHA-256 of its SAM lines is the
    recorded one (RECORDED_SHA)."""
    h = sam_sha256({label: lines})[label]
    if h != RECORDED_SHA[label]:
        raise AssertionError(f"[{label}]{tag}: SAM SHA-256 {h} != the "
                             f"recorded {RECORDED_SHA[label]}")


def mesh_inputs(rec, work) -> dict:
    """The mesh phase's recorded inputs: ONT's K2 bucket (its eight
    arrays) with ONT's PWL (slope, inter, ceiling1, ceiling2), and K4's
    largest main-path call (args, kw)."""
    from lra_tpu_torch.ops.gapcost import from_options

    gpo = from_options(work["ont"][3])
    return {"ont": rec.blocked["ont"][1][:8], "ont_gp": gpo,
            "ont_pwl": (gpo.slope, gpo.inter, gpo.ceiling1, gpo.ceiling2),
            "k4": rec.best["banded_global_traced_packed"][1:]}


def mesh_calls(m, ins) -> list:
    """Mesh phase (a) on mesh m: (name, sharded call, unsharded call) of
    combined_device_step, sharded_chain_scores and sharded_banded_align
    at dryrun_multichip's shapes (B = 2 x the mesh's entries, N=64,
    Q=T=64, K=30), K8 through run_shards at those shapes and on ONT's K2
    bucket (B=512 N=512), sharded_chain_scores on that bucket, and
    sharded_banded_align on K4's largest main-path bucket (B=65536 S=16
    K=30)."""
    import torch

    from lra_tpu_torch.ops import affine_kernel as ak
    from lra_tpu_torch.ops import sdp
    from lra_tpu_torch.ops import sdp_blocked as sb
    from lra_tpu_torch.ops.gapcost import make_gap_params
    from lra_tpu_torch.parallel import mesh as pm
    from lra_tpu_torch.sim import mesh_step_inputs

    gp = make_gap_params(4.0, 15.0, 1.5, 2000, 3000)
    pwl = (gp.slope, gp.inter, gp.ceiling1, gp.ceiling2)
    chain, gap = mesh_step_inputs(2 * m.size)
    dc = [torch.from_numpy(a).to(DEV) for a in chain]
    dg = [torch.from_numpy(a).to(DEV) for a in gap]
    ont, gpo, pwlo = ins["ont"], ins["ont_gp"], ins["ont_pwl"]
    a4, kw4 = ins["k4"]
    q, t, ql, tl, K, m4, mm4, ind4 = a4[:8]

    def k9(q, t, ql, tl, K, m_, mm_, ind_, kb):
        return ak.banded_global_kernel(q, t, ql, tl, K, m_, mm_, ind_,
                                       kband=kb)
    return [
        ("combined_device_step dryrun",
         lambda: pm.combined_device_step(m, gp, 4, -3, -4, 30)(*chain, *gap),
         lambda: sb.chain_scores_blocked(*dc, gp.static_key()) +
         k9(*dg[:4], 30, 4, -3, -4, dg[4])),
        ("sharded_chain_scores dryrun",
         lambda: pm.sharded_chain_scores(m, *chain, gp),
         lambda: sb.chain_scores_blocked(*dc, gp.static_key())),
        ("sharded_banded_align dryrun",
         lambda: pm.sharded_banded_align(m, *gap[:4], 30, 4, -3, -4,
                                         gap[4]),
         lambda: k9(*dg[:4], 30, 4, -3, -4, dg[4])),
        ("chain_scores (K8) dryrun",
         lambda: pm.run_shards(m, sdp.chain_scores,
                               pm.shard_batch(m, *chain), *pwl),
         lambda: sdp.chain_scores(*dc, *pwl)),
        ("sharded_chain_scores ont K2 bucket",
         lambda: pm.sharded_chain_scores(m, *ont, gpo),
         lambda: sb.chain_scores_blocked(*ont, gpo.static_key())),
        ("chain_scores (K8) ont K2 bucket",
         lambda: pm.run_shards(m, sdp.chain_scores, pm.shard_batch(m, *ont),
                               *pwlo),
         lambda: sdp.chain_scores(*ont, *pwlo)),
        ("sharded_banded_align K4's largest bucket",
         lambda: pm.sharded_banded_align(m, q, t, ql, tl, K, m4, mm4, ind4,
                                         kw4["kband"]),
         lambda: k9(q, t, ql, tl, K, m4, mm4, ind4, kw4["kband"])),
    ]


def mesh_phase(work, rec, all_lines, path_counts, walls) -> tuple:
    """The data-parallel mesh on the card.  (a) mesh_calls on make_mesh()
    (the real devices) and on [cuda:0] * MESH_N, each equal to its
    unsharded call, with the launch counts reset just before the sharded
    calls and read just after (every kernel n times a call on a mesh of
    n; the unsharded calls run outside that window); (b) the MESH_PATHS
    through align_reads, a warm-up under use_mesh([cuda:0] * MESH_N), then
    unsharded, mesh, mesh, unsharded runs in turns: SAM lines equal to the
    e2e run's and their SHA-256 to the recorded one, launches 1 x or
    MESH_N x the e2e run's, walls and stage times side by side; (c) dryrun_multichip's q-range
    contig (16,384 fragments over 4 Mb, SHARD_N 2048, halo 60 kb) under
    that mesh: V, bp and lane equal to the unsharded solve, the chain
    over m/4 fragments and across the shard boundaries.  Returns the
    kernels JSON rows of K8 and K9 (launches from (a)) and their inputs
    ({name: (args, kw)}, for --save-k8 / --save-k9)."""
    import torch

    from lra_tpu_torch.chain import driver
    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import affine_kernel as ak
    from lra_tpu_torch.ops import sdp
    from lra_tpu_torch.ops.gapcost import make_gap_params
    from lra_tpu_torch.parallel import mesh as pm
    from lra_tpu_torch.utils.timing import CudaEventTiming

    ins = mesh_inputs(rec, work)
    one_card = pm.make_mesh(devices=[f"{DEV}:0"] * MESH_N)
    meshes = [("make_mesh()", pm.make_mesh()),
              (f"[cuda:0] x {MESH_N}", one_card)]
    calls = [(mname, m, c) for mname, m in meshes
             for c in mesh_calls(m, ins)]
    wants = [unsharded() for _, _, (_, _, unsharded) in calls]
    torch.cuda.synchronize()
    _ext.reset_launches()
    gots = [sharded() for _, _, (_, sharded, _) in calls]
    torch.cuda.synchronize()
    counts = dict(_ext.LAUNCHES)
    for (mname, m, (name, _, _)), got, want in zip(calls, gots, wants):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (x, y) in enumerate(zip(got, want)):
            exact(f"mesh {mname} {name} output {i}", x, y)
    per_call = {k: 0 for k in counts}
    for k in ("chain_scores_blocked", "banded_global_kernel"):
        per_call[k] = 3
    per_call["chain_scores"] = 2
    expect_launches("mesh (a)", counts, per_call,
                    sum(m.size for _, m in meshes))
    log(f"mesh (a) on {', '.join(n for n, _ in meshes)}: "
        f"{len(calls)} sharded calls == their unsharded calls; launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")

    # (b) the paths under the one-card mesh, in turns with unsharded runs
    # of the same phase: unsharded, mesh, mesh, unsharded
    for label in MESH_PATHS:
        _, kind, use_pallas, _ = next(p for p in PATHS if p[0] == label)
        genome, batches, idx, opts, gli = work[kind]
        opts.use_pallas = use_pallas
        with pm.use_mesh(one_card):
            align_all(batches, genome, idx, opts, gli, DEV)
        torch.cuda.synchronize()
        runs: dict = {"unsharded": [], "mesh": []}
        for mesh in (None, one_card, one_card, None):
            stages: dict = {}
            lines = []
            _ext.reset_launches()
            t0 = time.perf_counter()
            with pm.use_mesh(mesh) if mesh else contextlib.nullcontext():
                for bt in batches:
                    timing = CudaEventTiming()
                    lines += align_all([bt], genome, idx, opts, gli, DEV,
                                       timing)[1]
                    for k, v in timing.stage_ms().items():
                        stages[k] = stages.get(k, 0.0) + v
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = dict(_ext.LAUNCHES)
            tag = " under the mesh" if mesh else " (mesh phase, unsharded)"
            if lines != all_lines[label]:
                raise AssertionError(f"[{label}]{tag}: SAM lines != the "
                                     "e2e run's")
            check_sha(label, lines, tag)
            expect_launches(f"[{label}]{tag}", got, path_counts[label],
                            MESH_N if mesh else 1)
            runs["mesh" if mesh else "unsharded"].append((dt, stages))
        wm, wu = ([dt for dt, _ in runs[k]] for k in ("mesh", "unsharded"))
        log(f"mesh (b) [{label}] on [cuda:0] x {MESH_N}: walls "
            f"{', '.join(f'{w:.3f}' for w in wm)} s, unsharded "
            f"{', '.join(f'{w:.3f}' for w in wu)} s in turns (e2e run "
            f"{walls[label]:.3f} s); mean x"
            f"{statistics.mean(wm) / statistics.mean(wu):.2f}; SAM lines = "
            f"the e2e run's, SHA-256 = the recorded one; launches {MESH_N} "
            f"x {sum(path_counts[label].values())}")
        for st in runs["mesh"][0][1]:
            m_ = statistics.mean(s_.get(st, 0.0) for _, s_ in runs["mesh"])
            u_ = statistics.mean(s_.get(st, 0.0)
                                 for _, s_ in runs["unsharded"])
            log(f"  stage {st:28s} mesh {m_:10.2f} ms, unsharded "
                f"{u_:10.2f} ms")

    # (c) dryrun_multichip's q-range contig
    rng = np.random.default_rng(3)
    m, span = 16384, 4_000_000
    dq = np.sort(rng.integers(0, span, m)).astype(np.int64)
    ln = rng.integers(20, 60, m)
    tS = dq + 9000 + rng.integers(-40, 40, m)
    gp = make_gap_params(4.0, 15.0, 1.5, 2000, 3000)
    solved = []
    saved = driver.SHARD_N, driver.SHARD_HALO
    driver.SHARD_N, driver.SHARD_HALO = 2048, 60000
    try:
        for mesh in (None, one_card):
            prob = driver.ChainProblem(dq, dq + ln, tS, tS + ln,
                                       ln.astype(np.float32),
                                       np.ones(m, bool), np.ones(m, bool),
                                       np.arange(m, dtype=np.int64), 0)
            _ext.reset_launches()
            t0 = time.perf_counter()
            if mesh is None:
                driver.solve_problems([prob], gp, True, DEV)
            else:
                with pm.use_mesh(mesh):
                    driver.solve_problems([prob], gp, True, DEV)
            torch.cuda.synchronize()
            solved.append((prob, dict(_ext.LAUNCHES),
                           time.perf_counter() - t0))
    finally:
        driver.SHARD_N, driver.SHARD_HALO = saved
    (p1, c1, t1), (p4, c4, t4) = solved
    for k in ("V", "bp", "lane"):
        if not np.array_equal(getattr(p1, k), getattr(p4, k)):
            raise AssertionError(f"mesh (c): {k} under the mesh != the "
                                 "unsharded solve's")
    expect_launches("mesh (c)", c4, c1, MESH_N)
    chain = driver.best_chain(p4)
    if len(chain) <= m // 4 or not (dq[min(chain)] < span // 8 and
                                    dq[max(chain)] > span - span // 8):
        raise AssertionError(f"mesh (c): chain of {len(chain)} fragments "
                             f"over q {dq[min(chain)]}-{dq[max(chain)]}")
    log(f"mesh (c) q-range contig, {m} fragments over {span} bp, SHARD_N "
        f"2048: chain of {len(chain)}/{m} over q {dq[min(chain)]}-"
        f"{dq[max(chain)]}, = unsharded; {t4 * 1e3:.1f} ms on the mesh, "
        f"{t1 * 1e3:.1f} ms unsharded; launches "
        f"{json.dumps({k: v for k, v in c4.items() if v})}")

    # the kernels JSON rows: K8 on ONT's K2 bucket, K9 on K4's largest
    ont, pwlo = ins["ont"], ins["ont_pwl"]
    a4, kw4 = ins["k4"]
    q, t, ql, tl, K = a4[:5]
    kb = kw4["kband"]
    rows = []
    inputs = {"chain_scores": ([*ont, *(torch.from_numpy(x).to(DEV) for x
                                        in pwlo[:2]), *pwlo[2:]], {}),
              "banded_global_kernel": (a4, kw4)}
    for name, fn, pfn, bnd_fn, shape in (
            ("chain_scores", lambda: sdp.chain_scores(*ont, *pwlo),
             lambda: sdp.chain_scores_plain(*ont, *pwlo),
             lambda got: scan_bound(ont),
             f"B={ont[0].shape[0]} N={ont[0].shape[1]}"),
            ("banded_global_kernel",
             lambda: ak.banded_global_kernel(q, t, ql, tl, K, *a4[5:8],
                                             kband=kb),
             lambda: ak.banded_global_kernel_plain(q, t, ql, tl, K,
                                                   *a4[5:8], kb),
             lambda got: dp_bound("banded_global_kernel", K, q, t, tl,
                                  got[1]),
             f"B={q.shape[0]} S={q.shape[1]} K={K}")):
        got, ref = fn(), pfn()
        torch.cuda.synchronize()
        err = max(exact(f"{name} (mesh-phase input)", x, y)
                  for x, y in zip(got, ref))
        bnd, by = bnd_fn(got)
        ms, pms = cuda_ms(fn, 10), cuda_ms(pfn, 2)
        src, replaces = KERNELS[name]
        log(f"mesh-phase {name} [{shape}]: exact (max |err| {err}); "
            f"{ms:.4f} ms, plain {pms:.2f} ms, bound {bnd:.5f} ms ({by}); "
            f"{counts[name]} launches in (a)")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bnd, "bound_by": by, "library_ms": None,
                     "shape": shape})
    return rows, inputs


# -t N: reads a batch in the stream phase (the CLI's --batch default), the
# worker counts, and how long one batch may take before the phase fails
STREAM_BATCH = 64
STREAM_WORKERS = (1, 2, 4)
STREAM_TIMEOUT = 300.0
STREAM_SWITCH = 0.0005      # the GIL probe's switch interval, seconds


def stream_batches(work, kind) -> list:
    """A workload's reads in batches of STREAM_BATCH."""
    reads = [r for b in work[kind][1] for r in b]
    return [reads[i:i + STREAM_BATCH]
            for i in range(0, len(reads), STREAM_BATCH)]


def drain(gen, timeout) -> list:
    """Every item of the generator gen (align_stream's), consumed on a
    daemon thread; raises if one item takes longer than timeout seconds
    (a hang across streams fails the phase instead of the run's limit)
    or if the generator raised."""
    import queue
    import threading

    q: queue.Queue = queue.Queue()

    def run():
        try:
            for item in gen:
                q.put((True, item))
            q.put((True, None))
        except BaseException as e:      # handed to the main thread
            q.put((False, e))

    threading.Thread(target=run, daemon=True).start()
    out = []
    while True:
        try:
            ok, item = q.get(timeout=timeout)
        except queue.Empty:
            raise AssertionError(f"align_stream: no batch finished within "
                                 f"{timeout:.0f} s") from None
        if not ok:
            raise item
        if item is None:
            return out
        out.append(item)


class StreamSpy:
    """Wraps ops/_ext.launch: the calling thread and the CUDA stream of
    every launch (inside the with block)."""

    def __enter__(self):
        import threading

        import torch

        from lra_tpu_torch.ops import _ext

        self.calls: list = []
        self.orig = _ext.launch
        lock = threading.Lock()

        def spy(*args):
            h = torch.cuda.current_stream().cuda_stream
            with lock:
                self.calls.append((threading.current_thread().name, h))
            return self.orig(*args)

        _ext.launch = spy
        return self

    def __exit__(self, *exc):
        from lra_tpu_torch.ops import _ext

        _ext.launch = self.orig
        return False


def stream_phase(work, all_lines) -> dict:
    """align_stream on the card at workers 1, 2 and 4 for CCS (default
    configuration), ONT and CLR at their full sizes in batches of
    STREAM_BATCH reads: SAM lines byte-equal to the e2e run's, launch
    counts per kernel equal to the sequential (workers 1) run's, and at
    workers > 1 every launch on a worker's own non-default stream, at
    least two streams.  Returns {path: {workers: reads/s}}."""
    import torch

    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.pipeline.stream import align_stream
    from lra_tpu_torch.utils.timing import Timing

    from lra_tpu_torch.parallel.mesh import active_mesh

    if active_mesh() is not None:
        raise AssertionError("stream phase: a mesh is active")
    default = torch.cuda.default_stream().cuda_stream
    switch = sys.getswitchinterval()
    rates: dict = {}
    for label, kind in (("ccs", "ccs"), ("ont", "ont"), ("clr", "clr")):
        genome, _, idx, opts, gli = work[kind]
        opts.use_pallas = False
        batches = stream_batches(work, kind)
        n = sum(len(b) for b in batches)
        seq_counts = seq_stages = None
        # the worker counts, then 4 workers again with the interpreter's
        # switch interval cut to STREAM_SWITCH s (a probe of the GIL)
        for run in (*STREAM_WORKERS, "probe"):
            probe = run == "probe"
            workers = 4 if probe else run
            name = (f"4, switch interval {STREAM_SWITCH * 1e3:g} ms"
                    if probe else workers)
            if probe:
                sys.setswitchinterval(STREAM_SWITCH)
            _ext.reset_launches()
            torch.cuda.synchronize()
            tm = Timing()
            try:
                with StreamSpy() as spy:
                    t0 = time.perf_counter()
                    out = drain(align_stream(batches, genome, idx, opts,
                                             genome_li=gli, timing=tm,
                                             workers=workers, device=DEV),
                                STREAM_TIMEOUT)
                    dt = time.perf_counter() - t0
            finally:
                sys.setswitchinterval(switch)
            torch.cuda.synchronize()
            counts = dict(_ext.LAUNCHES)
            lines = [ln for _, ls in out for ln in ls]
            if lines != all_lines[label]:
                raise AssertionError(f"stream [{label}] workers {name}: "
                                     "SAM lines != the e2e run's")
            if seq_counts is None:
                seq_counts = counts
            else:
                # one device, no mesh: 1 x the sequential run's launches
                expect_launches(f"stream [{label}] workers {name}", counts,
                                seq_counts, 1)
            by_thread: dict = {}
            for thread, h in spy.calls:
                by_thread.setdefault(thread, set()).add(h)
            handles = {h for _, h in spy.calls}
            if workers > 1 and (default in handles or len(handles) < 2 or
                                any(len(v) != 1 for v in
                                    by_thread.values())):
                raise AssertionError(
                    f"stream [{label}] workers {name}: launches by thread "
                    f"and stream {by_thread} (default stream {default}): "
                    "not one non-default stream a worker, two at least")
            rates.setdefault(label, {})[name] = n / dt
            stage = sum(tm.totals.values())
            log(f"stream [{label}] workers {name}: {n / dt:.2f} reads/s "
                f"({dt:.3f} s for {n} reads in {len(batches)} batches of "
                f"{STREAM_BATCH}), SAM lines = e2e, launches "
                f"{sum(counts.values())} = sequential, {len(spy.calls)} "
                f"launches on {len(handles)} stream(s) from "
                f"{len(by_thread)} thread(s); stage time summed over the "
                f"batches {stage:.3f} s = {stage / dt:.2f} x wall")
            if seq_stages is None:
                seq_stages = dict(tm.totals)
            else:
                log("  stage time / workers 1: " + ", ".join(
                    f"{k} {v:.3f} s ({v / max(seq_stages.get(k, 0), 1e-9):.2f}"
                    "x)" for k, v in tm.totals.items()))
    return rates


def devstats_phase(work) -> None:
    """One warm batch each of CCS, ONT and CLR with the device-round
    statistics on: pack, compute, copy and post time per round, and pack
    split into the host jobs, the kernels' launch calls and the rest."""
    import io

    from lra_tpu_torch.utils import devstats

    devstats.ENABLED = True
    try:
        for label, kind in (("ccs", "ccs"), ("ont", "ont"), ("clr", "clr")):
            genome, batches, idx, opts, gli = work[kind]
            opts.use_pallas = False
            devstats.reset()
            t0 = time.perf_counter()
            align_all(batches[:1], genome, idx, opts, gli, DEV)
            wall = time.perf_counter() - t0
            buf = io.StringIO()
            agg = devstats.report(buf)
            log(f"devstats [{label}] one batch of {len(batches[0])} reads, "
                f"wall {wall:.3f} s:")
            for ln in buf.getvalue().splitlines():
                log(f"  {ln}")
            for tag, a in agg.items():
                log(f"  {tag}: pack {a['pack_s']:.4f} s = host jobs "
                    f"{a['host_s']:.4f} s + {a['launches']} launch calls "
                    f"{a['launch_s']:.4f} s + packing and copies in "
                    f"{a['pack_s'] - a['host_s'] - a['launch_s']:.4f} s; "
                    f"device time of the launches {a['compute_s']:.4f} s")
                if a["launches"] and not a["compute_s"] > 0:
                    raise AssertionError(f"devstats [{label}] {tag}: no "
                                         "device time read")
    finally:
        devstats.ENABLED = False
        devstats.reset()


def cli_phase(work) -> None:
    """The command line in a temporary directory, on the card: `index`,
    then `align -t 4` (its records = the in-process align_reads lines of
    the same 64 CCS reads), two `align --nproc 2` processes at once
    sharing the card, then `merge` (= the single run but @PG), `-p p`
    and `-p b` (= align_reads' PAF and BED lines), and `qti`."""
    import tempfile

    from lra_tpu_torch import preset
    from lra_tpu_torch import seq as sequtils

    genome, batches, idx, opts, _ = work["ccs"]
    reads = batches[0][:64]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)

    def cli(d, *args, timeout=600) -> str:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "lra_tpu_torch.cli",
                              *args], cwd=d, env=env, capture_output=True,
                             text=True, timeout=timeout)
        if out.returncode != 0:
            raise AssertionError(f"cli {' '.join(args)}: rc "
                                 f"{out.returncode}\n{out.stderr[-2000:]}")
        log(f"cli {' '.join(args)}: {time.perf_counter() - t0:.1f} s; "
            f"{(out.stderr.strip().splitlines() or [''])[-1][:150]}")
        return out.stderr

    def records(path) -> list:
        return [ln.rstrip("\n") for ln in open(path)
                if not ln.startswith("@")]

    def in_process(fmt) -> list:
        o = preset("ccs")
        o.print_format = fmt
        return align_all([reads], genome, idx, o, None, DEV)[1]

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "ref.fa"), "w") as f:
            f.write(">chr1\n" + sequtils.decode(genome.codes) + "\n")
        with open(os.path.join(d, "reads.fa"), "w") as f:
            for name, codes in reads:
                f.write(f">{name}\n{sequtils.decode(codes)}\n")
        cli(d, "index", "ref.fa", "-CCS")
        cli(d, "align", "-CCS", "ref.fa", "reads.fa", "-t", "4", "--batch",
            "16", "-o", "t4.sam")
        want = in_process("s")
        if records(os.path.join(d, "t4.sam")) != want:
            raise AssertionError("cli align -t 4: records != align_reads "
                                 "lines")
        procs = []
        t0 = time.perf_counter()
        try:
            for pid in (0, 1):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "lra_tpu_torch.cli", "align",
                     "-CCS", "ref.fa", "reads.fa", "--batch", "16",
                     "--nproc", "2", "--procid", str(pid), "-o",
                     "multi.sam"], cwd=d, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
            for pid, p in enumerate(procs):
                _, err = p.communicate(timeout=600)
                if p.returncode != 0:
                    raise AssertionError(f"cli align --procid {pid}: rc "
                                         f"{p.returncode}\n{err[-2000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        log(f"cli align --nproc 2 (two processes on the card at once): "
            f"{time.perf_counter() - t0:.1f} s")
        cli(d, "merge", "multi.sam.shard0", "multi.sam.shard1", "-o",
            "merged.sam")

        def no_pg(name) -> list:
            return [ln for ln in open(os.path.join(d, name))
                    if not ln.startswith("@PG")]

        if no_pg("merged.sam") != no_pg("t4.sam"):
            raise AssertionError("cli merge of the --nproc 2 shards != the "
                                 "single run (modulo @PG)")
        for fmt in ("p", "b"):
            cli(d, "align", "-CCS", "ref.fa", "reads.fa", "-p", fmt, "-o",
                f"out.{fmt}")
            if records(os.path.join(d, f"out.{fmt}")) != in_process(fmt):
                raise AssertionError(f"cli align -p {fmt}: lines != "
                                     "align_reads'")
        cli(d, "qti", "-CCS", "ref.fa", "reads.fa")
    log(f"cli: {len(want)} SAM records of {len(reads)} reads = align_reads; "
        "--nproc 2 merged = single run; -p p, -p b = align_reads")


def sam_sha256(all_lines) -> dict:
    """SHA-256 of each path's full SAM lines (newline-terminated)."""
    import hashlib

    return {label: hashlib.sha256("".join(ln + "\n" for ln in lines)
                                  .encode()).hexdigest()
            for label, lines in all_lines.items()}


HAND = ("sdp_blocked_warp_kernel", "sdp_blocked_cta_kernel",
        "chain_mask_warp_kernel", "chain_mask_cta_kernel",
        "banded_global_kernel",
        "banded_refine_kernel", "rowsync_kernel", "one_gap_warp_kernel",
        "one_gap_kernel",
        "sdp_windowed_kernel", "scan_warp_kernel", "scan_cta_kernel",
        "arrows_kernel", "arrows_cta_kernel", "refine_shaped_kernel")


def profile_phase(work, label, workers=0) -> None:
    """Device time by kernel name over one run of a path (with workers,
    through align_stream at that many workers, in batches of
    STREAM_BATCH)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lra_tpu_torch.pipeline.stream import align_stream

    _, kind, use_pallas, _ = next(p for p in PATHS if p[0] == label)
    genome, batches, idx, opts, gli = work[kind]
    opts.use_pallas = use_pallas
    if workers:
        batches = stream_batches(work, kind)
        label = f"{label}, stream workers {workers}"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if workers:
            drain(align_stream(batches, genome, idx, opts, genome_li=gli,
                               workers=workers, device=DEV),
                  STREAM_TIMEOUT)
        else:
            align_all(batches, genome, idx, opts, gli, DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        if dt and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    log(f"profile [{label}]: wall {wall * 1e3:.1f} ms for {len(batches)} "
        f"batch(es), device kernels {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f} % busy)")
    mine = [r for r in rows if any(h in r[2] for h in HAND)]
    for dt, n, key in mine:
        log(f"  hand kernel {dt / 1e3:10.3f} ms {n:6d}x {key[:60]}")
    for h in HAND:
        inst = [r for r in mine if h in r[2]]
        if inst:
            log(f"  {h}: {sum(r[0] for r in inst) / 1e3:.3f} ms of device "
                f"time in {sum(r[1] for r in inst)} launches")
    rest = [r for r in rows if r not in mine]
    log(f"  other device kernels (glue, copies, fills): "
        f"{sum(r[0] for r in rest) / 1e3:.1f} ms in "
        f"{sum(r[1] for r in rest)} launches"
        + (" per CCS batch (PR 1, with K6 and K3 as plain torch: 107,947)"
           if kind == "ccs" else ""))
    for dt, n, key in rest[:8]:
        log(f"  {dt / 1e3:10.2f} ms {n:7d}x {key[:90]}")


def kernel_label(line: str) -> str:
    """The kernel's name and template arguments from ptxas's "Compiling
    entry function '_ZN..._cu_<hash>NNname[I...E]...'" line, e.g.
    arrows_kernel<2, 0>."""
    import re

    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", line)
    if not m:
        return "?"
    at = m.end()
    name = line[at:at + int(m.group(1))]
    rest = line[at + int(m.group(1)):]
    args = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
    if args:
        name += "<" + ", ".join(re.findall(r"L[a-z](\d+)E", args.group(1))) \
            + ">"
    return name


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import affine_kernel as ak

    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    took = _ext.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for n in _ext.SOURCES:
        logf = os.path.join(_ext.BUILD_DIR, f"{n}.log")
        if os.path.exists(logf):
            kern = "?"
            for ln in open(logf):
                if "Compiling entry function" in ln:
                    kern = kernel_label(ln)
                elif "registers" in ln or "spill" in ln:
                    log(f"  ptxas {n} {kern}: {ln.strip()[:150]}")

    from lra_tpu_torch import native

    lib = native._load()
    log(f"native host library: {native._SO} (ABI version "
        f"{lib.lrn_abi_version()})")
    t0 = time.perf_counter()
    kernel_phase(torch.device("cuda"))
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    genome, ccs_rng = make_genome()
    work = {k: make_workload(k, genome, ccs_rng)
            for k in (*SHAPES, "contig_bench", *DRAFTS)}
    log(f"e2e set-up (2 Mb genome; CCS, ONT, CLR reads, bench contigs; "
        f"2.5 and 7 Mb draft contigs on 5.5 and 10 Mb genomes; indexes): "
        f"{time.perf_counter() - t0:.1f} s")
    rec = Recorder()
    mixes: dict = {}
    shaped = ShapedCapture()
    all_lines, launches, path_counts, walls = e2e_phase(work, rec, mixes,
                                                        shaped)
    log(f"[{time.perf_counter() - T0:.0f} s] e2e paths done")
    for label, lines in all_lines.items():
        check_sha(label, lines)
    log("SAM SHA-256 of every path = the recorded one")
    if all_lines["ccs use_pallas=True"] != all_lines["ccs"]:
        raise AssertionError("CCS: the use_pallas=True run's SAM lines != "
                             "the default run's")
    log(f"CCS use_pallas=True = CCS default: {len(all_lines['ccs'])} SAM "
        "lines byte-equal")
    sha = sam_sha256(all_lines)
    chain_mask_phase(mixes["ccs use_pallas=True"].sdp2, work["ccs"][3], rec,
                     launches)
    rows = main_path_kernels(rec, launches)
    planned_paths_phase("K5", rec.refine,
                        ak.banded_refine_traced_packed_plain,
                        ak._refine_cuda, ak.refine_plan)
    launch_shapes("K4", rec.glob_calls, "(B, S, K)")
    planned_paths_phase("K4", rec.glob,
                        ak.banded_global_traced_packed_plain,
                        ak._global_cuda, ak.global_plan)
    launch_shapes("K2", rec.blocked_calls, "(B, N, need_full)")
    blocked_paths_phase(rec)
    launch_shapes("K6", rec.og_calls,
                  "(B, K, D, real problems, longest shorter side)")
    one_gap_paths_phase(rec)
    launch_shapes("P1", rec.p1_calls, "(B, S, K)")
    rowsync_paths_phase(rec)
    launch_shapes("K3", rec.k3_calls, "(B, N)")
    for label, calls in rec.k3_inputs.items():
        for i, (args, _) in enumerate(calls):
            mask_check(f"[{label}] #{i} B={args[0].shape[0]} "
                       f"N={args[0].shape[1]}", args)
    k6_store = {f"{label} #{i}": (0, args, {})
                for label, calls in rec.og_inputs.items()
                for i, args in enumerate(calls)}
    p1_store, k3_store = ({f"{label} #{i}": (0, *call)
                           for label, calls in inputs.items()
                           for i, call in enumerate(calls)}
                          for inputs in (rec.p1_inputs, rec.k3_inputs))
    for flag, tag, store in (("--save-k4", "K4", rec.glob),
                             ("--save-k2", "K2", rec.blocked),
                             ("--save-k6", "K6", k6_store),
                             ("--save-p1", "P1", p1_store),
                             ("--save-k3", "K3", k3_store)):
        if flag in sys.argv:
            save_inputs(tag, store, sys.argv[sys.argv.index(flag) + 1])
    windowed_paths_phase(rec)
    shaped_paths_phase(work, shaped)
    log(f"[{time.perf_counter() - T0:.0f} s] main-path kernels done")
    mesh_rows, mesh_inputs = mesh_phase(work, rec, all_lines, path_counts,
                                        walls)
    rows += mesh_rows
    for flag, tag, name in (("--save-k8", "K8", "chain_scores"),
                            ("--save-k9", "K9", "banded_global_kernel")):
        if flag in sys.argv:
            save_inputs(tag, {f"mesh phase {name}": (0, *mesh_inputs[name])},
                        sys.argv[sys.argv.index(flag) + 1])
    log(f"[{time.perf_counter() - T0:.0f} s] mesh done")
    cpu_parity(work, all_lines)
    contig_parity(work)
    log(f"[{time.perf_counter() - T0:.0f} s] cpu parity done")
    rates = stream_phase(work, all_lines)
    log(f"[{time.perf_counter() - T0:.0f} s] stream done: reads/s by "
        f"workers {json.dumps(rates)}")
    devstats_phase(work)
    cli_phase(work)
    log(f"[{time.perf_counter() - T0:.0f} s] devstats, cli done")
    for label in ("ccs use_pallas=True", "ccs", "ont", "clr",
                  "contig 2.5 Mb"):
        profile_phase(work, label)
    for label in ("ccs", "ont", "clr"):
        profile_phase(work, label, workers=4)
    log(f"total {time.perf_counter() - T0:.0f} s")
    print(json.dumps({"sam_sha256": sha}))
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        # a stream worker hung on the card must not hold the exit
        os._exit(1)
    sys.exit(rc)
