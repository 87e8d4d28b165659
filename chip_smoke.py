#!/usr/bin/env python3
"""Chip smoke run of lra_tpu_torch, the PyTorch/CUDA port of lra_tpu.

    python3 chip_smoke.py      # from the repository root, one CUDA GPU

Needs a CUDA device and nvcc (the kernels are built from csrc/ at first
use); exits non-zero without a result line otherwise, and on any
failure.  Phases:

1. the card's name and power limit; the parallel nvcc build of every
   kernel source;
2. kernels: each hand-written kernel against its plain torch twin on
   seeded inputs at a spread of shapes — exact equality — with median
   CUDA-event times;
3. end to end: the CCS preset with use_pallas=True at bench.py's shapes
   (2 Mb random genome, 256 reads of 8 kb, snp 0.003, ins/del 0.001,
   numpy seed 0) through align_reads(..., device="cuda"): a warm-up that
   also records the largest input each kernel got, then a timed run with
   the launch counts reset just before and read just after, device round
   times from CUDA events; fails if a kernel of the path was not
   launched;
4. the recorded main-path inputs: each kernel against its plain twin
   again (exact), timed, beside its bound;
5. the first 16 reads on device="cpu" (the plain twins): SAM lines
   byte-equal to the CUDA run's;
6. one more CCS use_pallas=True run under torch.profiler: the device's
   busy share and the device time of the hand kernels against all other
   (plain torch) kernels.

The line before the last is the kernels JSON object; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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
# two closures, five-way arrow), and an SDP fragment pair (both lanes:
# masks, |d| + 1, PWL piece select, multiply, add, floor, clamps, V + w,
# max).
OPS_PER_CELL = {"banded_global_traced_packed": 10,
                "banded_pallas_rowsync": 10,
                "banded_refine_traced_packed": 18}
OPS_PER_PAIR = 40

KERNELS = {
    "chain_scores_blocked": ("lra_tpu_torch/csrc/sdp_blocked.cu",
                             "lra_tpu/ops/sdp_blocked.py:33"),
    "banded_global_traced_packed": ("lra_tpu_torch/csrc/banded_global.cu",
                                    "lra_tpu/ops/affine_kernel.py:206"),
    "banded_refine_traced_packed": ("lra_tpu_torch/csrc/banded_refine.cu",
                                    "lra_tpu/ops/affine_kernel.py:546"),
    "banded_pallas_rowsync": ("lra_tpu_torch/csrc/rowsync.cu",
                              "lra_tpu/ops/affine_pallas.py:225"),
}
M, MM, IND = 4, -3, -4      # CCS local_match / local_mismatch / local_indel


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
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


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


# ------------------------------------------------------------ bounds ---

def dp_bound(name, K, q, t, tlen, out) -> tuple:
    """Least time for the DP rows this data needs (rows 0..tlen of the
    band per problem): max(bytes / HBM rate, operations / f32 rate)."""
    rows = int((tlen.clamp(max=t.shape[1]).long() + 1).sum())
    ops = rows * (2 * K + 1) * OPS_PER_CELL[name]
    nbytes = q.numel() + t.numel() + 3 * 4 * q.shape[0] + out.numel()
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(tb, to) * 1e3, "bytes" if tb > to else "operations"


def sdp_bound(args) -> tuple:
    qS, valid = args[0], args[7]
    n = valid.sum(dim=1).double()
    pairs = float((n * (n - 1) / 2).sum())
    ops = pairs * OPS_PER_PAIR
    nbytes = qS.numel() * (4 * 4 + 4 + 3 + 3 * 4)
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(tb, to) * 1e3, "bytes" if tb > to else "operations"


# ------------------------------------------------------------- phases ---

def kernel_phase(dev) -> None:
    import torch

    from lra_tpu_torch import preset
    from lra_tpu_torch.ops import affine_kernel as ak
    from lra_tpu_torch.ops import affine_pallas as ap
    from lra_tpu_torch.ops import sdp_blocked as sb
    from lra_tpu_torch.ops.gapcost import from_options

    rng = np.random.default_rng(0)
    key = from_options(preset("ccs")).static_key()
    for N in (64, 8192):
        a = sdp_inputs(rng, 16, N, dev)
        got = sb.chain_scores_blocked(*a, key)
        torch.cuda.synchronize()
        ref = sb.chain_scores_blocked_plain(*a, key)
        torch.cuda.synchronize()
        for nm, x, y in zip(("V", "bp", "lane"), got, ref):
            exact(f"chain_scores_blocked N={N} {nm}", x, y)
        ms = cuda_ms(lambda: sb.chain_scores_blocked(*a, key), 5)
        pms = cuda_ms(lambda: sb.chain_scores_blocked_plain(*a, key), 1)
        log(f"kernel chain_scores_blocked B=16 N={N}: exact; "
            f"{ms:.3f} ms (plain {pms:.1f} ms)")
    for K in (30, 128, 512):
        for S in (256, 2048):
            a = banded_inputs(rng, 8, S, K, dev)
            got = ak.banded_global_traced_packed(*a[:4], K, M, MM, IND,
                                                 kband=a[4])
            torch.cuda.synchronize()
            ref = ak.banded_global_traced_packed_plain(*a[:4], K, M, MM, IND,
                                                       a[4])
            torch.cuda.synchronize()
            exact(f"banded_global_traced_packed K={K} S={S}", got, ref)
            ms = cuda_ms(lambda: ak.banded_global_traced_packed(
                *a[:4], K, M, MM, IND, kband=a[4]), 5)
            pms = cuda_ms(lambda: ak.banded_global_traced_packed_plain(
                *a[:4], K, M, MM, IND, a[4]), 1)
            log(f"kernel banded_global_traced_packed B=8 K={K} S={S}: "
                f"exact; {ms:.3f} ms (plain {pms:.1f} ms)")
    for K in (30, 64):
        for S in (256, 1024):
            a = banded_inputs(rng, 8, S, K, dev)
            got = ak.banded_refine_traced_packed(*a[:4], K, M, MM, IND,
                                                 kband=a[4])
            torch.cuda.synchronize()
            ref = ak.banded_refine_traced_packed_plain(*a[:4], K, M, MM, IND,
                                                       a[4])
            torch.cuda.synchronize()
            exact(f"banded_refine_traced_packed K={K} S={S}", got, ref)
            ms = cuda_ms(lambda: ak.banded_refine_traced_packed(
                *a[:4], K, M, MM, IND, kband=a[4]), 5)
            pms = cuda_ms(lambda: ak.banded_refine_traced_packed_plain(
                *a[:4], K, M, MM, IND, a[4]), 1)
            log(f"kernel banded_refine_traced_packed B=8 K={K} S={S}: "
                f"exact; {ms:.3f} ms (plain {pms:.1f} ms)")
    K = 30
    for S in (64, 512, 2048):
        a = banded_inputs(rng, 64, S, K, dev)
        P = ap.banded_pallas_rowsync(*a[:4], K, M, MM, IND, kband=a[4])
        torch.cuda.synchronize()
        Pref = ap.banded_pallas_rowsync_plain(*a[:4], K, M, MM, IND, a[4])
        torch.cuda.synchronize()
        exact(f"banded_pallas_rowsync S={S}", P, Pref)
        ops = ak.banded_global_traced_packed(*a[:4], K, M, MM, IND,
                                             kband=a[4])
        torch.cuda.synchronize()
        ql, tl = a[2].cpu().numpy(), a[3].cpu().numpy()
        rs = ap.blocks_from_rowsync(P.cpu().numpy(), ql, tl, S)
        k4 = ak.blocks_from_ops_batch(ak.unpack_ops(ops.cpu().numpy()))
        if rs != k4:
            raise AssertionError(f"rowsync S={S}: decoded blocks differ "
                                 "from banded_global_traced_packed's")
        ms = cuda_ms(lambda: ap.banded_pallas_rowsync(
            *a[:4], K, M, MM, IND, kband=a[4]), 5)
        pms = cuda_ms(lambda: ap.banded_pallas_rowsync_plain(
            *a[:4], K, M, MM, IND, a[4]), 1)
        log(f"kernel banded_pallas_rowsync B=64 K=30 S={S}: exact, blocks "
            f"== K4's; {ms:.3f} ms (plain {pms:.1f} ms)")


class Recorder:
    """Wraps the kernel entry points the pipeline calls and keeps the
    inputs of the largest call each kernel gets (warm-up run only)."""

    SITES = (("lra_tpu_torch.pipeline.gap_align", "banded_global_traced_packed"),
             ("lra_tpu_torch.pipeline.gap_align", "banded_refine_traced_packed"),
             ("lra_tpu_torch.pipeline.gap_align", "banded_pallas_rowsync"),
             ("lra_tpu_torch.chain.driver", "chain_scores_blocked"))

    def __init__(self):
        self.best: dict = {}
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

    def _wrap(self, name, orig):
        def rec(*args, **kw):
            work = args[0].numel() * (args[4] if isinstance(args[4], int)
                                      else 1)
            if work > self.best.get(name, (-1,))[0]:
                self.best[name] = (work, [x.clone() if hasattr(x, "clone")
                                          else x for x in args],
                                   {k: v.clone() if hasattr(v, "clone")
                                    else v for k, v in kw.items()})
            return orig(*args, **kw)
        return rec


class JobMix:
    """Tallies the work each device round is given (warm-up run only):
    chaining problems and their largest fragment count per SDP round,
    jobs and their longest side per alignment round."""

    SITES = (("lra_tpu_torch.pipeline.highacc", "solve_problems"),
             ("lra_tpu_torch.pipeline.big_gap", "resolve_big_gaps"),
             ("lra_tpu_torch.pipeline.highacc", "solve_gap_jobs"),
             ("lra_tpu_torch.pipeline.gap_align", "solve_gap_jobs"))

    def __init__(self):
        self.rounds: list = []
        self.saved = []

    def __enter__(self):
        import importlib

        self.rounds = []
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
        def tally(items, *args, **kw):
            if fn_name == "solve_problems":     # SDP-1, then SDP-2
                name = "SDP-2" if any(r[0] == "SDP-1" for r in self.rounds) \
                    else "SDP-1"
                sizes = [len(p.qS) for p in items]
                what = "problems, max fragments"
            elif fn_name == "resolve_big_gaps":
                name = "SDP-3"
                sizes = [len(t.problem.qS) for t in items]
                what = "problems, max fragments"
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
        return [f"{n}: {c} {w.split(',')[0]}, {w.split(', ')[1]} {m}"
                for n, c, m, w in self.rounds]


# The CCS main path, in its two configurations: use_pallas=True (the
# slice's configuration: the narrow band tier on the row-sync kernel) and
# the default (that tier on banded_global_traced_packed).  Each lists the
# kernels its run must launch.
PATHS = (
    ("ccs use_pallas=True", True, ("chain_scores_blocked",
                                   "banded_refine_traced_packed",
                                   "banded_pallas_rowsync")),
    ("ccs", False, ("chain_scores_blocked", "banded_refine_traced_packed",
                    "banded_global_traced_packed")),
)


def make_workload(genome_len=2_000_000, n_reads=256, read_len=8000):
    """bench.py's CCS workload, from numpy seed 0."""
    from lra_tpu_torch import preset
    from lra_tpu_torch.index.global_index import build_global_index
    from lra_tpu_torch.io.genome import Genome
    from lra_tpu_torch.sim import random_genome, sample_read

    rng = np.random.default_rng(0)
    genome = Genome.from_seqs([("chr1", random_genome(rng, genome_len))])
    opts = preset("ccs")
    idx = build_global_index(genome, opts)
    reads = []
    for i in range(n_reads):
        r = sample_read(rng, genome.codes, read_len, snp=0.003, ins=0.001,
                        dele=0.001)
        reads.append((f"r{i}", r.codes))
    return reads, genome, idx, opts


def e2e_phase(dev, reads, genome, idx, opts, rec) -> tuple:
    """Drive each CCS path: a recorded warm-up, then a timed run with the
    launch counts reset just before and read just after.  Returns
    ({path: SAM lines}, {kernel: launches on its path})."""
    import torch

    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.pipeline import align_reads
    from lra_tpu_torch.utils.timing import CudaEventTiming

    all_lines, launches = {}, {}
    for label, use_pallas, needed in PATHS:
        opts.use_pallas = use_pallas
        t0 = time.perf_counter()
        mix = JobMix()
        with rec, mix:
            align_reads(reads, genome, idx, opts, device=dev)
        torch.cuda.synchronize()
        log(f"e2e [{label}] warm-up: {time.perf_counter() - t0:.2f} s")
        for ln in mix.lines():
            log(f"  job mix {ln}")

        timing = CudaEventTiming()
        _ext.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, lines = align_reads(reads, genome, idx, opts, device=dev,
                                    timing=timing)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(_ext.LAUNCHES)
        mapped = sum(1 for s in states if not s.unaligned)
        log(f"e2e [{label}]: {len(reads) / dt:.2f} reads/s ({dt:.3f} s for "
            f"{len(reads)} reads), mapped {mapped}/{len(reads)}, "
            f"{len(lines)} SAM lines")
        for stage, ms in timing.stage_ms().items():
            log(f"  stage {stage:28s} {ms:10.2f} ms")
        log(f"  launches {json.dumps(counts)}")
        for k in needed:
            if counts[k] == 0:
                raise AssertionError(f"[{label}] kernel {k} was not "
                                     "launched on the main path")
            launches.setdefault(k, counts[k])
        if mapped < 0.9 * len(reads):
            raise AssertionError(f"[{label}] only {mapped} of {len(reads)} "
                                 "reads mapped")
        for ln in lines:
            if len(ln.split("\t")) < 11:
                raise AssertionError(f"malformed SAM line: {ln[:120]}")
        all_lines[label] = lines
    return all_lines, launches


def main_path_kernels(rec, launches) -> list:
    """Each kernel against its plain twin on the largest input the main
    path gave it; times and bounds for the JSON line."""
    import torch

    from lra_tpu_torch.ops import affine_kernel as ak
    from lra_tpu_torch.ops import affine_pallas as ap
    from lra_tpu_torch.ops import sdp_blocked as sb

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
        if name not in rec.best:
            raise AssertionError(f"no main-path call of {name} recorded")
        _, args, kw = rec.best[name]
        if name == "chain_scores_blocked":
            fn = lambda: sb.chain_scores_blocked(*args, **kw)
            pfn = lambda: sb.chain_scores_blocked_plain(*args, **kw)
            got, ref = fn(), pfn()
            torch.cuda.synchronize()
            err = max(exact(f"{name} (main-path input)", x, y)
                      for x, y in zip(got, ref))
            bound, by = sdp_bound(args)
            shape = f"B={args[0].shape[0]} N={args[0].shape[1]}"
        else:
            q, t, qlen, tlen, K = args[:5]
            kband = kw["kband"]
            fn = lambda: wrap[name](q, t, qlen, tlen, K, *args[5:8],
                                    kband=kband)
            pfn = lambda: plain[name](q, t, qlen, tlen, K, *args[5:8], kband)
            got, ref = fn(), pfn()
            torch.cuda.synchronize()
            err = exact(f"{name} (main-path input)", got, ref)
            bound, by = dp_bound(name, K, q, t, tlen, got)
            shape = f"B={q.shape[0]} S={q.shape[1]} K={K}"
        ms = cuda_ms(fn, 10)
        pms = cuda_ms(pfn, 2)
        log(f"main-path {name} [{shape}]: exact (max |err| {err}); "
            f"{ms:.4f} ms, plain "
            f"{pms:.2f} ms, bound {bound:.5f} ms ({by})")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bound, "bound_by": by, "library_ms": None,
                     "shape": shape})
    return rows


def cpu_parity(reads, genome, idx, opts, all_lines) -> None:
    """The first 16 reads on device="cpu" (plain twins) and on "cuda":
    SAM lines byte-equal to each other and to the full CUDA run's."""
    from lra_tpu_torch.pipeline import align_reads

    sub = reads[:16]
    names = {n for n, _ in sub}
    for label, use_pallas, _ in PATHS:
        opts.use_pallas = use_pallas
        t0 = time.perf_counter()
        _, cpu_lines = align_reads(sub, genome, idx, opts, device="cpu")
        t1 = time.perf_counter()
        _, gpu_lines = align_reads(sub, genome, idx, opts, device="cuda")
        full = [ln for ln in all_lines[label]
                if ln.split("\t", 1)[0] in names]
        if cpu_lines != gpu_lines:
            raise AssertionError(f"[{label}] SAM lines of 16 reads: "
                                 "device='cpu' != device='cuda'")
        if cpu_lines != full:
            raise AssertionError(f"[{label}] SAM lines of 16 reads: "
                                 "device='cpu' != the full CUDA run's")
        log(f"cpu parity [{label}]: {len(cpu_lines)} SAM lines of 16 reads "
            f"byte-equal (cpu run {t1 - t0:.1f} s)")


def profile_phase(reads, genome, idx, opts) -> None:
    """Device time by kernel name over one CCS use_pallas=True run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lra_tpu_torch.pipeline import align_reads

    opts.use_pallas = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        align_reads(reads, genome, idx, opts, device="cuda")
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
    log(f"profile [ccs use_pallas=True]: wall {wall * 1e3:.1f} ms, device "
        f"kernels {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f} % busy)")
    hand = ("sdp_blocked_kernel", "banded_global_kernel",
            "banded_refine_kernel", "rowsync_kernel")
    mine = [r for r in rows if any(h in r[2] for h in hand)]
    for dt, n, key in mine:
        log(f"  hand kernel {dt / 1e3:10.3f} ms {n:6d}x {key[:60]}")
    rest = [r for r in rows if r not in mine]
    log(f"  other device kernels (plain torch: K6, K3, glue, copies): "
        f"{sum(r[0] for r in rest) / 1e3:.1f} ms in "
        f"{sum(r[1] for r in rest)} launches")
    for dt, n, key in rest[:12]:
        log(f"  {dt / 1e3:10.2f} ms {n:7d}x {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lra_tpu_torch.ops import _ext

    smi = smi_line()
    log(smi)
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    took = _ext.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for n in _ext.SOURCES:
        logf = os.path.join(_ext.BUILD_DIR, f"{n}.log")
        if os.path.exists(logf):
            for ln in open(logf):
                if "registers" in ln or "spill" in ln:
                    log(f"  ptxas {n}: {ln.strip()[:150]}")

    t0 = time.perf_counter()
    kernel_phase(dev)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reads, genome, idx, opts = make_workload()
    log(f"e2e set-up (2 Mb genome, index, 256 reads of 8 kb): "
        f"{time.perf_counter() - t0:.1f} s")
    rec = Recorder()
    all_lines, launches = e2e_phase(dev, reads, genome, idx, opts, rec)
    rows = main_path_kernels(rec, launches)
    cpu_parity(reads, genome, idx, opts, all_lines)
    profile_phase(reads, genome, idx, opts)
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
