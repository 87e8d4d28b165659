"""On the card: each hand-written CUDA kernel == its plain torch twin,
exactly (bit for bit for f32).  Imports neither jax nor lra_tpu, so it
runs on a machine with only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -m cuda

Without a CUDA device every test skips."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from lra_tpu_torch import preset
from lra_tpu_torch.chain import driver
from lra_tpu_torch.ops import affine_kernel as ak
from lra_tpu_torch.ops import affine_pallas as ap
from lra_tpu_torch.ops import one_gap as og
from lra_tpu_torch.ops import sdp_blocked as sb
from lra_tpu_torch.ops import sdp
from lra_tpu_torch.ops import sdp_windowed as sw
from lra_tpu_torch.ops.gapcost import from_options, make_gap_params
from lra_tpu_torch.ops import _ext
from lra_tpu_torch.parallel import mesh
from lra_tpu_torch.sim import (contig_chain_arrays, mask_problems,
                               mesh_step_inputs, one_gap_problems,
                               negative_piece, refine_problems,
                               rowsync_problems, scan_bucket, sdp_bucket,
                               tie_dense_chain_arrays, zero_slope_piece)

torch.set_num_threads(2)
M, MM, IND = 4, -3, -4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def frag_batch(rng, B, N, dev):
    ln = rng.integers(15, 60, (B, N))
    qS = np.sort(rng.integers(0, 60 * N, (B, N)), axis=1)
    tS = (qS + rng.integers(-1500, 1500, (B, N))).clip(0)
    strand = rng.random((B, N)) < 0.7
    both = rng.random((B, N)) < 0.2
    nvalid = rng.integers(1, N + 1, B)
    valid = np.arange(N)[None, :] < nvalid[:, None]
    arrs = [qS.astype(np.int32), (qS + ln).astype(np.int32),
            tS.astype(np.int32), (tS + ln).astype(np.int32),
            (ln * 2.0).astype(np.float32), strand | both, ~strand | both,
            valid]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


def gap_batch(rng, B, S, K, dev):
    t = rng.integers(0, 4, (B, S)).astype(np.int8)
    q = t.copy()
    for b in range(B):
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, S))
            q[b, p] = (q[b, p] + 1) % 4
        if rng.random() < 0.5:
            p = int(rng.integers(1, S - 1))
            q[b, p:] = np.roll(q[b, p:], 1)
    qlen = rng.integers(S // 2, S + 1, B).astype(np.int32)
    tlen = np.clip(qlen + rng.integers(-6, 6, B), 8, S).astype(np.int32)
    kb = np.minimum(np.maximum(np.abs(qlen - tlen)
                               + rng.integers(0, 8, B), 1), K)
    return [torch.from_numpy(a).to(dev)
            for a in (q, t, qlen, tlen, kb.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(8, 64), (4, 512)])
def test_chain_scores_blocked_kernel_matches_plain(cuda_device, B, N):
    key = from_options(preset("ccs")).static_key()
    args = frag_batch(np.random.default_rng(N), B, N, cuda_device)
    got = sb.chain_scores_blocked(*args, key)
    ref = sb.chain_scores_blocked_plain(*args, key)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


def blocked_bucket(rng, B, N, kind, dev):
    """K2's arguments: sim.sdp_bucket (invalid rows with lane bits, an
    all-invalid problem with lane bits, an empty problem), or tie-dense
    problems (sim.tie_dense_chain_arrays: roots at one q, collectors
    tying across every root in both lanes) at the driver's padding."""
    if kind == "tie":
        plist = [driver.ChainProblem(*tie_dense_chain_arrays(
            rng, int(rng.integers(1, N // 4 + 2)),
            int(rng.integers(1, N // 2 + 1)))) for _ in range(B)]
        arrays = driver.pad_problems(plist, B, N)
    else:
        arrays = sdp_bucket(rng, B, N)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,kind", [
    (4096, 64, "edges"), (512, 64, "edges"), (13, 64, "edges"),
    (1, 64, "edges"),
    (13, 128, "edges"), (512, 512, "edges"), (13, 512, "edges"),
    (1, 2048, "edges"), (13, 2048, "edges"), (1, 8192, "edges"),
    (13, 64, "tie"), (13, 128, "tie"), (3, 512, "tie"), (2, 2048, "tie")])
def test_blocked_kernel_tiers_match_plain(cuda_device, B, N, kind):
    """K2 at every tier (one problem a warp at N = 64, one a block above),
    B = 1, 13, 512 and 4096 (more blocks than fit the card at once), N up
    to 8192, on invalid rows that keep lane bits, an all-invalid problem
    with lane bits, an empty problem, and tie-dense problems; through the
    wrapper
    and with every launch plan forced: V bit for bit, bp and lane
    exactly equal to the plain twin."""
    key = from_options(preset("ccs")).static_key()
    args = blocked_bucket(np.random.default_rng(B * N), B, N, kind,
                          cuda_device)
    ref = sb.chain_scores_blocked_plain(*args, key)
    got = sb.chain_scores_blocked(*args, key)
    torch.cuda.synchronize()
    assert bool((ref[1] >= 0).any())
    if kind == "edges" and B > 1:
        invalid_taken = (~args[7]) & (ref[1] >= 0)
        assert bool(invalid_taken.any())
    for plan in [None] + sb.plan_variants(N):
        if plan is not None:
            got = sb._chain_scores_blocked_cuda(*args, key, 64, plan=plan)
            torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32),
                           ref[0].view(torch.int32)), plan
        assert torch.equal(got[1], ref[1]), plan
        assert torch.equal(got[2], ref[2]), plan


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K", [
    (13, 16, 30), (8, 64, 30), (13, 128, 64), (13, 256, 128),
    (13, 200, 100), (9, 512, 256), (9, 1024, 512), (7, 2048, 700),
    (7, 2048, 1023)])
def test_refine_kernel_matches_plain(cuda_device, B, S, K):
    """K5 at every K tier (30, 64, 128, 256, 512), off-tier K (100, 700,
    1023: the widest band the wrapper takes), S 16-2048, B no multiple
    of the problems a block holds, and the edge problems of
    sim.refine_problems, through the wrapper and with each of the two
    launch plans forced: packed ops exactly equal to the plain twin."""
    q, t, ql, tl, kb = [torch.from_numpy(a).to(cuda_device) for a in
                        refine_problems(np.random.default_rng(S + K), B, S,
                                        K)]
    ref = ak.banded_refine_traced_packed_plain(q, t, ql, tl, K, M, MM, IND,
                                               kb)
    got = ak.banded_refine_traced_packed(q, t, ql, tl, K, M, MM, IND,
                                         kband=kb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert bool((ref != 0).any())
    # the plans of a small and of a full bucket: one and 8 / WP problems
    # per block
    for plan in (ak.refine_plan(K, 1), ak.refine_plan(K, 1 << 20)):
        got = ak._refine_cuda(q, t, ql, tl, kb, K, M, MM, IND, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), plan


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K", [
    (13, 16, 30), (8, 64, 30), (13, 128, 64), (13, 256, 128),
    (13, 200, 100), (9, 512, 256), (9, 1024, 512), (7, 2048, 700),
    (7, 2048, 1023)])
def test_global_kernel_edges_match_plain(cuda_device, B, S, K):
    """K4 on the buckets of test_refine_kernel_matches_plain (every K
    tier, off-tier K, S 16-2048, the edge problems of
    sim.refine_problems), through the wrapper and with each of the two
    launch plans forced: packed ops exactly equal to the plain twin."""
    q, t, ql, tl, kb = [torch.from_numpy(a).to(cuda_device) for a in
                        refine_problems(np.random.default_rng(S + K), B, S,
                                        K)]
    ref = ak.banded_global_traced_packed_plain(q, t, ql, tl, K, M, MM, IND,
                                               kb)
    got = ak.banded_global_traced_packed(q, t, ql, tl, K, M, MM, IND,
                                         kband=kb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert bool((ref != 0).any())
    for plan in (ak.global_plan(K, 1), ak.global_plan(K, 1 << 20)):
        got = ak._global_cuda(q, t, ql, tl, kb, K, M, MM, IND, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), plan


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,B,S,K", [
    ("global", 8, 64, 30), ("global", 8, 128, 64), ("global", 4, 256, 128),
    ("global", 4, 200, 100), ("global", 3, 512, 256),
    ("global", 2, 512, 512), ("global", 2, 1024, 1023),
    ("refine", 8, 64, 30), ("refine", 4, 256, 64),
    ("rowsync", 16, 64, 30), ("rowsync", 8, 512, 30)])
def test_banded_kernels_match_plain(cuda_device, kernel, B, S, K):
    """K4 ("global") at every K tier and off-tier K, also with each of
    its two launch plans forced; K5; the row-sync kernel (P1), also with
    every plan of ap.rowsync_plan_variants forced."""
    q, t, ql, tl, kb = gap_batch(np.random.default_rng(S + K), B, S, K,
                                 cuda_device)
    fn, plain = {
        "global": (ak.banded_global_traced_packed,
                   ak.banded_global_traced_packed_plain),
        "refine": (ak.banded_refine_traced_packed,
                   ak.banded_refine_traced_packed_plain),
        "rowsync": (ap.banded_pallas_rowsync,
                    ap.banded_pallas_rowsync_plain)}[kernel]
    got = fn(q, t, ql, tl, K, M, MM, IND, kband=kb)
    ref = plain(q, t, ql, tl, K, M, MM, IND, kb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if kernel == "global":
        for plan in (ak.global_plan(K, 1), ak.global_plan(K, 1 << 20)):
            got = ak._global_cuda(q, t, ql, tl, kb, K, M, MM, IND,
                                  plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), plan
    if kernel == "rowsync":
        for _, plan in ap.rowsync_plan_variants(S):
            got = ap._rowsync_cuda(q, t, ql, tl, kb, K, M, MM, IND,
                                   plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), plan


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K", [
    (13, 16, 30), (1056, 16, 30), (13, 32, 30), (2048, 32, 30),
    (13, 64, 15), (13, 64, 31), (9, 512, 30), (7, 2048, 30),
    (8, 14528, 30)])
def test_rowsync_kernel_plans_match_plain(cuda_device, B, S, K):
    """P1 on sim.rowsync_problems (qlen 0, tlen 0, starts off the band on
    either side, kband < K, an insertion whose run reaches row 0) at S
    16-2048, K 15-31 (band 63), B across the edge of 8 problems a block
    and past it, and S = 14528 where no problem fits a block, through the
    wrapper and with every plan forced: P equal to the plain twin's byte
    for byte, its decoded blocks equal to K4's."""
    q, t, ql, tl, kb = [torch.from_numpy(a).to(cuda_device) for a in
                        rowsync_problems(np.random.default_rng(S + K), B, S,
                                         K)]
    ref = ap.banded_pallas_rowsync_plain(q, t, ql, tl, K, M, MM, IND, kb)
    got = ap.banded_pallas_rowsync(q, t, ql, tl, K, M, MM, IND, kband=kb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert ap.rowsync_plan(S, B)["smem_plane"] == (S <= 13669)
    for _, plan in ap.rowsync_plan_variants(S):
        out = ap._rowsync_cuda(q, t, ql, tl, kb, K, M, MM, IND, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), plan
    ops = ak.banded_global_traced_packed(q, t, ql, tl, K, M, MM, IND,
                                         kband=kb)
    assert ap.blocks_from_rowsync(got.cpu().numpy(), ql.cpu().numpy(),
                                  tl.cpu().numpy(), S) == \
        ak.blocks_from_ops_batch(ak.unpack_ops(ops.cpu().numpy()))


def one_gap_batch(rng, B, K, D, query_longer, max_gap, dev):
    """B one-gap problems of a (K, D) bucket plus one pad row (qlen 1,
    tlen 4, kband 1) as gap_align adds: a short side of D/2..D-1 bases
    with SNPs and a small indel, the long side its flanks around a random
    gap of 2k+1..max_gap bases."""
    qs, ts, kbs = [], [], []
    for _ in range(B):
        mn = int(rng.integers(max(1, D // 2), D))
        k = int(min(rng.integers(1, K), mn))
        gap = int(rng.integers(2 * k + 1, max(2 * k + 2, max_gap)))
        flank = rng.integers(0, 4, mn).astype(np.int8)
        longer = np.concatenate([flank[:mn // 2],
                                 rng.integers(0, 4, gap).astype(np.int8),
                                 flank[mn // 2:]])
        short = flank.copy()
        mut = rng.random(mn) < 0.05
        short[mut] = rng.integers(0, 4, int(mut.sum()))
        p = int(rng.integers(0, mn))
        short = np.delete(short, p) if rng.random() < 0.5 and mn > 2 \
            else np.insert(short, p, short[p])
        short = short[:D - 1]
        q, t = (longer, short) if query_longer else (short, longer)
        qs.append(q)
        ts.append(t)
        kbs.append(min(k, len(short)))
    qs.append(np.zeros(1, np.int8))
    ts.append(np.zeros(4, np.int8))
    kbs.append(1)
    packed = og.pack_one_gap_bucket(qs, ts, K, D)
    return [torch.from_numpy(a).to(dev)
            for a in list(packed) + [np.asarray(kbs, np.int32)]]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,D,query_longer,max_gap", [
    (16, 16, 64, True, 400), (16, 16, 64, False, 400),
    (8, 64, 512, True, 50000), (8, 64, 512, False, 50000),
    (3, 1024, 1024, True, 5000), (3, 1024, 1024, False, 5000)])
def test_one_gap_kernel_matches_plain(cuda_device, B, K, D, query_longer,
                                      max_gap):
    """K6 in both closure regimes, up to the 2052-lane bucket (K=1024)."""
    args = one_gap_batch(np.random.default_rng(K + D + query_longer), B, K,
                         D, query_longer, max_gap, cuda_device)
    L = 2 * (D + K) + 8
    got = og.one_gap_traced(*args, K, D, M, MM, IND, L)
    ref = og.one_gap_traced_plain(*args, K, D, M, MM, IND, L)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(got[2].view(torch.int32), ref[2].view(torch.int32))
    gap_op = og.GAPLEFT if query_longer else og.GAPDOWN
    assert int((ref[0][:B] == gap_op).sum()) == B


def one_gap_bucket(seed, B, K, D, query_longer, kind, pads, gaps, dev):
    qs, ts, kbs = one_gap_problems(np.random.default_rng(seed), B, K, D,
                                   query_longer, gaps, kind, pads)
    packed = og.pack_one_gap_bucket(qs, ts, K, D)
    return [torch.from_numpy(a).to(dev)
            for a in list(packed) + [np.asarray(kbs, np.int32)]]


def assert_one_gap_equal(got, ref, what):
    assert torch.equal(got[0], ref[0]), what
    assert torch.equal(got[1], ref[1]), what
    assert torch.equal(got[2].view(torch.int32), ref[2].view(torch.int32)), \
        what


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,D,query_longer,kind,pads,gaps", [
    (13, 16, 16, True, "random", 1, (0, 400)),
    (13, 16, 16, False, "random", 1, (0, 400)),
    (13, 32, 64, True, "random", 1, (0, 400)),
    (13, 32, 64, False, "random", 1, (0, 400)),
    (13, 64, 64, True, "random", 1, (0, 400)),
    (13, 64, 64, False, "random", 1, (0, 400)),
    (4, 16, 1024, True, "random", 1, (200, 5000)),
    (4, 16, 1024, False, "random", 1, (200, 5000)),
    (4, 32, 512, True, "random", 1, (200, 5000)),
    (4, 32, 512, False, "random", 1, (200, 5000)),
    (2, 32, 2048, True, "random", 1, (200, 5000)),
    (2, 32, 2048, False, "random", 1, (200, 5000)),
    (1200, 16, 16, True, "random", 1, (0, 400)),
    (1200, 16, 16, False, "random", 1, (0, 400)),
    (1, 16, 16, False, "random", 7, (0, 400)),
    (0, 32, 32, True, "random", 8, (0, 400)),
    (13, 16, 64, True, "tie", 1, (0, 400)),
    (13, 16, 64, False, "tie", 1, (0, 400)),
    (8, 32, 256, True, "tie", 1, (200, 2000)),
    (8, 32, 256, False, "tie", 1, (200, 2000))])
def test_one_gap_kernel_plans_match_plain(cuda_device, B, K, D, query_longer,
                                          kind, pads, gaps):
    """K6 with every plan of og.plan_variants and the wrapper's own: the
    warp tier (K = 16, 32) and the CTA tier (K = 64); D >> K in both
    regimes (the suffix warp beside the prefix: query longer, and target
    longer with its lag of ~K rows); planes in device memory (K=32
    D=2048); a bucket past the warps-a-problem edge (one warp a problem,
    4 a block, the last block part-full); buckets of gap_align's pad rows
    (qlen 1, tlen 4, kband 1); tie-dense problems (homopolymer runs and
    tandem repeats on both sides of and in the gap)."""
    args = one_gap_bucket(K + D + B + query_longer, B, K, D, query_longer,
                          kind, pads, gaps, cuda_device)
    L = 2 * (D + K) + 8
    ref = og.one_gap_traced_plain(*args, K, D, M, MM, IND, L)
    gap_op = og.GAPLEFT if query_longer else og.GAPDOWN
    assert int((ref[0][:B] == gap_op).sum()) == B
    assert_one_gap_equal(og.one_gap_traced(*args, K, D, M, MM, IND, L), ref,
                         "the wrapper's plan")
    for name, plan in og.plan_variants(K, D, B + pads):
        got = og._one_gap_traced_cuda(*args, K, D, M, MM, IND, L, plan=plan)
        torch.cuda.synchronize()
        assert_one_gap_equal(got, ref, name)


def edge_landing_bucket(rng, B, K, D, dev):
    """Target-longer problems whose best path runs along the suffix band's
    edge into the gap landing: q = A + C, t = A + gap + C + Y with Y of
    kband random bases, so the walk takes kband DOWN steps from the end,
    then C on the edge diagonal, then the gap from the edge cell, whose
    insertion term is the newest upperMax entry its suffix row reads."""
    qs, ts, kbs = [], [], []
    for _ in range(B):
        kb = int(rng.integers(K // 2, K))
        a, c = (rng.integers(0, 4, n).astype(np.int8)
                for n in rng.integers(D // 4, D // 2 - 1, 2))
        g = rng.integers(0, 4, int(rng.integers(300, 600))).astype(np.int8)
        y = rng.integers(0, 4, kb).astype(np.int8)
        qs.append(np.concatenate([a, c]))
        ts.append(np.concatenate([a, g, c, y]))
        kbs.append(kb)
    packed = og.pack_one_gap_bucket(qs, ts, K, D)
    return [torch.from_numpy(x).to(dev)
            for x in list(packed) + [np.asarray(kbs, np.int32)]]


def one_gap_patched(tmp_path, name, patches):
    """lra_one_gap_traced of a copy of csrc/one_gap.cu with each (old,
    new) of patches applied, built with nvcc into tmp_path."""
    text = open(os.path.join(_ext.SRC_DIR, "one_gap.cu")).read()
    for old, new in patches:
        assert old in text
        text = text.replace(old, new, 1)
    src = tmp_path / f"{name}.cu"
    src.write_text(text)
    so = tmp_path / f"lib{name}.so"
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).lra_one_gap_traced
    fn.restype = ctypes.c_int
    fn.argtypes = og._ONE_GAP_ARGS + [ctypes.c_void_p]
    return fn


@pytest.mark.cuda
def test_one_gap_overlap_lag_is_tight(cuda_device, tmp_path):
    """The suffix warp waits for the prefix rows whose gap-table entries
    it reads (csrc/one_gap.cu's `lag`).  With the prefix warp slowed down
    (a sleep a row, so that the suffix warp always runs at its lag), the
    kernel still equals its twin; built also to wait one row short of the
    insertion terms' entries (two short of the kept wait, which also
    covers the border-b' seed's entry, one further, whose value reaches no
    output), it differs from the twin on target-longer problems with
    D >> K that land the gap from the band edge."""
    K, D, B = 16, 256, 8
    args = edge_landing_bucket(np.random.default_rng(9), B, K, D,
                               cuda_device)
    L = 2 * (D + K) + 8
    ref = og.one_gap_traced_plain(*args, K, D, M, MM, IND, L)
    assert int((ref[0] == og.GAPDOWN).sum()) == B
    plan = og.one_gap_plan(K, D, B, _ext.sm_count(0))
    assert plan["WPP"] > 1
    assert_one_gap_equal(og.one_gap_traced(*args, K, D, M, MM, IND, L), ref,
                         "the source as it stands")
    slow = ("    const int tj = ts[min(j - 1, HP - 1)];\n",
            "    __nanosleep(2000);\n    const int tj = ts[min(j - 1, HP - 1)];\n")
    short = ("lag = isA ? tLow + 1 : ubidx;",
             "lag = isA ? tLow + 1 : ubidx - 2;")

    def run(fn):
        out = [torch.empty((B, L), dtype=torch.int8, device=cuda_device),
               torch.empty(B, dtype=torch.int32, device=cuda_device),
               torch.empty(B, dtype=torch.float32, device=cuda_device)]
        scratch = torch.empty(max(1, plan["scratch"]), dtype=torch.uint8,
                              device=cuda_device)
        rc = fn(*[x.data_ptr() for x in args], scratch.data_ptr(),
                *[x.data_ptr() for x in out], B, K, D, M, MM, IND, L,
                *[plan[k] for k in og._OG_PLAN_KEYS],
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        torch.cuda.synchronize()
        return out

    assert_one_gap_equal(run(one_gap_patched(tmp_path, "slow", [slow])),
                         ref, "the prefix warp slowed")
    got = run(one_gap_patched(tmp_path, "short", [slow, short]))
    assert not (torch.equal(got[0], ref[0]) and
                torch.equal(got[2].view(torch.int32),
                            ref[2].view(torch.int32)))


def chain_mask_batch(rng, B, N, dev):
    """Scores with many ties (small integers), backpointers to earlier
    rows or -1, and a valid prefix per problem."""
    V = rng.integers(-20, 60, (B, N)).astype(np.float32)
    bp = np.array([[int(rng.integers(-1, i)) if i else -1 for i in range(N)]
                   for _ in range(B)], np.int32)
    valid = np.arange(N)[None, :] < rng.integers(1, N + 1, B)[:, None]
    V[0, :] = -5.0                       # no positive score: empty chain
    return [torch.from_numpy(a).to(dev) for a in (V, bp, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,kind", [
    (8, 64, "ties"), (4, 4096, "ties"), (13, 64, "edges"),
    (1056, 64, "edges"), (13, 1024, "edges"), (13, 2048, "edges"),
    (5, 8192, "edges")])
def test_chain_mask_kernel_matches_plain(cuda_device, B, N, kind):
    """K3 on tie-dense scores, and on sim.mask_problems' edges (no valid
    row, vmax < 0, vmax = 0, ties for vmax, a chain of all N rows) at
    both tiers and B across the warp tier's 8 problems a block, through
    the wrapper and with every plan forced."""
    rng = np.random.default_rng(N)
    args = (chain_mask_batch(rng, B, N, cuda_device) if kind == "ties"
            else [torch.from_numpy(a).to(cuda_device)
                  for a in mask_problems(rng, B, N)])
    ref = sb.chain_mask_from_scores_plain(*args)
    runs = [sb.chain_mask_from_scores(*args)] + \
        [sb._chain_mask_from_scores_cuda(*args, plan=plan)
         for _, plan in sb.mask_plan_variants(N)]
    torch.cuda.synchronize()
    for got in runs:
        assert torch.equal(got[0].view(torch.int32),
                           ref[0].view(torch.int32))
        assert torch.equal(got[1], ref[1])
    assert bool((ref[1][1:] != 0).any())


def windowed_batch(rng, sizes, N, kind, dev):
    """K7's 17 arguments at the driver's padding: contig-like problems of
    the given sizes, the repeat-dense FAR-sentinel instance, or tie-dense
    problems of (roots, collectors)."""
    if kind == "tie":
        plist = [driver.ChainProblem(*tie_dense_chain_arrays(rng, *n))
                 for n in sizes]
    else:
        plist = [driver.ChainProblem(*contig_chain_arrays(
            rng, n, kind == "repeat")) for n in sizes]
    B = len(plist)
    arrays = driver.pad_problems(plist, B, N) + \
        driver.pad_far_schedules(plist, B, N)
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,N,W,kind", [
    ((8193, 5000), 16384, 4096, "contig"), ((9000,), 16384, 16384, "contig"),
    ((3000, 2000, 100, 1), 8192, 4096, "contig"), ((0,), 1664, 64, "repeat"),
    ((8200,), 8256, 4096, "contig"), ((3000,), 3072, 128, "contig"),
    ((5000, 2000), 5120, 256, "contig"),
    ((9000, 4000, 6000), 9216, 4096, "contig"),
    (((2000, 3000),), 5056, 1024, "tie"),
    (((700, 500), (300, 400)), 1280, 256, "tie")])
def test_windowed_kernel_matches_plain(cuda_device, sizes, N, W, kind):
    """K7 at driver-padded shapes, up to W = 16384; a block count that is
    no multiple of the cluster (N = 8256: 129 blocks), windows of 2 and
    4 blocks (fewer than the cluster's CTAs), three clusters (B = 3); an
    instance where the far term wins (FAR1/FAR2 sentinels in bp); and
    tie-dense instances whose first-index and lane ties cross CTAs."""
    args = windowed_batch(np.random.default_rng(N + W), sizes, N, kind,
                          cuda_device)
    key = from_options(preset("contig")).static_key()
    got = sw.chain_scores_windowed(*args, key, L=64, W=W)
    ref = sw.chain_scores_windowed_plain(*args, key, L=64, W=W)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert bool((ref[1] >= 0).any())
    if kind != "contig":
        assert bool((ref[1] < -1).any())


@pytest.mark.cuda
def test_windowed_cluster_fits(cuda_device):
    """The kernel's cluster (CLUSTER CTAs per problem) fits on the card at
    every window the driver uses."""
    for W in (64, 4096, 16384):
        info = sw.cluster_info(W)
        assert info["C"] == sw.CLUSTER and info["max_active_clusters"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,kind,hand", [
    (8, 64, "invalid", False), (5, 256, "unsorted", False),
    (4, 512, "tie", False), (3, 512, "one_lane", False),
    (2, 1024, "both_lanes", False), (4, 256, "both_lanes", True),
    (1, 9472, "invalid", False)])
def test_chain_scores_kernel_matches_plain(cuda_device, B, N, kind, hand):
    """K8 against its twin: invalid rows (bp and lane emitted), unsorted
    fragments, tie-dense problems, one lane and both, a zero-slope piece
    (K8 must follow pwl_jnp's formula there, not K2's effective pieces),
    and N = 9472, past K2's largest bucket (8192 rows): the CTA tier with
    its lists in shared memory, which holds them up to N = 9536 (tier 2,
    the lists in device scratch, beyond)."""
    gp = from_options(preset("ccs"))
    pwl = ((*zero_slope_piece(gp.slope, gp.inter), gp.ceiling1, gp.ceiling2)
           if hand else (gp.slope, gp.inter, gp.ceiling1, gp.ceiling2))
    slope, inter = (torch.from_numpy(a).to(cuda_device) for a in pwl[:2])
    args = [torch.from_numpy(a).to(cuda_device) for a in
            scan_bucket(np.random.default_rng(N + B), B, N, kind)]
    got = sdp.chain_scores(*args, slope, inter, *pwl[2:])
    ref = sdp.chain_scores_plain(*args, slope, inter, *pwl[2:])
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert bool((ref[1] >= 0).any())
    if N == 9472:
        assert sdp.scan_plan(N)["tier"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,kind,pwl", [
    (5, 1, "unsorted", "preset"), (7, 63, "unsorted", "preset"),
    (4, 100, "unsorted", "zero_slope"), (3, 512, "big_scores", "preset"),
    (3, 512, "both_lanes", "negative"), (2, 8192, "unsorted", "negative"),
    (1, 9472, "big_scores", "preset"), (1, 9600, "invalid", "preset"),
    (3, 64, "big_scores", "negative")])
def test_chain_scores_kernel_every_tier(cuda_device, B, N, kind, pwl):
    """K8 against its twin with every plan of sdp.scan_plan_variants (the
    warp tier, the CTA tier, tier 2 with the lists in device scratch):
    N off the blocks of 64 (1, 63, 100, 9472; 9600 past tier 1's shared
    memory), unsorted fragments, a
    zero-slope piece, a piece of negative penalty (no pruning), and
    scores near 2^25 on fragments that are predecessors on both lanes at
    once (the lane from the sums)."""
    gp = from_options(preset("ccs"))
    make = {"preset": lambda s, i: (s, i), "zero_slope": zero_slope_piece,
            "negative": negative_piece}[pwl]
    slope, inter = (torch.from_numpy(np.asarray(a)).to(cuda_device)
                    for a in make(gp.slope, gp.inter))
    args = [torch.from_numpy(a).to(cuda_device) for a in
            scan_bucket(np.random.default_rng(N + B), B, N, kind)]
    ref = sdp.chain_scores_plain(*args, slope, inter, gp.ceiling1,
                                 gp.ceiling2)
    for name, plan in sdp.scan_plan_variants(N):
        got = sdp._chain_scores_cuda(*args, slope, inter, gp.ceiling1,
                                     gp.ceiling2, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32),
                           ref[0].view(torch.int32)), name
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]), \
            name
    if N > 1:
        assert bool((ref[1] >= 0).any())


def arrows_batch(rng, B, S, K, dev):
    """gap_batch with its first rows at the edges: qlen 0, tlen 0, and
    |qlen - tlen| > K both ways (the score's wrapped and clamped cell)."""
    q, t, qlen, tlen, kb = gap_batch(rng, B, S, K, dev)
    edges = [(0, min(S, 5)), (min(S, 5), 0), (S, max(1, S - K - 3)),
             (min(3, S), S)]
    for b, (ql, tl) in enumerate(edges[:B]):
        qlen[b], tlen[b] = ql, tl
    return q, t, qlen, tlen, kb


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K,per_problem", [
    (16, 64, 10, False), (16, 64, 10, True), (64, 16, 30, True),
    (8, 200, 4, True), (4, 128, 100, False), (2, 64, 600, True)])
def test_banded_global_kernel_matches_plain(cuda_device, B, S, K,
                                            per_problem):
    """K9 against its twin: score bit for bit and the full arrow plane,
    kband None and per problem, the edge rows of arrows_batch, and bands
    past one CTA's 1024 threads (K = 600)."""
    q, t, qlen, tlen, kb = arrows_batch(np.random.default_rng(S + K), B, S,
                                        K, cuda_device)
    kb = kb if per_problem else None
    got = ak.banded_global_kernel(q, t, qlen, tlen, K, M, MM, IND, kband=kb)
    kbf = kb if per_problem else torch.full_like(qlen, K)
    ref = ak.banded_global_kernel_plain(q, t, qlen, tlen, K, M, MM, IND,
                                        kbf)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K", [
    (300, 16, 4), (2000, 16, 30), (64, 512, 30), (200, 40, 100),
    (6, 24, 600), (5, 12, 1100)])
@pytest.mark.parametrize("per_problem", [False, True])
def test_banded_global_kernel_every_tier(cuda_device, B, S, K,
                                         per_problem):
    """K9 against its twin with every plan of ak.arrows_plan_variants:
    K4's warp rows at CPT 2 (K = 4, 30), CPT 9 (K = 100) and WP = 5 (K =
    600), one problem a block and a full bucket's, the CTA tier (K =
    1100); planes staged in shared memory, and at S = 512 with 8 problems
    a block written row by row; kband None and per problem, edge rows,
    and per problem also kband past K, a negative kband and qlen far
    past the band (the kernel clamps both)."""
    q, t, qlen, tlen, kb = arrows_batch(np.random.default_rng(S + K), B, S,
                                        K, cuda_device)
    kbf = kb if per_problem else torch.full_like(qlen, K)
    if per_problem:
        kbf[-1], kbf[-2] = K + 7, -3
        qlen[-3] = S + 3 * K + 5
    ref = ak.banded_global_kernel_plain(q, t, qlen, tlen, K, M, MM, IND,
                                        kbf)
    for name, plan in ak.arrows_plan_variants(K):
        got = ak._arrows_cuda(q, t, qlen, tlen, kbf, K, M, MM, IND,
                              plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32),
                           ref[0].view(torch.int32)), name
        assert torch.equal(got[1], ref[1]), name
    if K == 30 and S == 512:
        full = ak.arrows_plan(K, 1 << 20)
        assert ak.arrows_launch(full, K, S)[0] == 0


@pytest.mark.cuda
def test_combined_device_step_on_repeated_mesh(cuda_device):
    """combined_device_step on a mesh of [cuda:0] * 2 (dryrun_multichip's
    shapes, B = 4) == K2 and K9 called on the whole batch, with each
    kernel launched once a shard."""
    m = mesh.make_mesh(devices=[cuda_device] * 2)
    chain, gap = mesh_step_inputs(4)
    gp = make_gap_params(4.0, 15.0, 1.5, 2000, 3000)
    step = mesh.combined_device_step(m, gp, 4, -3, -4, 30)
    _ext.reset_launches()
    got = step(*chain, *gap)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["chain_scores_blocked"] == 2
    assert _ext.LAUNCHES["banded_global_kernel"] == 2
    dc = [torch.from_numpy(a).to(cuda_device) for a in chain]
    dg = [torch.from_numpy(a).to(cuda_device) for a in gap]
    want = sb.chain_scores_blocked(*dc, gp.static_key()) + \
        ak.banded_global_kernel(*dg[:4], 30, 4, -3, -4, kband=dg[4])
    for g, w in zip(got, want):
        assert g.device == w.device and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
