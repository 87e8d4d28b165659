"""The launch plans of K8 (ops/sdp.py:scan_plan) and K9
(ops/affine_kernel.py:arrows_plan, arrows_launch) on the CPU, K8's
pruning rule mirrored in numpy (scan_prune_np), and the two inputs K8's
kernel must get right beyond K2's: scores near 2^25, where V + w1 and
V + w2 round equal although w2 > w1, and a piece of negative penalty
(w > 0, no pruning).  The port's chain_scores_plain == lra_tpu's
ops/sdp.py:chain_scores on those inputs (exact: f32 bit for bit, bp and
lane on every row)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lra_tpu.ops import sdp as jsdp
from lra_tpu_torch import preset
from lra_tpu_torch.ops import affine_kernel as ak
from lra_tpu_torch.ops import sdp
from lra_tpu_torch.ops.gapcost import from_options, pwl_torch
from lra_tpu_torch.sim import negative_piece, scan_bucket, zero_slope_piece

torch.set_num_threads(2)
SMEM_MAX = 232448
STATIC = 4048       # the CTA tier's static tables (ptxas)
TRI = 64 * 16 + 64 * 8 + 4 * (64 * 63 // 2) + 8 * 64
STAGED = 2 * 64 * 16 + 2 * 64 * 4 + 2 * 64 * 4 + 16
WIDEST_K = 6836     # the widest band whose rows fit one CTA's shared memory


def lists(Np):
    return 21 * Np + 8 * (Np // 64 + 1)


@pytest.mark.parametrize("lo,hi", [(1, 64), (65, 9536), (9537, 65536)])
def test_scan_plan_covers_every_n(lo, hi):
    """Every N of the range has a tier: the warp tier up to 64 rows, the
    CTA tier while its lists fit in shared memory, tier 2 (lists in
    device scratch) beyond; each plan's bytes as csrc/sdp_blocked.cu
    computes them."""
    for N in range(lo, hi + 1):
        p = sdp.scan_plan(N)
        Np = -(-N // 64) * 64
        assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= 1024
        assert p["smem"] <= SMEM_MAX
        if N <= 64:
            assert p == {"tier": 0, "threads": 32, "smem": TRI,
                         "scratch": 0}
        elif 2 * TRI + 2 * STAGED + lists(Np) <= SMEM_MAX - STATIC:
            assert p["tier"] == 1 and p["scratch"] == 0
            assert p["smem"] == 2 * TRI + 2 * STAGED + lists(Np)
            assert p["threads"] == min(1024, max(128, Np // 2))
        else:
            assert p["tier"] == 2 and p["threads"] == 1024
            assert p["smem"] == 2 * TRI + 2 * STAGED
            assert p["scratch"] % 16 == 0 and p["scratch"] >= lists(Np)
    assert sdp.scan_plan(9536)["tier"] == 1
    assert sdp.scan_plan(9537)["tier"] == 2


@pytest.mark.parametrize("N", [0, -1, sdp.SCAN_MAX_N + 1, 1 << 20])
def test_scan_plan_refuses(N):
    with pytest.raises(ValueError):
        sdp.scan_plan(N)


def test_scan_plan_forced_tiers():
    """Tier 2 takes any N above 64, tier 1 only where its lists fit, and
    neither takes N <= 64; scan_plan_variants lists each tier once."""
    for N in (65, 100, 512, 8192, 9536):
        assert sdp.scan_plan(N, tier=2)["tier"] == 2
        assert sdp.scan_plan(N, tier=1)["tier"] == 1
    with pytest.raises(ValueError):
        sdp.scan_plan(9537, tier=1)
    with pytest.raises(ValueError):
        sdp.scan_plan(64, tier=2)
    assert [p["tier"] for _, p in sdp.scan_plan_variants(63)] == [0]
    assert [p["tier"] for _, p in sdp.scan_plan_variants(512)] == [1, 2]
    assert [p["tier"] for _, p in sdp.scan_plan_variants(9600)] == [2]


@pytest.mark.parametrize("lo,hi", [(0, 143), (144, 1023),
                                   (1024, WIDEST_K)])
def test_arrows_plan_covers_every_k(lo, hi):
    """K9's plan for every K up to the widest band the wrapper takes: K4's
    warp rows (global_plan's CPT, WP and problems per block) up to K =
    1023, the CTA tier beyond; a launch's staged planes within the
    plan's stage bytes, else none."""
    for K in range(lo, hi + 1):
        band = 2 * K + 1
        for B in (1, 1 << 16):
            p = ak.arrows_plan(K, B)
            if K <= 1023:
                g = ak.global_plan(K, B)
                assert p["tier"] == "rows"
                assert (p["CPT"], p["WP"], p["PPC"]) == \
                    (g["CPT"], g["WP"], g["PPC"])
                assert band <= 32 * p["CPT"] * p["WP"]
                assert p["threads"] == 32 * p["WP"] * p["PPC"] <= 256
            else:
                assert p["tier"] == "cta" and p["CPT"] == 0
                assert p["threads"] == min(1024, 32 * -(-band // 32))
        for T in (0, 16, 512):
            sp, smem = ak.arrows_launch(p, K, T)
            assert smem <= SMEM_MAX
            if p["tier"] == "cta":
                assert sp == 0 and smem == 16 * band + 16 * -(-band // 16)
                continue
            xch = 32 * p["WP"] if p["WP"] > 1 else 0
            assert smem == p["PPC"] * (xch + sp + 16)
            assert sp % 16 == 0
            if sp:
                assert sp >= (T + 1) * band + 15 and smem <= p["stage"]
            else:
                need = -(-((T + 1) * band + 15) // 16) * 16
                assert p["PPC"] * (xch + need + 16) > p["stage"]


def test_arrows_plan_refuses_past_widest_band():
    ak.arrows_plan(WIDEST_K, 1)
    for K in (WIDEST_K + 1, -1):
        with pytest.raises(ValueError):
            ak.arrows_plan(K, 1)
    # the mesh phase's bucket stages every plane in shared memory
    p = ak.arrows_plan(30, 65536)
    assert p["PPC"] == 8 and ak.arrows_launch(p, 30, 16)[0] > 0
    assert ak.arrows_launch(p, 30, 512)[0] == 0


@pytest.mark.parametrize("name", ["ccs", "ont", "clr", "contig"])
def test_scan_prune_presets(name):
    """The four presets' penalties are >= 0 everywhere: K8 prunes."""
    gp = from_options(preset(name))
    assert sdp.scan_prune_np(gp.slope, gp.inter, gp.ceiling1, gp.ceiling2)


@pytest.mark.parametrize("piece,want", [("negative", False),
                                        ("zero_slope", True)])
def test_scan_prune_hand_pieces(piece, want):
    """A piece of negative value turns pruning off; a zero-slope piece of
    positive intercept does not.  The mirror agrees with the penalty
    itself on every x of the pieces' ranges up to 120000."""
    gp = from_options(preset("ccs"))
    make = negative_piece if piece == "negative" else zero_slope_piece
    slope, inter = make(gp.slope, gp.inter)
    got = sdp.scan_prune_np(slope, inter, gp.ceiling1, gp.ceiling2)
    assert got is want
    xs = torch.arange(3, 120001, dtype=torch.int32)
    pen = pwl_torch(xs, slope, inter, gp.ceiling1, gp.ceiling2)
    assert bool((pen >= 0).all()) is want


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def lane_traps(arrs, bp, lane, gp):
    """Rows whose predecessor is one on both lanes with w2 > w1 while the
    lane taken is 1: V + w1 and V + w2 rounded equal there."""
    qS, qE, tS, tE = (a.astype(np.int64) for a in arrs[:4])
    bp, lane = np.asarray(bp), np.asarray(lane)
    n = 0
    for b, i in zip(*np.nonzero(bp >= 0)):
        j = bp[b, i]
        seen = qE[b, j] <= qS[b, i]
        m1 = seen and tE[b, j] <= tS[b, i]
        m2 = seen and tS[b, j] >= tE[b, i]
        x = [abs((tS[b, i] - qS[b, i]) - (tE[b, j] - qE[b, j])) + 1,
             abs((tE[b, i] + qS[b, i]) - (tS[b, j] + qE[b, j])) + 1]
        w = -pwl_torch(torch.tensor(x, dtype=torch.int32), gp.slope,
                       gp.inter, gp.ceiling1, gp.ceiling2).numpy()
        n += bool(m1 and m2 and w[1] > w[0] and lane[b, i] == 1)
    return n


@pytest.mark.parametrize("case", ["big_scores", "negative_piece"])
def test_chain_scores_plain_matches_jax_new_cases(case):
    """B=3, N=64: scores near 2^25 on fragments that are predecessors on
    both lanes at once (the lane comes from the sums: some rows take lane
    1 where w2 > w1), and a piece of negative penalty (some row gains on
    its edge: V > score + V[bp])."""
    gp = from_options(preset("ccs"))
    slope, inter = (negative_piece(gp.slope, gp.inter)
                    if case == "negative_piece" else (gp.slope, gp.inter))
    kind = "big_scores" if case == "big_scores" else "both_lanes"
    arrs = scan_bucket(np.random.default_rng(11), 3, 64, kind)
    want = jsdp.chain_scores(*[jnp.asarray(a) for a in arrs],
                             jnp.asarray(slope), jnp.asarray(inter),
                             gp.ceiling1, gp.ceiling2)
    got = sdp.chain_scores(*[torch.from_numpy(a) for a in arrs], slope,
                           inter, gp.ceiling1, gp.ceiling2)
    for name, w, g in zip(("V", "bp", "lane"), want, got):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(bits(g.numpy()), bits(w),
                                      err_msg=name)
    V, bp, lane = (np.asarray(x) for x in want)
    assert (bp >= 0).any()
    if case == "big_scores":
        assert lane_traps(arrs, bp, lane, gp) > 0
    else:
        take = bp >= 0
        prev = np.take_along_axis(V, np.maximum(bp, 0), axis=1)
        assert (V[take] > arrs[4][take] + prev[take]).any()
