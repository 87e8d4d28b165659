"""Large-N chaining DP (kernel K7): banded near window + saturated far
term + in-block max-plus closure.

Same semantics as lra_tpu's ops/sdp_windowed.py, for problems of more
than 8192 fragments (the CONTIG preset at scale), where the blocked
kernel's O(N^2) pairs are out of reach.  The predecessors of fragment i
(q-sorted rank r_i) split into:

* NEAR: the previous W fragments by q-rank, evaluated exactly with the
  same masked pairwise costs as the blocked kernel;
* FAR: everything earlier, charged the PWL's terminal plateau
  ``ceiling2`` (exact for saturated pairs, an underestimate otherwise),
  through prefix maxima over t-sorted permutations (t-dominance) of the
  fragments whose qE is <= the qS of the refresh round's first block
  (q-visibility).  The prefix maxima are rebuilt once per round of
  R = W/(2L) blocks (``_refresh_blocks``), so every fragment finalized
  since the refresh lies inside the near window.
* IN-BLOCK: the L rows of a block among themselves, as a longest path
  over the strict row-order DAG: log2(L) max-plus squarings of the
  [L, L] edge matrix, then one vector product; bp/lane are recovered in
  one exact pass against the final values.

Backpointers to far predecessors are the sentinels FAR1/FAR2, which the
host resolves (``resolve_far_np``) from V and the schedule.

``chain_scores_windowed`` launches the CUDA kernel
(csrc/sdp_windowed.cu: one thread-block cluster of ``CLUSTER`` CTAs per
problem, the near window split across the cluster) for CUDA tensors and
runs
``chain_scores_windowed_plain`` for CPU tensors.  Both follow the
reference step for step: every f32 sum has the same operands in the
same grouping (the closure's squaring tree included), maxima are
order-free and every argmax takes the first index, so V, bp and lane
agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _ext
from .gapcost import pwl_select_torch
from .sdp_blocked import _pwl_host_params

NEG = -3.0e38    # float32(-3e38), the "no predecessor" value
FAR1 = -2   # bp sentinel: far predecessor via the forward (lane-1) term
FAR2 = -3   # bp sentinel: far predecessor via the back-diagonal term


def _pair_cost(d_i, d_j, pwl_key):
    return -pwl_select_torch((d_i - d_j).abs() + 1, pwl_key)


def _refresh_blocks(L: int, W: int, N: int) -> int:
    """Far-structure refresh cadence in blocks: R = W/(2L), halved until
    it divides the block count N/L.  The kernel, its plain twin and
    resolve_far_np all derive R from this one function."""
    nb = max(1, N // L)
    R = max(1, W // (2 * L))
    while nb % R:
        R //= 2
    return R


def far_schedule(qS, qE, tS, tE, lane1, lane2, valid, L):
    """Host precompute of the far-term structures for ONE problem
    (1-D numpy arrays, fragments sorted by qS).

    Returns dict of int32/bool arrays:
      perm1/perm2: q-rank indices sorted by tE asc / tS desc
      ok1/ok2:     lane&valid of the permuted fragments
      qer1/qer2:   qE-rank of the permuted fragments
      rank1/rank2: per-query prefix lengths (# j with tE_j <= tS_i /
                   # j with tS_j >= tE_i)
      ins_hi:      per-block insertion counts (# j with qE_j <= qS[b*L])
    """
    n = len(qS)
    nb = (n + L - 1) // L
    qe_rank = np.empty(n, np.int32)
    qe_order = np.argsort(qE, kind="stable")
    qe_rank[qe_order] = np.arange(n, dtype=np.int32)
    qE_sorted = qE[qe_order]

    perm1 = np.argsort(tE, kind="stable").astype(np.int32)
    perm2 = np.argsort(-tS, kind="stable").astype(np.int32)
    ok1 = (lane1 & valid)[perm1]
    ok2 = (lane2 & valid)[perm2]
    qer1 = qe_rank[perm1]
    qer2 = qe_rank[perm2]
    rank1 = np.searchsorted(tE[perm1], tS, side="right").astype(np.int32)
    ts_desc = -tS[perm2]
    rank2 = np.searchsorted(ts_desc, -tE, side="right").astype(np.int32)
    block_qs = qS[np.minimum(np.arange(nb) * L, n - 1)]
    ins_hi = np.searchsorted(qE_sorted, block_qs, side="right") \
        .astype(np.int32)
    return dict(perm1=perm1, perm2=perm2, ok1=ok1, ok2=ok2,
                qer1=qer1, qer2=qer2, rank1=rank1, rank2=rank2,
                ins_hi=ins_hi)


def resolve_far_np(i, qS, qE, tS, tE, V, lane1, lane2, valid, which,
                   L=64, W=4096, N=None):
    """Host resolution of a FAR1/FAR2 sentinel at q-rank i: the argmax the
    device's far term saw (its schedule: qE_j <= qS at the refresh-round
    start, t-dominance, lane), so the chain stays consistent with V.
    ``N`` is the PADDED fragment count the kernel ran with (defaults to
    len(qS) rounded up to a block) — it fixes the refresh cadence R."""
    if N is None:
        N = ((len(qS) + L - 1) // L) * L
    R = _refresh_blocks(L, W, N)
    b0 = (i // (L * R)) * (L * R)
    vis = valid & (qE <= qS[b0])
    if which == 1:
        vis = vis & lane1 & (tE <= tS[i])
    else:
        vis = vis & lane2 & (tS >= tE[i])
    if not vis.any():
        return -1
    cand = np.where(vis, V, -np.inf)
    return int(np.argmax(cand))


def chain_scores_windowed(qS, qE, tS, tE, score, lane1, lane2, valid,
                          perm1, perm2, ok1, ok2, qer1, qer2,
                          rank1, rank2, ins_hi, pwl_key, L=64, W=4096):
    """Batched large-N DP; fragment args [B, N] sorted by qS (int32
    coordinates, f32 score, bool lanes and valid), N % L == 0; schedule
    args from far_schedule, stacked [B, N] (ins_hi [B, N/L]).

    Returns (V[B,N] f32, bp[B,N] int32, bplane[B,N] int32) with bp using
    the FAR1/FAR2 sentinels for far predecessors."""
    args = (qS, qE, tS, tE, score, lane1, lane2, valid, perm1, perm2, ok1,
            ok2, qer1, qer2, rank1, rank2, ins_hi)
    if qS.device.type == "cuda":
        return _chain_scores_windowed_cuda(*args, pwl_key, L, W)
    return chain_scores_windowed_plain(*args, pwl_key, L, W)


def chain_scores_windowed_plain(qS, qE, tS, tE, score, lane1, lane2, valid,
                                perm1, perm2, ok1, ok2, qer1, qer2,
                                rank1, rank2, ins_hi, pwl_key, L=64,
                                W=4096):
    """Plain torch version (any device): a python loop over refresh
    rounds and their blocks, each block vectorised over [B, L, W]."""
    B, N = qS.shape
    nb = N // L
    dev = qS.device
    f32 = torch.float32
    c2 = float(pwl_key[3])
    negf = torch.tensor(NEG, dtype=f32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    two = torch.full((), 2, dtype=torch.int32, device=dev)
    d1s = tS - qS
    d1e = tE - qE
    d2s = tE + qS
    d2e = tS + qE

    # front-pad per-fragment arrays with W invalid rows so the near
    # window [b0-W, b0) is a fixed-length in-bounds slice
    def fpad(a, fill):
        return torch.cat([torch.full((B, W), fill, dtype=a.dtype,
                                     device=dev), a], dim=1)
    p_qE = fpad(qE, 2 ** 30)
    p_tS = fpad(tS, 0)
    p_tE = fpad(tE, 0)
    p_d1e = fpad(d1e, 0)
    p_d2e = fpad(d2e, 0)
    p_l1 = fpad(lane1, False)
    p_l2 = fpad(lane2, False)
    p_valid = fpad(valid, False)
    # V with its W-row NEG front pad, updated in place block by block
    pV = torch.full((B, W + N), NEG, dtype=f32, device=dev)

    R = _refresh_blocks(L, W, N)
    ltri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev),
                      diagonal=-1)[None]                         # [1,l,j]
    eye = torch.where(torch.eye(L, dtype=torch.bool, device=dev)[None],
                      torch.zeros((), dtype=f32, device=dev), negf)
    n_sq = max(1, L.bit_length() - 1)                            # log2(L)
    perm1l, perm2l = perm1.long(), perm2.long()
    out_v, out_bp, out_lane = [], [], []
    for r in range(nb // R):
        # rebuild the far structures from values finalized before this
        # round; activation uses the round's FIRST block
        V = pV[:, W:]
        hi = ins_hi[:, r * R:r * R + 1]
        P1 = torch.where(ok1 & (qer1 < hi), V.gather(1, perm1l), negf) \
            .cummax(dim=1).values
        P2 = torch.where(ok2 & (qer2 < hi), V.gather(1, perm2l), negf) \
            .cummax(dim=1).values
        for b in range(r * R, (r + 1) * R):
            b0 = b * L
            sl = slice(b0, b0 + L)
            ws = slice(b0, b0 + W)          # padded coordinates
            bqS, bqE, btS, btE = qS[:, sl], qE[:, sl], tS[:, sl], tE[:, sl]
            bsc, bl1, bl2, bva = score[:, sl], lane1[:, sl], lane2[:, sl], \
                valid[:, sl]
            bd1s, bd2s = d1s[:, sl], d2s[:, sl]

            # --- near window: previous W fragments by q-rank, exact ---
            wV = pV[:, ws]
            vis = (p_qE[:, None, ws] <= bqS[:, :, None]) & \
                p_valid[:, None, ws]
            m1 = vis & (p_tE[:, None, ws] <= btS[:, :, None]) & \
                p_l1[:, None, ws] & bl1[:, :, None]
            m2 = vis & (p_tS[:, None, ws] >= btE[:, :, None]) & \
                p_l2[:, None, ws] & bl2[:, :, None]
            w1 = _pair_cost(bd1s[:, :, None], p_d1e[:, None, ws], pwl_key)
            w2 = _pair_cost(bd2s[:, :, None], p_d2e[:, None, ws], pwl_key)
            c1n = torch.where(m1, wV[:, None, :] + w1, negf)
            c2n = torch.where(m2, wV[:, None, :] + w2, negf)
            cand = torch.maximum(c1n, c2n)
            near_best = cand.amax(dim=2)                          # [B, L]
            near_arg = cand.argmax(dim=2)                         # first
            near_lane = torch.where(
                c2n.gather(2, near_arg[:, :, None])[:, :, 0]
                > c1n.gather(2, near_arg[:, :, None])[:, :, 0], two, one)
            near_idx = (b0 - W + near_arg).to(torch.int32)        # q-rank

            # --- far term: stale prefix maxima over t-sorted fragments ---
            r1 = rank1[:, sl]
            g1 = P1.gather(1, (r1 - 1).clamp(min=0).long())
            far1 = torch.where((r1 > 0) & bl1, g1 - c2, negf)
            r2 = rank2[:, sl]
            g2 = P2.gather(1, (r2 - 1).clamp(min=0).long())
            far2 = torch.where((r2 > 0) & bl2, g2 - c2, negf)

            # exact terms win ties against the far underestimate
            far_best = torch.maximum(far1, far2)
            far_first = far1 >= far2
            far_bp = torch.where(far_first, FAR1 * one, FAR2 * one)
            far_lane = torch.where(far_first, one, two)
            use_far = far_best > near_best
            best_prev = torch.maximum(near_best, far_best)
            arg_prev = torch.where(use_far, far_bp, near_idx)
            lane_prev = torch.where(use_far, far_lane, near_lane)

            # --- within-block triangle: max-plus closure ---
            tvis = bqE[:, None, :] <= bqS[:, :, None]
            tm1 = tvis & (btE[:, None, :] <= btS[:, :, None]) & \
                bl1[:, None, :] & bl1[:, :, None]
            tm2 = tvis & (btS[:, None, :] >= btE[:, :, None]) & \
                bl2[:, None, :] & bl2[:, :, None]
            tw1 = _pair_cost(bd1s[:, :, None], d1e[:, None, sl], pwl_key)
            tw2 = _pair_cost(bd2s[:, :, None], d2e[:, None, sl], pwl_key)
            tc1 = torch.where(tm1, tw1, negf)
            tc2 = torch.where(tm2, tw2, negf)
            tcand = torch.maximum(tc1, tc2)
            tlane = torch.where(tc2 > tc1, two, one)
            # only j < l is an in-block predecessor, and edges through or
            # out of invalid rows die
            edge_ok = ltri & bva[:, None, :] & bva[:, :, None]
            M = torch.where(edge_ok, tcand + bsc[:, :, None], negf)
            C = torch.maximum(M, eye)                             # I (+) M
            for _ in range(n_sq):
                C = (C[:, :, :, None] + C[:, None, :, :]).amax(dim=2)
            W0 = torch.where(bva, bsc + best_prev.clamp(min=0.0), negf)
            vfin = (W0[:, None, :] + C).amax(dim=2)               # [B, L]

            # exact bp/lane recovery with the sequential tie rules
            in_cand = torch.where(edge_ok, tcand + vfin[:, None, :], negf)
            in_best = in_cand.amax(dim=2)
            in_arg = in_cand.argmax(dim=2)
            use_in = in_best > best_prev
            best = torch.maximum(in_best, best_prev)
            take = best > 0.0
            vloc = bsc + torch.where(take, best, torch.zeros_like(best))
            vloc = torch.where(bva, vloc, negf)
            bploc = torch.where(
                take, torch.where(use_in, b0 + in_arg.to(torch.int32),
                                  arg_prev), -one)
            lane_sel = tlane.gather(2, in_arg[:, :, None])[:, :, 0]
            laneloc = torch.where(
                take, torch.where(use_in, lane_sel, lane_prev), 0 * one)
            pV[:, W + b0:W + b0 + L] = vloc
            out_v.append(vloc)
            out_bp.append(bploc)
            out_lane.append(laneloc)
    return (torch.cat(out_v, 1), torch.cat(out_bp, 1).to(torch.int32),
            torch.cat(out_lane, 1).to(torch.int32))


# CTAs per thread-block cluster, one cluster per problem
# (csrc/sdp_windowed.cu): the portable 8 ran the CONTIG paths' K7 inputs
# faster than the non-portable 16 on the H100 (chip_smoke.py times both;
# PERF.md)
CLUSTER = 8

# 17 inputs, 3 outputs, the P1/P2 scratch, the host PWL array; B, N, W,
# R, C
_WIN_ARGS = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 5


def cluster_info(W: int, C: int = None) -> dict:
    """The kernel's cluster at window W: C, how many such clusters fit on
    the card at once (cudaOccupancyMaxActiveClusters) and the dynamic
    shared memory of one CTA.  Raises if the card cannot hold one."""
    C = CLUSTER if C is None else C
    lib = _ext._lib("sdp_windowed")
    f = lib.lra_windowed_cluster_info
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_int)]
    active, dyn = ctypes.c_int(0), ctypes.c_int(0)
    rc = f(W, C, ctypes.byref(active), ctypes.byref(dyn))
    if rc != 0 or active.value < 1:
        raise RuntimeError(f"chain_scores_windowed: a cluster of {C} CTAs "
                           f"at W={W} cannot be launched ({rc}: "
                           f"{lib.lra_errstr(rc).decode()}, "
                           f"{active.value} active clusters)")
    return {"C": C, "max_active_clusters": active.value,
            "dyn_smem": dyn.value}


def _chain_scores_windowed_cuda(qS, qE, tS, tE, score, lane1, lane2, valid,
                                perm1, perm2, ok1, ok2, qer1, qer2, rank1,
                                rank2, ins_hi, pwl_key, L, W):
    B, N = qS.shape
    if L != 64 or N % L or W < 64 or W & (W - 1):
        raise ValueError(f"chain_scores_windowed kernel: needs L=64, "
                         f"N % 64 == 0 and W a power of two >= 64 (got "
                         f"L={L}, N={N}, W={W})")
    for name, t in (("qS", qS), ("qE", qE), ("tS", tS), ("tE", tE),
                    ("perm1", perm1), ("perm2", perm2), ("qer1", qer1),
                    ("qer2", qer2), ("rank1", rank1), ("rank2", rank2)):
        _ext.check(name, t, torch.int32, (B, N))
    _ext.check("score", score, torch.float32, (B, N))
    for name, t in (("lane1", lane1), ("lane2", lane2), ("valid", valid),
                    ("ok1", ok1), ("ok2", ok2)):
        _ext.check(name, t, torch.bool, (B, N))
    _ext.check("ins_hi", ins_hi, torch.int32, (B, N // L))
    dev = qS.device
    V = torch.empty((B, N), dtype=torch.float32, device=dev)
    bp = torch.empty((B, N), dtype=torch.int32, device=dev)
    lane = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0:
        return V, bp, lane
    # the far prefix maxima P1/P2, rebuilt by the kernel once per round
    scratch = torch.empty((2, B, N), dtype=torch.float32, device=dev)
    p = _ext.ptr
    pwl = _pwl_host_params(pwl_key)     # host array, alive for the call
    _ext.launch("chain_scores_windowed", "sdp_windowed",
                "lra_chain_scores_windowed", _WIN_ARGS,
                p(qS), p(qE), p(tS), p(tE), p(score), p(lane1), p(lane2),
                p(valid), p(perm1), p(perm2), p(ok1), p(ok2), p(qer1),
                p(qer2), p(rank1), p(rank2), p(ins_hi), p(V), p(bp),
                p(lane), p(scratch), ctypes.addressof(pwl), B, N, W,
                _refresh_blocks(L, W, N), CLUSTER)
    return V, bp, lane
