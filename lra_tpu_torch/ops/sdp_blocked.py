"""Blocked chaining DP — the production SDP path (kernel K2) and the
on-device single-best traceback (K3).

Same semantics as lra_tpu's ops/sdp_blocked.py.  Fragments are processed
in blocks of L=64: for each block, one masked max of V[j] + w over every
earlier fragment (forward-diagonal lane 1 and back-diagonal lane 2),
then an L-step in-block triangle resolved in order.

``chain_scores_blocked`` launches the CUDA kernel (csrc/sdp_blocked.cu)
for CUDA tensors and runs ``chain_scores_blocked_plain`` for CPU
tensors.  The two agree bit for bit: every value is an f32 sum of the
same operands in the same order, the PWL piece is a multiply and an add
each rounded on its own, maxima are order-free, and every argmax takes
the first index.  ``chain_mask_from_scores`` is plain torch only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _ext
from .gapcost import NUMPWL, pwl_select_torch

NEG = -3.0e38    # float32(-3e38), the "no predecessor" value


def _pair_cost(d_i, d_j, pwl_key):
    return -pwl_select_torch((d_i - d_j).abs() + 1, pwl_key)


def chain_scores_blocked(qS, qE, tS, tE, score, lane1, lane2, valid,
                         pwl_key, L=64):
    """Batched DP; args [B, N] (int32 coordinates, f32 score, bool lanes
    and valid) with N % L == 0, fragments sorted by qS.

    Returns (V[B,N] f32, bp[B,N] int32, bplane[B,N] int32)."""
    if qS.device.type == "cuda":
        return _chain_scores_blocked_cuda(qS, qE, tS, tE, score, lane1,
                                          lane2, valid, pwl_key, L)
    return chain_scores_blocked_plain(qS, qE, tS, tE, score, lane1, lane2,
                                      valid, pwl_key, L)


def chain_scores_blocked_plain(qS, qE, tS, tE, score, lane1, lane2, valid,
                               pwl_key, L=64):
    """Plain torch version (any device): a python loop over blocks and
    over the L rows of each block's triangle."""
    B, N = qS.shape
    nb = N // L
    dev = qS.device
    d1s = tS - qS
    d1e = tE - qE
    d2s = tE + qS
    d2e = tS + qE
    negf = torch.tensor(NEG, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    two = torch.full((), 2, dtype=torch.int32, device=dev)
    V = torch.full((B, N), NEG, dtype=torch.float32, device=dev)
    out_v, out_bp, out_lane = [], [], []
    for b in range(nb):
        b0 = b * L
        sl = slice(b0, b0 + L)
        bqS, bqE, btS, btE = qS[:, sl], qE[:, sl], tS[:, sl], tE[:, sl]
        bsc, bl1, bl2, bva = score[:, sl], lane1[:, sl], lane2[:, sl], \
            valid[:, sl]
        bd1s, bd2s = d1s[:, sl], d2s[:, sl]

        # cross-block candidates [B, L, N] against V (pre-block)
        vis = (qE[:, None, :] <= bqS[:, :, None]) & valid[:, None, :]
        m1 = vis & (tE[:, None, :] <= btS[:, :, None]) & \
            lane1[:, None, :] & bl1[:, :, None]
        m2 = vis & (tS[:, None, :] >= btE[:, :, None]) & \
            lane2[:, None, :] & bl2[:, :, None]
        w1 = _pair_cost(bd1s[:, :, None], d1e[:, None, :], pwl_key)
        w2 = _pair_cost(bd2s[:, :, None], d2e[:, None, :], pwl_key)
        c1 = torch.where(m1, V[:, None, :] + w1, negf)
        c2 = torch.where(m2, V[:, None, :] + w2, negf)
        cand = torch.maximum(c1, c2)
        best_prev = cand.amax(dim=2)                           # [B, L]
        arg_prev = cand.argmax(dim=2)                          # first max
        lane_prev = torch.where(
            c2.gather(2, arg_prev[:, :, None])[:, :, 0]
            > c1.gather(2, arg_prev[:, :, None])[:, :, 0], two, one)
        arg_prev = arg_prev.to(torch.int32)

        # within-block triangle: weights [B, L, L] (j pred of i)
        tvis = bqE[:, None, :] <= bqS[:, :, None]
        tm1 = tvis & (btE[:, None, :] <= btS[:, :, None]) & \
            bl1[:, None, :] & bl1[:, :, None]
        tm2 = tvis & (btS[:, None, :] >= btE[:, :, None]) & \
            bl2[:, None, :] & bl2[:, :, None]
        tw1 = _pair_cost(bd1s[:, :, None], d1e[:, sl][:, None, :], pwl_key)
        tw2 = _pair_cost(bd2s[:, :, None], d2e[:, sl][:, None, :], pwl_key)
        tc1 = torch.where(tm1, tw1, negf)
        tc2 = torch.where(tm2, tw2, negf)
        tcand = torch.maximum(tc1, tc2)
        tlane = torch.where(tc2 > tc1, two, one)

        vloc = torch.full((B, L), NEG, dtype=torch.float32, device=dev)
        bp_rows, lane_rows = [], []
        for l in range(L):
            in_cand = torch.where(bva, tcand[:, l, :] + vloc, negf)
            in_best = in_cand.amax(dim=1)
            in_arg = in_cand.argmax(dim=1)
            use_in = in_best > best_prev[:, l]
            best = torch.maximum(in_best, best_prev[:, l])
            take = best > 0.0
            v_l = bsc[:, l] + torch.where(take, best, torch.zeros_like(best))
            v_l = torch.where(bva[:, l], v_l, negf)
            bp_l = torch.where(
                take, torch.where(use_in, b0 + in_arg.to(torch.int32),
                                  arg_prev[:, l]),
                -one)
            lane_l = torch.where(
                take, torch.where(use_in,
                                  tlane[:, l, :].gather(
                                      1, in_arg[:, None])[:, 0],
                                  lane_prev[:, l]),
                0 * one)
            vloc[:, l] = v_l
            bp_rows.append(bp_l)
            lane_rows.append(lane_l)
        V[:, sl] = vloc
        out_v.append(vloc)
        out_bp.append(torch.stack(bp_rows, 1))
        out_lane.append(torch.stack(lane_rows, 1))
    return (torch.cat(out_v, 1), torch.cat(out_bp, 1).to(torch.int32),
            torch.cat(out_lane, 1).to(torch.int32))


def _pwl_host_params(pwl_key):
    """The kernel's PWL constants: slope[24], inter[24], ceiling1,
    ceiling2 as one f32 host array."""
    slope, inter, c1, c2 = pwl_key
    vals = [float(x) for x in slope] + [float(x) for x in inter] + \
        [float(c1), float(c2)]
    if len(vals) != 2 * (NUMPWL - 1) + 2:
        raise ValueError("pwl_key: expected 24 slopes and 24 intercepts")
    return (ctypes.c_float * len(vals))(*vals)


_SDP_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]


def _chain_scores_blocked_cuda(qS, qE, tS, tE, score, lane1, lane2, valid,
                               pwl_key, L):
    B, N = qS.shape
    if L != 64 or N % 64 or N > 8192:
        raise ValueError(f"chain_scores_blocked kernel: needs L=64 and "
                         f"N % 64 == 0, N <= 8192 (got L={L}, N={N})")
    for name, t in (("qS", qS), ("qE", qE), ("tS", tS), ("tE", tE)):
        _ext.check(name, t, torch.int32, (B, N))
    _ext.check("score", score, torch.float32, (B, N))
    for name, t in (("lane1", lane1), ("lane2", lane2), ("valid", valid)):
        _ext.check(name, t, torch.bool, (B, N))
    V = torch.empty((B, N), dtype=torch.float32, device=qS.device)
    bp = torch.empty((B, N), dtype=torch.int32, device=qS.device)
    lane = torch.empty((B, N), dtype=torch.int32, device=qS.device)
    if B == 0:
        return V, bp, lane
    p = _ext.ptr
    pwl = _pwl_host_params(pwl_key)     # host array, alive for the call
    _ext.launch("chain_scores_blocked", "sdp_blocked",
                "lra_chain_scores_blocked", _SDP_ARGS,
                p(qS), p(qE), p(tS), p(tE), p(score), p(lane1), p(lane2),
                p(valid), p(V), p(bp), p(lane), ctypes.addressof(pwl), B, N)
    return V, bp, lane


def chain_mask_from_scores(V, bp, valid):
    """Device-side single-best traceback (plain torch; K3): walk bp from
    argmax(V) and return (vmax f32[B], maskbits int32[B, N//32]) — the
    chain as a bitmask.  A backpointer always targets a strictly
    earlier q-sorted row, so N steps cover any chain.  Requires
    N % 32 == 0."""
    B, N = V.shape
    dev = V.device
    Vm = torch.where(valid, V, torch.tensor(NEG, dtype=torch.float32,
                                            device=dev))
    vmax = Vm.amax(dim=1)
    start = Vm.argmax(dim=1)
    cur = torch.where(vmax > 0.0, start, torch.full_like(start, -1))
    rows = torch.arange(B, device=dev)
    bp64 = bp.to(torch.int64)
    mask = torch.zeros((B, N), dtype=torch.bool, device=dev)
    for _ in range(N):
        idx = cur.clamp(min=0)
        mask[rows, idx] = mask[rows, idx] | (cur >= 0)
        cur = torch.where(cur >= 0, bp64[rows, idx], torch.full_like(cur, -1))
    weights = torch.ones(32, dtype=torch.int64, device=dev) << \
        torch.arange(32, dtype=torch.int64, device=dev)
    bits = (mask.reshape(B, N // 32, 32).to(torch.int64)
            * weights[None, None, :]).sum(dim=2)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return vmax, bits.to(torch.int32)
