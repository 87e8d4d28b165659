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
the first index.  ``chain_mask_from_scores`` dispatches the same way, to
csrc/chain_mask.cu or to ``chain_mask_from_scores_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _ext
from .gapcost import NUMPWL, pwl_effective_pieces, pwl_select_torch

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


@functools.lru_cache(maxsize=None)
def _pwl_host_params(pwl_key):
    """The kernels' PWL constants (csrc/pwl.cuh's Pwl): the effective
    piece per stop index, slope[25] and inter[25]
    (gapcost.pwl_effective_pieces), then ceiling1, ceiling2, as one f32
    host array, built once per key (a launch passes its address; the
    cache keeps it alive)."""
    if len(pwl_key[0]) != NUMPWL - 1 or len(pwl_key[1]) != NUMPWL - 1:
        raise ValueError("pwl_key: expected 24 slopes and 24 intercepts")
    es, ei = pwl_effective_pieces(pwl_key)
    vals = [float(x) for x in es] + [float(x) for x in ei] + \
        [float(pwl_key[2]), float(pwl_key[3])]
    return (ctypes.c_float * len(vals))(*vals)


# csrc/sdp_blocked.cu's shared-memory records, in bytes: a block's rows
# and triangle (64 int4 and int2 row records, 2016 f32 weights, 64 lane-2
# flag words) and a staged block (two lists of 64 int4 entries, row
# indices and running maxima of V, four counts)
_TRI_BYTES = 64 * 16 + 64 * 8 + 4 * (64 * 63 // 2) + 8 * 64
_STAGED_BYTES = 2 * 64 * 16 + 2 * 64 * 4 + 2 * 64 * 4 + 16
SMEM_MAX = _ext.SMEM_MAX


def sdp_plan(N: int) -> dict:
    """Launch plan of csrc/sdp_blocked.cu for a bucket of N rows: the tier
    (0: one problem per block of one warp, for N = 64, whose one block has
    no cross-block term; 1: one problem per block of threads, one resolver
    warp and the rest folding), threads per block and dynamic shared
    memory in bytes.  The CTA tier's threads grow with N (the folds grow
    as N^2 while the in-block pass stays one warp): 128 up to N = 256,
    N / 2 up to 1024.  The grid is one block a problem."""
    if N % 64 or not 64 <= N <= 8192:
        raise ValueError(f"chain_scores_blocked: N={N} is not a multiple of "
                         "64 in 64..8192")
    if N == 64:
        return {"tier": 0, "threads": 32, "smem": _TRI_BYTES}
    return cta_plan(N, min(1024, max(128, N // 2)))


def cta_plan(N: int, threads: int) -> dict:
    """The CTA tier for N rows with `threads` threads a block: two
    triangles, two staged blocks, the running bests (value and index per
    lane and row), the receiver lists (uint16 per lane and row), their
    block starts and the rows' lane bits (csrc/sdp_blocked.cu:
    cta_smem)."""
    smem = 2 * _TRI_BYTES + 2 * _STAGED_BYTES + 21 * N + 8 * (N // 64 + 1)
    return {"tier": 1, "threads": threads, "smem": smem}


def plan_variants(N: int) -> list:
    """Every plan the kernel takes at N, for the tests: sdp_plan's, and the
    CTA tier at its fewest and most threads (at N = 64 too: one block and
    no cross-block term)."""
    out = []
    for p in (sdp_plan(N), cta_plan(N, 128), cta_plan(N, 1024)):
        if p not in out:
            out.append(p)
    return out


def plan_str(plan) -> str:
    return "tier {tier} threads {threads} smem {smem}".format(**plan)


_PLAN_KEYS = ("tier", "threads", "smem")
_FRAG_NAMES = ("qS", "qE", "tS", "tE", "score", "lane1", "lane2", "valid")
_FRAG_DTYPES = (torch.int32,) * 4 + (torch.float32,) + (torch.bool,) * 3
_SDP_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5


@functools.lru_cache(maxsize=None)
def _plan_args(N: int) -> tuple:
    plan = sdp_plan(N)
    return tuple(plan[k] for k in _PLAN_KEYS)


def _chain_scores_blocked_cuda(qS, qE, tS, tE, score, lane1, lane2, valid,
                               pwl_key, L, plan=None):
    """K2 on the card with sdp_plan's plan for this bucket (or the one
    given)."""
    B, N = qS.shape
    if L != 64 or N % 64 or N > 8192:
        raise ValueError(f"chain_scores_blocked kernel: needs L=64 and "
                         f"N % 64 == 0, N <= 8192 (got L={L}, N={N})")
    frags = (qS, qE, tS, tE, score, lane1, lane2, valid)
    for name, t, dt in zip(_FRAG_NAMES, frags, _FRAG_DTYPES):
        if not (t.is_cuda and t.dtype == dt and t.shape == (B, N)
                and t.is_contiguous()):
            _ext.check(name, t, dt, (B, N))     # raises, saying why
    dev = qS.device
    V = torch.empty((B, N), dtype=torch.float32, device=dev)
    bp = torch.empty((B, N), dtype=torch.int32, device=dev)
    lane = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0:
        return V, bp, lane
    args = (_plan_args(N) if plan is None
            else tuple(plan[k] for k in _PLAN_KEYS))
    _ext.launch("chain_scores_blocked", "sdp_blocked",
                "lra_chain_scores_blocked", _SDP_ARGS,
                *[t.data_ptr() for t in frags + (V, bp, lane)],
                ctypes.addressof(_pwl_host_params(pwl_key)), B, N, *args)
    return V, bp, lane


def chain_mask_from_scores(V, bp, valid):
    """Device-side single-best traceback (K3): walk bp from argmax(V) and
    return (vmax f32[B], maskbits int32[B, N//32]) — the chain as a
    bitmask.  A backpointer always targets a strictly earlier q-sorted
    row, so N steps cover any chain.  Requires N % 32 == 0."""
    if V.device.type == "cuda":
        return _chain_mask_from_scores_cuda(V, bp, valid)
    return chain_mask_from_scores_plain(V, bp, valid)


_MASK_WARPS = 8         # K3's warp tier: problems a block in a full bucket
_MASK_WARP_N = 1024     # K3: the largest N of the warp tier
_MASK_KEYS = ("tier", "ppb", "threads", "smem")
_MASK_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6


def mask_plan(N: int, B: int | None = None, sms: int = 132,
              tier: int | None = None) -> dict:
    """Launch plan of csrc/chain_mask.cu (K3) for B problems of N rows on a
    card of `sms` SMs.  Tier 0 (N <= 1024): one warp a problem, ppb of
    them a block, 8 when the bucket gives every SM 8 warps, else B // sms
    (at least one, B = None counts as small), so that a small bucket's
    blocks spread over the SMs; each warp stages its problem's bp and
    mask words in shared memory, 4 * (N + 32) bytes.  Tier 1 (N > 1024):
    one CTA of 32 * ceil(N / 256) threads (at most 1024) a problem, bp and
    the N / 32 words in shared memory.  `tier` forces a tier (tier 0 up
    to N = 1024)."""
    if N % 32 or not 0 < N <= 8192:
        raise ValueError(f"chain_mask_from_scores kernel: needs N % 32 == 0 "
                         f"and 0 < N <= 8192 (got N={N})")
    if tier is None:
        tier = 0 if N <= _MASK_WARP_N else 1
    if tier == 0:
        if N > _MASK_WARP_N:
            raise ValueError(f"chain_mask_from_scores: no warp tier at "
                             f"N={N} > {_MASK_WARP_N}")
        ppb = min(_MASK_WARPS, max(1, (B or 0) // sms))
        return {"tier": 0, "ppb": ppb, "threads": 32 * ppb,
                "smem": ppb * 4 * (N + 32)}
    return {"tier": 1, "ppb": 1, "threads": min(1024, 32 * -(-N // 256)),
            "smem": 4 * (N + N // 32)}


def mask_plan_variants(N: int) -> list:
    """K3's launch plans for N rows, by name: the warp tier at one and at
    8 problems a block (N <= 1024), and the CTA tier."""
    out = []
    if N <= _MASK_WARP_N:
        out += [("warp tier, 1 a block", mask_plan(N, 1)),
                ("warp tier, 8 a block", mask_plan(N, 1 << 20))]
    return out + [("CTA tier", mask_plan(N, tier=1))]


@functools.lru_cache(maxsize=None)
def _mask_plan_args(N: int, B: int, sms: int) -> tuple:
    plan = mask_plan(N, B, sms)
    return tuple(plan[k] for k in _MASK_KEYS)


def _chain_mask_from_scores_cuda(V, bp, valid, plan=None):
    """K3 on the card with mask_plan's plan for this bucket (or the one
    given)."""
    B, N = V.shape
    if N % 32 or N > 8192:
        raise ValueError(f"chain_mask_from_scores kernel: needs N % 32 == 0 "
                         f"and N <= 8192 (got N={N})")
    _ext.check("V", V, torch.float32, (B, N))
    _ext.check("bp", bp, torch.int32, (B, N))
    _ext.check("valid", valid, torch.bool, (B, N))
    for name, x, align in (("V", V, 16), ("bp", bp, 16), ("valid", valid, 4)):
        if x.data_ptr() % align:
            raise ValueError(f"chain_mask_from_scores kernel: {name} is not "
                             f"{align}-byte aligned")
    vmax = torch.empty(B, dtype=torch.float32, device=V.device)
    bits = torch.empty((B, N // 32), dtype=torch.int32, device=V.device)
    if B == 0:
        return vmax, bits
    args = (_mask_plan_args(N, B, _ext.sm_count(V.device.index or 0))
            if plan is None else tuple(plan[k] for k in _MASK_KEYS))
    p = _ext.ptr
    _ext.launch("chain_mask_from_scores", "chain_mask",
                "lra_chain_mask_from_scores", _MASK_ARGS, p(V), p(bp),
                p(valid), p(vmax), p(bits), B, N, *args)
    return vmax, bits


def chain_mask_from_scores_plain(V, bp, valid):
    """Plain torch version (any device): a python loop of N walk
    steps."""
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
