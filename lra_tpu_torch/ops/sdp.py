"""Concave-gap chaining DP (the SDP core): the unblocked device scan
(kernel K8) and the numpy oracles.

``chain_scores`` is lra_tpu's ops/sdp.py:chain_scores, an O(N^2) scan over
the fragments in index order, batched over problems; the pipeline's
chaining runs the blocked kernel (ops/sdp_blocked.py, K2) and the
windowed one (ops/sdp_windowed.py, K7), and this scan is the public op
that the data-parallel mesh (parallel/mesh.py) and its tests call.  It
launches K2's kernel in its scan instance (csrc/sdp_blocked.cu, on
``scan_plan``'s tier) for CUDA tensors and runs ``chain_scores_plain``
for CPU tensors; the two agree bit for bit.  The
module also keeps lra_tpu's single-problem oracle (the host path's
chaining, use_device=False) and the host traceback.  They replace the
reference's event-sweep SDP (reference: SparseDP.h:1766-2440) with the
same optimum.

Recurrence (derived from ProcessPoint, SparseDP.h:313-662):

    V[i] = score[i] + max(0, max_j  V[j] + w(lane))

with predecessor j valid through
  lane 1 (forward diagonal, subproblems R1/C1):
      qE[j] <= qS[i]  and  tE[j] <= tS[i],
      w = -PWL(|(tS[i]-qS[i]) - (tE[j]-qE[j])| + 1)
  lane 2 (back diagonal, subproblems R2/C2):
      qE[j] <= qS[i]  and  tS[j] >= tE[i],
      w = -PWL(|(tE[i]+qS[i]) - (tS[j]+qE[j])| + 1)

Lane membership encodes the reference's two insertion rules: SDP-1 inserts
all four points per fragment (both lanes; inversion-aware chaining,
SparseDP.h:1957-2040), SDP-2 inserts one lane per strand
(SparseDP.h:1797-1807).  A strand flip along the traceback is a `link`
(inversion edge, SparseDP.h:1537-1565).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _ext
from .gapcost import STOPS, GapParams, pwl_torch
from .sdp_blocked import (_FRAG_DTYPES, _FRAG_NAMES, _STAGED_BYTES,
                          _TRI_BYTES, SMEM_MAX)

NEG = -3.0e38    # float32(-3e38): V of a row not yet scanned, or invalid


def chain_scores(qS, qE, tS, tE, score, lane1, lane2, valid,
                 slope, inter, ceiling1, ceiling2):
    """Batched DP (K8).  qS..valid [B, N] (int32 coordinates, f32 score,
    bool lanes and valid), in any fragment order; slope, inter f32[24]
    (tensors or arrays), ceiling1, ceiling2 scalars.

    Returns (V[B,N] f32, bp[B,N] int32, bplane[B,N] int32): bp = -1 marks
    a chain start, bplane = 2 where the predecessor edge used the
    back-diagonal lane.  bp and bplane are computed for invalid rows too;
    only V is masked to NEG there."""
    if qS.device.type == "cuda":
        return _chain_scores_cuda(qS, qE, tS, tE, score, lane1, lane2,
                                  valid, slope, inter, ceiling1, ceiling2)
    return chain_scores_plain(qS, qE, tS, tE, score, lane1, lane2, valid,
                              slope, inter, ceiling1, ceiling2)


def chain_scores_plain(qS, qE, tS, tE, score, lane1, lane2, valid,
                       slope, inter, ceiling1, ceiling2):
    """Plain torch version (any device): lra_tpu's scan, a python loop
    over rows i, each a masked max over every j of the batch.  At row i
    every V[j >= i] is still NEG, and NEG + w rounds to NEG, so only
    j < i can be taken (best > 0)."""
    B, N = qS.shape
    dev = qS.device
    d1s, d1e = tS - qS, tE - qE
    d2s, d2e = tE + qS, tS + qE
    negf = torch.tensor(NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    V = torch.full((B, N), NEG, dtype=torch.float32, device=dev)
    bp = torch.empty((B, N), dtype=torch.int32, device=dev)
    lane = torch.empty((B, N), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    for i in range(N):
        vis = (qE <= qS[:, i:i + 1]) & valid
        m1 = vis & (tE <= tS[:, i:i + 1]) & lane1 & lane1[:, i:i + 1]
        m2 = vis & (tS >= tE[:, i:i + 1]) & lane2 & lane2[:, i:i + 1]
        w1 = -pwl_torch((d1s[:, i:i + 1] - d1e).abs() + 1, slope, inter,
                        ceiling1, ceiling2)
        w2 = -pwl_torch((d2s[:, i:i + 1] - d2e).abs() + 1, slope, inter,
                        ceiling1, ceiling2)
        c1 = torch.where(m1, V + w1, negf)
        c2 = torch.where(m2, V + w2, negf)
        cand = torch.maximum(c1, c2)
        best = cand.amax(dim=1)
        arg = cand.argmax(dim=1)                               # first max
        take = best > 0.0
        v_i = score[:, i] + torch.where(take, best, zero)
        V[:, i] = torch.where(valid[:, i], v_i, negf)
        bp[:, i] = torch.where(take, arg, -1).to(torch.int32)
        l2 = take & (c2[rows, arg] > c1[rows, arg])
        lane[:, i] = torch.where(take, torch.where(l2, 2, 1), 0) \
            .to(torch.int32)
    return V, bp, lane


_SCAN_ARGS = [ctypes.c_void_p] * 14 + [ctypes.c_float] * 2 + \
    [ctypes.c_int] * 5
_SCAN_KEYS = ("tier", "threads", "smem")
SCAN_MAX_N = 65536          # the receiver lists hold uint16 rows
# the CTA tier's static shared memory (the PWL tables, two ints; ptxas):
# its dynamic shared memory is what they leave of SMEM_MAX
_SCAN_STATIC_SMEM = 4048


def _lists_bytes(Np: int) -> int:
    """The CTA tier's running bests, receiver lists, block starts and
    lane bits for Np rows (csrc/sdp_blocked.cu: lists_bytes)."""
    return 21 * Np + 8 * (Np // 64 + 1)


def scan_plan(N: int, tier: int | None = None) -> dict:
    """Launch plan of K8 (csrc/sdp_blocked.cu's lra_chain_scores_scan, K2's
    kernel in its SCAN instance) for a bucket of N rows, 1 <= N <=
    SCAN_MAX_N: the tier, threads a block, dynamic shared memory and
    device scratch a problem.  Tier 0 (N <= 64): one problem per block of
    one warp.  Tier 1: one problem per block, K2's CTA tier with its
    threads (128, up to 1024 at N / 2), the rows in whole blocks of 64 and
    the lists in shared memory (N <= 9536).  Tier 2: the same with the
    lists in device scratch (1024 threads).  `tier` forces tier 1 or 2
    where it takes N (N > 64; tier 1 while it fits)."""
    if not 1 <= N <= SCAN_MAX_N:
        raise ValueError(f"chain_scores kernel: N={N} is not in 1.."
                         f"{SCAN_MAX_N}")
    if tier is None and N <= 64:
        return {"tier": 0, "threads": 32, "smem": _TRI_BYTES,
                "scratch": 0}
    if N <= 64:
        raise ValueError(f"chain_scores kernel: no tier {tier} at N={N}")
    Np = -(-N // 64) * 64
    fixed = 2 * _TRI_BYTES + 2 * _STAGED_BYTES
    smem = fixed + _lists_bytes(Np)
    most = SMEM_MAX - _SCAN_STATIC_SMEM
    if tier == 1 or (tier is None and smem <= most):
        if smem > most:
            raise ValueError(f"chain_scores kernel: N={N} does not fit "
                             "tier 1's shared memory")
        return {"tier": 1, "threads": min(1024, max(128, Np // 2)),
                "smem": smem, "scratch": 0}
    return {"tier": 2, "threads": 1024, "smem": fixed,
            "scratch": -(-_lists_bytes(Np) // 16) * 16}


def scan_plan_variants(N: int) -> list:
    """Every K8 plan at N, by name, for the tests: scan_plan's, and tier
    2 (and tier 1 where it fits) above N = 64."""
    out = [("scan_plan", scan_plan(N))]
    if N > 64:
        for t in (1, 2):
            try:
                p = scan_plan(N, tier=t)
            except ValueError:
                continue
            if p not in [q for _, q in out]:
                out.append((f"tier {t}", p))
    return out


def scan_prune_np(slope, inter, ceiling1, ceiling2) -> bool:
    """Whether K8 may prune (csrc/sdp_blocked.cu: scan_pwl_load), computed
    as the kernel's set-up computes it: every piece's penalty, pwl_jnp's
    rounded multiply and add, the floor and the ceilings in f32, is >= 0
    at both ends of its range of x >= 3.  On a piece the penalty is
    monotone in x, so then every w = -PWL is <= 0."""
    slope = np.asarray(slope, np.float32)
    inter = np.asarray(inter, np.float32)
    c1, c2 = np.float32(ceiling1), np.float32(ceiling2)
    stops = [int(x) for x in STOPS]
    imax = np.iinfo(np.int32).max
    for p in range(len(slope)):
        lo = 3 if p == 0 else stops[p]
        hi = imax if p == len(slope) - 1 else stops[p + 1] - 1
        for x in (lo, hi):
            pen = np.floor(np.float32(slope[p] * np.float32(x)) + inter[p])
            if c1 <= pen < c2:
                pen = c1
            if pen > c2:
                pen = c2
            if not pen >= 0:
                return False
    return True


def _chain_scores_cuda(qS, qE, tS, tE, score, lane1, lane2, valid, slope,
                       inter, ceiling1, ceiling2, plan=None):
    """K8 on the card with scan_plan's plan for this bucket (or the one
    given).  slope and inter go to the device as they are (no host copy
    of a device tensor: the kernel reads them there)."""
    B, N = qS.shape
    frags = (qS, qE, tS, tE, score, lane1, lane2, valid)
    for name, t, dt in zip(_FRAG_NAMES, frags, _FRAG_DTYPES):
        if not (t.is_cuda and t.dtype == dt and t.shape == (B, N)
                and t.is_contiguous()):
            _ext.check(name, t, dt, (B, N))     # raises, saying why
    dev = qS.device
    slope = torch.as_tensor(slope, dtype=torch.float32, device=dev)
    inter = torch.as_tensor(inter, dtype=torch.float32, device=dev)
    _ext.check("slope", slope, torch.float32, (24,))
    _ext.check("inter", inter, torch.float32, (24,))
    V = torch.empty((B, N), dtype=torch.float32, device=dev)
    bp = torch.empty((B, N), dtype=torch.int32, device=dev)
    lane = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return V, bp, lane
    args, scratch = _scan_plan_args(N) if plan is None else \
        (tuple(plan[k] for k in _SCAN_KEYS), plan["scratch"])
    buf = (torch.empty(B * scratch, dtype=torch.uint8, device=dev)
           if scratch else None)
    _ext.launch("chain_scores", "sdp_blocked", "lra_chain_scores_scan",
                _SCAN_ARGS,
                *[t.data_ptr() for t in frags + (slope, inter, V, bp, lane)],
                buf.data_ptr() if scratch else None,
                float(np.float32(ceiling1)), float(np.float32(ceiling2)),
                B, N, *args)
    return V, bp, lane


@functools.lru_cache(maxsize=None)
def _scan_plan_args(N: int) -> tuple:
    plan = scan_plan(N)
    return tuple(plan[k] for k in _SCAN_KEYS), plan["scratch"]


# ------------------------------------------------------------------ host ---

def chain_scores_np(qS, qE, tS, tE, score, lane1, lane2, valid, gp: GapParams):
    """Single-problem numpy oracle with identical semantics (for tests and
    small host-side fallbacks)."""
    from .gapcost import gap_cost_np

    n = len(qS)
    V = np.full(n, -3.0e38, dtype=np.float64)
    bp = np.full(n, -1, dtype=np.int64)
    lane = np.zeros(n, dtype=np.int64)
    d1s, d1e = tS - qS, tE - qE
    d2s, d2e = tE + qS, tS + qE
    for i in range(n):
        if not valid[i]:
            continue
        best, bj, bl = 0.0, -1, 0
        for j in range(n):
            if not valid[j] or qE[j] > qS[i]:
                continue
            if lane1[i] and lane1[j] and tE[j] <= tS[i]:
                c = V[j] + gap_cost_np(d1s[i], d1e[j], gp)
                if c > best:
                    best, bj, bl = c, j, 1
            if lane2[i] and lane2[j] and tS[j] >= tE[i]:
                c = V[j] + gap_cost_np(d2s[i], d2e[j], gp)
                if c > best:
                    best, bj, bl = c, j, 2
        V[i] = score[i] + best
        bp[i], lane[i] = bj, bl
    return V, bp, lane


def traceback(V, bp, lane, valid, used=None):
    """Extract the best chain (host).  Returns (indices ascending by qS,
    links) where links[k]=True marks a lane flip between step k and k+1 —
    the reference's inversion edge (SparseDP.h:1537-1565)."""
    V = np.where(valid, V, -np.inf)
    if used is not None:
        V = np.where(used, -np.inf, V)
    i = int(np.argmax(V))
    if not np.isfinite(V[i]):
        return np.zeros(0, np.int64), np.zeros(0, bool)
    chain = []
    lanes = []
    while i >= 0:
        chain.append(i)
        lanes.append(lane[i])
        i = int(bp[i])
    chain = np.array(chain[::-1], dtype=np.int64)
    lanes = np.array(lanes[::-1], dtype=np.int64)
    links = np.zeros(len(chain), dtype=bool)
    if len(chain) > 1:
        links[1:] = lanes[1:] == 2
    return chain, links
