"""Concave piecewise-linear gap cost.

Exact re-implementation of the reference's PWL penalty
(reference: SubRountine.h:29-126 ``InitPWL``/``PWL_w`` and the live ``w``
at SubRountine.h:192-199, which unconditionally returns
``-PWL_w(|dj - di| + 1)`` — the log-lookup branches after it are dead).

Faithful quirks preserved:
* ``InitPWL``'s loop assigns ``intercept = 0`` at i=1 and never restores it
  (SubRountine.h:86-88), so gap_open contributes nothing to the live
  penalty — the curve is purely ``gap_extend * x**(1/gap_root)`` sampled at
  the 25 breakpoints.
* pieces whose left breakpoint is <= 10 have slope=0, intercept=0
  (SubRountine.h:92-95): gaps with x <= 20 are free.
* ``PWL_w`` forces minX=2 (SubRountine.h:104): x <= 2 is free regardless.
* two plateau ceilings (SubRountine.h:113-119).

The device-side evaluation (pwl_select_torch) is branch-free: the last
breakpoint <= x picks the piece, then a multiply, an add (each rounded in
f32, never contracted into an FMA), a floor and two clamps.  The CUDA
kernels (csrc/pwl.cuh) find the same piece by a binary search over the
stops and a host table of effective pieces (``pwl_effective_pieces``,
emulated by ``pwl_lookup_np``), then do the same two rounded operations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

STOPS = np.array(
    [0, 5, 10, 20, 40, 80, 100, 200, 300, 500, 1000, 2000, 3000, 4000,
     5000, 6000, 7000, 8000, 9000, 15000, 20000, 30000, 40000, 50000,
     100000],
    dtype=np.int64,
)
NUMPWL = len(STOPS)  # 25


@dataclass(frozen=True)
class GapParams:
    slope: np.ndarray      # f32[24] per-piece slope
    inter: np.ndarray      # f32[24] per-piece intercept
    ceiling1: float
    ceiling2: float
    # exact dense penalty table: table[x] = PWL_w(x) for x < len(table);
    # the penalty is monotone past the free region and clamps to ceiling2,
    # so min(x, len-1) indexing is exact once table[-1] == ceiling2.
    table: np.ndarray = None

    def static_key(self):
        """Hashable constants for jit-static PWL evaluation."""
        return (tuple(float(s) for s in self.slope),
                tuple(float(i) for i in self.inter),
                float(self.ceiling1), float(self.ceiling2))


def make_gap_params(gap_open: float, gap_extend: float, gap_root: float,
                    gap_ceiling1: int, gap_ceiling2: int) -> GapParams:
    vals = np.zeros(NUMPWL, dtype=np.float64)
    # reference zeroes `intercept` at i=1 permanently (SubRountine.h:86-88)
    vals[1:] = gap_extend * STOPS[1:].astype(np.float64) ** (1.0 / gap_root)
    slope = np.zeros(NUMPWL - 1, dtype=np.float32)
    inter = np.zeros(NUMPWL - 1, dtype=np.float32)
    for i in range(NUMPWL - 1):
        if STOPS[i] <= 10:
            continue  # slope=0, inter=0: free region
        s = (vals[i + 1] - vals[i]) / (STOPS[i + 1] - STOPS[i])
        slope[i] = s
        inter[i] = vals[i] - STOPS[i] * s
    gp = GapParams(slope, inter, float(gap_ceiling1), float(gap_ceiling2))
    size = 4096
    while True:
        tab = pwl_np(np.arange(size, dtype=np.int64), gp)
        if tab[-1] == gp.ceiling2:
            break
        size *= 2
    return GapParams(slope, inter, gp.ceiling1, gp.ceiling2, tab)


def from_options(opts) -> GapParams:
    return make_gap_params(opts.gap_open, opts.gap_extend, opts.gap_root,
                           opts.gap_ceiling1, opts.gap_ceiling2)


def pwl_np(x: np.ndarray, gp: GapParams) -> np.ndarray:
    """Numpy reference evaluation of PWL_w (penalty, >= 0)."""
    x = np.asarray(x, dtype=np.int64)
    piece = np.searchsorted(STOPS, x, side="right") - 1
    piece = np.clip(piece, 0, NUMPWL - 2)
    pen = gp.slope[piece].astype(np.float64) * x + gp.inter[piece]
    pen = np.floor(pen)  # reference stores into `long penalty`
    pen = np.where((pen >= gp.ceiling1) & (pen < gp.ceiling2), gp.ceiling1, pen)
    pen = np.where(pen > gp.ceiling2, gp.ceiling2, pen)
    return np.where(x <= 2, 0.0, pen).astype(np.float32)


def gap_cost_np(diag_i: np.ndarray, diag_j: np.ndarray, gp: GapParams) -> np.ndarray:
    """w(di, dj) = -PWL_w(|dj - di| + 1)  (reference: SubRountine.h:194-199)."""
    return -pwl_np(np.abs(np.asarray(diag_j, np.int64) - np.asarray(diag_i, np.int64)) + 1, gp)


# ---------------------------------------------------------------- device ---

def pwl_select_torch(x: torch.Tensor, pwl_key) -> torch.Tensor:
    """Exact PWL penalty for an int32 tensor x as a chain of elementwise
    selects (the plain twin of lra_tpu's pwl_select_jnp; the CUDA SDP
    kernel inlines the same chain).  Pieces are overwritten ascending:
    the last piece with STOPS[i] <= x wins (reference upper_bound
    semantics, SubRountine.h:110).  ``s * xf + b`` is two f32 ops, each
    rounded, so the floor sees the same value as the reference's.
    pwl_key: GapParams.static_key()."""
    slope, inter, ceiling1, ceiling2 = pwl_key
    xf = x.to(torch.float32)
    pen = torch.zeros_like(xf)
    for i in range(NUMPWL - 1):
        s = float(slope[i])
        if s == 0.0:
            continue  # free pieces contribute 0
        b = float(inter[i])
        pen = torch.where(x >= int(STOPS[i]), xf * s + b, pen)
    pen = torch.floor(pen)
    pen = torch.where((pen >= ceiling1) & (pen < ceiling2),
                      torch.full_like(pen, ceiling1), pen)
    pen = torch.where(pen > ceiling2, torch.full_like(pen, ceiling2), pen)
    return torch.where(x <= 2, torch.zeros_like(pen), pen)


def pwl_torch(x: torch.Tensor, slope, inter, ceiling1, ceiling2):
    """The plain twin of lra_tpu's pwl_jnp, the PWL of the unblocked SDP
    (ops/sdp.py:chain_scores, K8): piece = the count of the 23 inner stops
    (STOPS[1:-1]) <= x, slope[piece] and inter[piece] taken from runtime
    f32[24] tensors even where the slope is 0, ``slope * xf + inter`` as
    two separately rounded f32 ops, the floor, the two ceilings (f32), and
    0 for x <= 2.  Unlike pwl_select_torch, a zero-slope piece is not
    skipped, so the two differ on hand-made parameters (not on the
    presets')."""
    dev = x.device
    slope = torch.as_tensor(slope, dtype=torch.float32, device=dev)
    inter = torch.as_tensor(inter, dtype=torch.float32, device=dev)
    c1 = torch.tensor(float(np.float32(ceiling1)), device=dev)
    c2 = torch.tensor(float(np.float32(ceiling2)), device=dev)
    stops = torch.as_tensor(STOPS[1:-1], dtype=torch.int32, device=dev)
    piece = (x[..., None] >= stops).sum(dim=-1)
    pen = slope[piece] * x.to(torch.float32)
    pen = torch.floor(pen + inter[piece])
    pen = torch.where((pen >= c1) & (pen < c2), c1, pen)
    pen = torch.where(pen > c2, c2, pen)
    return torch.where(x <= 2, torch.zeros_like(pen), pen)


# ------------------------------------------------- the kernels' lookup ---

def pwl_effective_pieces(pwl_key) -> tuple:
    """The CUDA kernels' piece table (csrc/pwl.cuh): for each stop index i
    in 0..24, the slope and intercept of the piece that the select chain
    above leaves in place for x in [STOPS[i], STOPS[i+1]): the largest
    i' <= min(i, 23) with slope[i'] != 0 (pieces overwrite ascending,
    zero-slope pieces are skipped), or (0, 0) when there is none, which
    gives the chain's start value 0 through the same multiply and add.
    Returns (slope f32[25], inter f32[25])."""
    slope = np.asarray(pwl_key[0], np.float32)
    inter = np.asarray(pwl_key[1], np.float32)
    es = np.zeros(NUMPWL, np.float32)
    ei = np.zeros(NUMPWL, np.float32)
    cur = -1
    for i in range(NUMPWL):
        if i < NUMPWL - 1 and slope[i] != 0.0:
            cur = i
        if cur >= 0:
            es[i], ei[i] = slope[cur], inter[cur]
    return es, ei


def pwl_lookup_np(x: np.ndarray, pwl_key) -> np.ndarray:
    """Numpy emulation of the kernels' lookup, step for step: a binary
    search for the last stop <= x (STOPS padded to 32 with int32 max),
    one f32 multiply and one separately rounded f32 add on the effective
    piece, then the floor, the two ceilings and the free x <= 2."""
    es, ei = pwl_effective_pieces(pwl_key)
    c1, c2 = np.float32(pwl_key[2]), np.float32(pwl_key[3])
    stops = np.full(32, np.iinfo(np.int32).max, np.int64)
    stops[:NUMPWL] = STOPS
    x = np.asarray(x, np.int32)
    lo = np.zeros(x.shape, np.int64)
    for step in (16, 8, 4, 2, 1):
        lo = np.where(stops[lo + step] <= x, lo + step, lo)
    pen = np.float32(es[lo] * x.astype(np.float32))
    pen = np.float32(pen + ei[lo])
    pen = np.floor(pen)
    pen = np.where((pen >= c1) & (pen < c2), c1, pen)
    pen = np.where(pen > c2, c2, pen)
    return np.where(x <= 2, np.float32(0.0), pen).astype(np.float32)


def pwl_buckets_np() -> np.ndarray:
    """The bucket table of csrc/pwl.cuh's pwl_bucketed, built as the
    kernel builds it: int64[455, 2] of (the stop index at the bucket's
    left edge, the next stop inside the bucket or int32 max), buckets of
    4 below 1024, of 512 up to 102400, then one past the last stop whose
    entry is (23, 100000)."""
    imax = np.iinfo(np.int32).max
    out = np.zeros((256 + 198 + 1, 2), np.int64)
    for k in range(len(out)):
        lo = 4 * k if k < 256 else 1024 + 512 * (k - 256)
        hi = lo + 4 if k < 256 else lo + 512 if k < len(out) - 1 else imax
        idx = int(np.searchsorted(STOPS, lo, side="right")) - 1
        nxt = int(STOPS[idx + 1]) if idx + 1 < NUMPWL and \
            STOPS[idx + 1] < hi else imax
        # past the last stop: (23, 100000), as x there may reach int32 max
        out[k] = (idx, nxt) if k < len(out) - 1 else \
            (NUMPWL - 2, int(STOPS[-1]))
    return out


def pwl_bucket_index_np(x: np.ndarray) -> np.ndarray:
    """The stop index pwl_bucketed reads for int32 x (numpy emulation)."""
    tab = pwl_buckets_np()
    x = np.asarray(x, np.int64)
    k = np.where(x < 1024, np.maximum(x, 0) >> 2,
                 np.minimum(256 + ((x - 1024) >> 9), len(tab) - 1))
    return tab[k, 0] + (x >= tab[k, 1])
