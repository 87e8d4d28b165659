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

The device-side evaluation (pwl_select_torch, and its inlined copy in
csrc/sdp_blocked.cu) is branch-free: the last breakpoint <= x picks the
piece, then a multiply, an add (each rounded in f32, never contracted
into an FMA), a floor and two clamps.
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
