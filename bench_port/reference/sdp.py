"""Plain reference of the chaining SDP (the device rounds' K2 and K7), in
numpy float32.

Written from lra's chaining recurrence as the port states it
(lra_tpu_torch/ops/sdp_blocked.py, ops/gapcost.py); no code of the
program is called.  Fragments i = 0..N-1 of a problem are sorted by qS.
Fragment j precedes i on lane 1 (forward diagonal) when both are lane-1
fragments, qE[j] <= qS[i] and tE[j] <= tS[i]; on lane 2 (back diagonal)
when both are lane-2 fragments, qE[j] <= qS[i] and tS[j] >= tE[i]; only
j < i counts.  The weight of the pair is -PWL(|d_i - d_j| + 1) with the
diagonals d1 = t - q (lane 1: tS - qS of i, tE - qE of j) and d2 = t + q
(lane 2: tE + qS of i, tS + qE of j).  Then

    V[i] = score[i] + max(0, max over predecessors j of (V[j] + w))

with every sum rounded to float32, as lra stores it.  PWL is lra's
concave gap penalty (SubRountine.h:29-126), a piecewise-linear curve
through gap_extend * x ** (1 / gap_root) at 25 breakpoints, free below
x = 20 and clamped at two ceilings.
"""

from __future__ import annotations

import numpy as np

# frozen from lra_tpu_torch/ops/gapcost.py:33-39 (lra's breakpoints)
STOPS = np.array(
    [0, 5, 10, 20, 40, 80, 100, 200, 300, 500, 1000, 2000, 3000, 4000,
     5000, 6000, 7000, 8000, 9000, 15000, 20000, 30000, 40000, 50000,
     100000], dtype=np.int64)


def pwl_params(gap_extend: float, gap_root: float):
    """(slope f32[24], inter f32[24]) of each piece (lra's InitPWL; the
    intercept of piece 1 is zeroed there, and pieces that start at or
    below 10 are free)."""
    vals = np.zeros(len(STOPS), dtype=np.float64)
    vals[1:] = gap_extend * STOPS[1:].astype(np.float64) ** (1.0 / gap_root)
    slope = np.zeros(len(STOPS) - 1, dtype=np.float32)
    inter = np.zeros(len(STOPS) - 1, dtype=np.float32)
    for i in range(len(STOPS) - 1):
        if STOPS[i] <= 10:
            continue
        s = (vals[i + 1] - vals[i]) / (STOPS[i + 1] - STOPS[i])
        slope[i] = s
        inter[i] = vals[i] - STOPS[i] * s
    return slope, inter


def pwl(x: np.ndarray, slope, inter, ceiling1: float,
        ceiling2: float) -> np.ndarray:
    """lra's PWL_w(x): the last piece whose breakpoint is <= x, slope * x
    + intercept (two float32 roundings), floored, the plateau between the
    ceilings set to ceiling1, capped at ceiling2, 0 for x <= 2."""
    f32 = np.float32
    x = np.asarray(x, dtype=np.int64)
    piece = np.clip(np.searchsorted(STOPS, x, side="right") - 1, 0,
                    len(STOPS) - 2)
    pen = (x.astype(f32) * slope[piece]).astype(f32)
    pen = (pen + inter[piece]).astype(f32)
    pen = np.where(slope[piece] == 0, f32(0), pen)
    pen = np.floor(pen)
    pen = np.where((pen >= ceiling1) & (pen < ceiling2), f32(ceiling1), pen)
    pen = np.where(pen > ceiling2, f32(ceiling2), pen)
    return np.where(x <= 2, f32(0), pen).astype(f32)


class Chain:
    """One problem's fragments (numpy arrays of length n, sorted by qS)
    and its predecessor weights."""

    def __init__(self, qS, qE, tS, tE, score, lane1, lane2, gaps):
        self.qS, self.qE = qS.astype(np.int64), qE.astype(np.int64)
        self.tS, self.tE = tS.astype(np.int64), tE.astype(np.int64)
        self.score = score.astype(np.float32)
        self.l1, self.l2 = lane1.astype(bool), lane2.astype(bool)
        self.gaps = gaps     # (slope, inter, ceiling1, ceiling2)

    def weights(self, i: int):
        """(w1, w2) of every j < i: the pair weight on each lane, -inf
        where j does not precede i on that lane."""
        j = slice(0, i)
        vis = self.qE[j] <= self.qS[i]
        m1 = vis & (self.tE[j] <= self.tS[i]) & self.l1[j] & self.l1[i]
        m2 = vis & (self.tS[j] >= self.tE[i]) & self.l2[j] & self.l2[i]
        d1 = np.abs((self.tS[i] - self.qS[i]) - (self.tE[j] - self.qE[j]))
        d2 = np.abs((self.tE[i] + self.qS[i]) - (self.tS[j] + self.qE[j]))
        w1 = -pwl(d1 + 1, *self.gaps)
        w2 = -pwl(d2 + 1, *self.gaps)
        ninf = np.float32(-np.inf)
        return np.where(m1, w1, ninf), np.where(m2, w2, ninf)

    def scores(self, rnd=None):
        """V of every fragment, each sum rounded to float32 (then by
        ``rnd``, the control's rounding, if given)."""
        n = len(self.qS)
        V = np.zeros(n, dtype=np.float32)
        r = rnd or (lambda x: x)
        for i in range(n):
            w1, w2 = self.weights(i)
            best = np.float32(-np.inf)
            if i:
                best = max(np.max(r((V[:i] + w1).astype(np.float32))),
                           np.max(r((V[:i] + w2).astype(np.float32))))
            take = best > 0
            V[i] = r(np.float32(self.score[i] + (best if take
                                                 else np.float32(0))))
        return V

    def bad_rows(self, V, bp, lane) -> int:
        """Rows whose V, back pointer or lane a correct SDP would not
        give: V must equal the reference's, and a row that took a
        predecessor must name one that attains its V on that lane (any
        of several tied ones); a row that took none has bp -1, lane 0."""
        n = len(self.qS)
        ref = np.zeros(n, dtype=np.float32)
        bad = 0
        for i in range(n):
            w1, w2 = self.weights(i)
            c1 = (ref[:i] + w1).astype(np.float32)
            c2 = (ref[:i] + w2).astype(np.float32)
            best = max(c1.max(), c2.max()) if i else np.float32(-np.inf)
            take = best > 0
            ref[i] = np.float32(self.score[i] + (best if take
                                                 else np.float32(0)))
            j, ln = int(bp[i]), int(lane[i])
            if V[i] != ref[i]:
                bad += 1
            elif not take:
                bad += int(j != -1 or ln != 0)
            else:
                bad += int(not (0 <= j < i and ln in (1, 2)
                                and (c1, c2)[ln - 1][j] == best))
        return bad
