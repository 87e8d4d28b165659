"""Plain reference of the one-long-gap DP (the device rounds' K6), in
numpy, written from the recurrence of lra's ``AffineOneGapAlign``
(AffineOneGapAlign.h:157-652); no code of the program is called.

A problem aligns q (i = 0..n) to t (j = 0..p), one of them longer than
the other by more than the two bands (``diag + 2 k < max(n, p)``, with
``diag = min(n, p)`` and ``k = min(kband, diag)``: the regime K6 is
given).  A path runs from (0, 0) through

* the prefix band: (0, 0), column 0 down to i = k, row 0 out to
  j = k + 1, and the cells 1 <= j < min(diag + k, p + 1),
  max(1, j - k) <= i < min(diag + k, n + 1, j + k + 1);
* one free gap along the longer axis (GAPLEFT when q is longer: i grows,
  j stays; GAPDOWN when t is): from (0, 0) or a prefix cell off row and
  column 0 (GAPLEFT: i < n - k, j <= diag; GAPDOWN: j < p, i <= diag) to
  a landing cell: one of the suffix band's edge cells that lra seeds with
  the gap's value (GAPLEFT: (i, 0) for qLow <= i <= qS + k and
  (qLow + s, 1 + s) for 1 + s <= diag; GAPDOWN: (qS, j) for
  tLow <= j <= tS + k + 1 and (1 + s, tS + s - k) for 1 + s <= diag), or a
  suffix cell that may close the gap (GAPLEFT: j <= diag; GAPDOWN:
  i <= diag);
* the suffix band, to (n, p): the cells tLow < j <= p,
  max(qLow + 1, j + n - p - k) <= i <= min(n, j + n - p + k),

where qS = n - diag, tS = p - diag, qLow = max(0, n - diag - k - 1) and
tLow = max(0, p - diag - k - 2).  A DIAG step scores m or mm (an
unknown base, code 4, never matches), a LEFT (i - 1 -> i) or DOWN
(j - 1 -> j) step indel, the gap 0.  ``optimum`` is the best score of
such a path, by a DP over the two bands; ``rescore`` walks a path and
says whether it is one.  A path is optimal when both agree.
"""

from __future__ import annotations

import numpy as np

DONE, LEFT, DOWN, DIAG, BORDER, GAPLEFT, GAPDOWN = range(7)
NEG = -1e30


def _exact(x):
    return x


def bands(n: int, p: int, kband: int):
    """The problem's Bands, or None outside the one-gap regime."""
    diag = max(1, min(n, p))
    if diag + 2 * min(diag, kband) >= max(n, p):
        return None
    return Bands(n, p, kband)


class Bands:
    """The prefix band, the gap's ends and the suffix band of one
    problem."""

    def __init__(self, n: int, p: int, kband: int):
        self.n, self.p = n, p
        self.diag = diag = max(1, min(n, p))
        self.k = k = min(diag, kband)
        self.gap = GAPLEFT if n > p else GAPDOWN
        self.qB, self.tB = min(diag + k, n + 1), min(diag + k, p + 1)
        self.qS, self.tS = n - diag, p - diag
        self.qLow = max(0, n - diag - k - 1)
        self.tLow = max(0, p - diag - k - 2)

    # prefix
    def prefix_col(self, j: int) -> tuple:
        """[lo, hi] of the prefix band's computed cells in column j >= 1."""
        return max(1, j - self.k), min(self.qB - 1, j + self.k)

    def in_prefix(self, i: int, j: int) -> bool:
        if i == 0 and j == 0:
            return True
        if j == 0:
            return 1 <= i <= min(self.k, self.n)
        if i == 0:
            return 1 <= j <= min(self.k + 1, self.p)
        if not 1 <= j < self.tB:
            return False
        lo, hi = self.prefix_col(j)
        return lo <= i <= hi

    def gap_start(self, i: int, j: int) -> bool:
        if i == 0 and j == 0:
            return True
        if i == 0 or j == 0 or not self.in_prefix(i, j):
            return False
        if self.gap == GAPLEFT:
            return i < self.n - self.k and j <= self.diag
        return j < self.p and i <= self.diag

    # suffix
    def suffix_col(self, j: int) -> tuple:
        """[lo, hi] of the suffix band's computed cells in column j."""
        c = j + self.n - self.p
        return max(self.qLow + 1, c - self.k), min(self.n, c + self.k)

    def in_suffix(self, i: int, j: int) -> bool:
        if not self.tLow < j <= self.p:
            return False
        lo, hi = self.suffix_col(j)
        return lo <= i <= hi

    def seeded(self) -> list:
        """The edge cells lra seeds with the gap's value: [(i, j)]."""
        out = []
        if self.gap == GAPLEFT:
            out += [(i, 0) for i in range(self.qLow, self.qS + self.k + 1)]
            out += [(self.qLow + s, 1 + s) for s in range(self.diag)
                    if self.qLow + s <= self.n and 1 + s <= self.p]
        else:
            out += [(self.qS, j) for j in range(
                self.tLow, min(self.tS + self.k + 1, self.p) + 1)]
            out += [(1 + s, self.tS + s - self.k) for s in range(self.diag)
                    if self.tS + s - self.k >= 0 and self.tS + 1 + s <= self.p]
        return out

    def closes(self, i: int, j: int) -> bool:
        """A suffix cell the gap may land on."""
        if not self.in_suffix(i, j):
            return False
        return j <= self.diag if self.gap == GAPLEFT else i <= self.diag


class _Grid:
    """Values over rows [r0, r1] x columns [c0, c1], NEG elsewhere."""

    def __init__(self, r0, r1, c0, c1):
        self.r0, self.c0 = r0, c0
        self.v = np.full((r1 - r0 + 1, c1 - c0 + 1), NEG)

    def get(self, i: int, j: int) -> float:
        a, b = i - self.r0, j - self.c0
        if 0 <= a < self.v.shape[0] and 0 <= b < self.v.shape[1]:
            return float(self.v[a, b])
        return NEG

    def col(self, lo: int, hi: int, j: int) -> np.ndarray:
        """Column j's values at rows lo..hi, all inside the grid."""
        return self.v[lo - self.r0:hi - self.r0 + 1, j - self.c0].copy()

    def put(self, i: int, j: int, x: float) -> None:
        self.v[i - self.r0, j - self.c0] = x


def _sub(q, t, i0: int, i1: int, j: int, m: int, mm: int) -> np.ndarray:
    """DIAG scores into (i, j) for i in i0..i1: q[i-1] against t[j-1]."""
    a = q[i0 - 1:i1]
    b = t[j - 1]
    return np.where((a == b) & (a < 4) & (b < 4), m, mm).astype(np.float64)


def _column(g: _Grid, lo: int, hi: int, j: int, b: np.ndarray, indel: int,
            rnd) -> None:
    """Cells lo..hi of column j: the better of ``b`` (entries from other
    columns) and a LEFT run from the cell below, lo - 1 included."""
    x = np.concatenate(([g.get(lo - 1, j)], b))
    r = np.arange(len(x), dtype=np.float64)
    run = rnd(np.maximum.accumulate(x - indel * r) + indel * r)
    g.v[lo - g.r0:hi - g.r0 + 1, j - g.c0] = np.maximum(b, run[1:])


def optimum(q, t, m: int, mm: int, indel: int, kband: int, rnd=_exact):
    """The best score of a one-gap path (None outside the regime);
    ``rnd`` rounds after every operation (the control)."""
    n, p = len(q), len(t)
    bd = bands(n, p, kband)
    if bd is None:
        return None
    k, diag = bd.k, bd.diag
    P = _Grid(0, min(n, diag + k), 0, min(p, diag + k))
    P.put(0, 0, 0.0)
    for i in range(1, min(k, n) + 1):
        P.put(i, 0, float(rnd(np.float64(indel * i))))
    for j in range(1, min(k + 1, p) + 1):
        P.put(0, j, float(rnd(np.float64(indel * j))))
    for j in range(1, bd.tB):
        lo, hi = bd.prefix_col(j)
        if lo > hi:
            continue
        b = np.maximum(rnd(P.col(lo - 1, hi - 1, j - 1)
                           + _sub(q, t, lo, hi, j, m, mm)),
                       rnd(P.col(lo, hi, j - 1) + indel))
        _column(P, lo, hi, j, b, indel, rnd)

    # the gap's value at each column (GAPLEFT) or row (GAPDOWN) index
    gapv = np.full(diag + 1, NEG)
    gapv[0] = 0.0
    for j in range(1, bd.tB):
        lo, hi = bd.prefix_col(j)
        for i in range(lo, hi + 1):
            if bd.gap_start(i, j):
                x = P.get(i, j)
                idx = j if bd.gap == GAPLEFT else i
                gapv[idx] = max(gapv[idx], x)

    S = _Grid(bd.qLow, n, bd.tLow, p)
    for i, j in bd.seeded():
        S.put(i, j, gapv[j if bd.gap == GAPLEFT else i])
    for j in range(bd.tLow + 1, p + 1):
        lo, hi = bd.suffix_col(j)
        if lo > hi:
            continue
        ii = np.arange(lo, hi + 1)
        if bd.gap == GAPLEFT:
            close = np.full(len(ii), gapv[j] if j <= diag else NEG)
        else:
            close = np.where(ii <= diag, gapv[np.minimum(ii, diag)], NEG)
        b = np.maximum.reduce([
            close,
            rnd(S.col(lo - 1, hi - 1, j - 1) + _sub(q, t, lo, hi, j, m, mm)),
            rnd(S.col(lo, hi, j - 1) + indel)])
        _column(S, lo, hi, j, b, indel, rnd)
    best = S.get(n, p)
    return None if best <= NEG / 2 else best


def rescore(ops: list, jump: int, q, t, m: int, mm: int, indel: int,
            kband: int) -> tuple:
    """(score, valid) of a path: ``ops`` from the start, one code a step
    (LEFT, DOWN, DIAG) and one gap code whose length is ``jump``.  Valid:
    every step stays in its band, the gap is the one allowed, from a cell
    it may start at to one it may land on, and the path ends at (n, p)."""
    n, p = len(q), len(t)
    bd = bands(n, p, kband)
    if bd is None:
        return 0, False
    i = j = 0
    score = 0
    after = False
    for op in ops:
        if op in (GAPLEFT, GAPDOWN):
            if after or op != bd.gap or jump <= 0 or not bd.gap_start(i, j):
                return score, False
            if op == GAPLEFT:
                i += jump
            else:
                j += jump
            if (i, j) not in set(bd.seeded()) and not bd.closes(i, j):
                return score, False
            after = True
            continue
        if op == DIAG:
            i, j = i + 1, j + 1
            a, b = (int(q[i - 1]), int(t[j - 1])) if i <= n and j <= p \
                else (4, 4)
            score += m if a == b and a < 4 else mm
        elif op == LEFT:
            i += 1
            score += indel
        elif op == DOWN:
            j += 1
            score += indel
        else:
            return score, False
        if not (bd.in_suffix(i, j) if after else bd.in_prefix(i, j)):
            return score, False
    return score, after and (i, j) == (n, p)
