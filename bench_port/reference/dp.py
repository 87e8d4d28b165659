"""Plain reference of the device rounds' alignment DPs, in numpy.

Written from the semantics the port's docstrings state
(lra_tpu_torch/ops/affine_kernel.py): no code of the program is called.
Two DPs over a query q (i = 0..qlen) and a target t (j = 0..tlen),
restricted to the band |i - j| <= kband, with integer scores:

* ``global``: lra's banded global alignment with a linear gap (K4):
  a substitution scores m or mm, every query or target gap base scores
  indel; the first row and column are gap runs from (0, 0).
* ``refine``: the indel-refine DP (K5): the same, except that a gap run
  of length n may instead score ``open = 2 * indel + 1`` whole (a flat
  lane), and the column i = 0 is closed below row 0.

``optimum`` gives the best score at (qlen, tlen); ``rescore`` the score
of a traceback path (ops end-first: LEFT consumes a query base, DOWN a
target base, DIAG both) and whether every cell it visits is valid.  A
path is optimal when both agree.  ``traceback`` walks a DP computed
with a rounding (the control: bfloat16) back into such a path.
"""

from __future__ import annotations

import numpy as np

LEFT, DOWN, DIAG = 1, 2, 3
NEG = np.float64(-1e30)


def bf16(x: np.ndarray) -> np.ndarray:
    """Round float values to bfloat16 (nearest, ties to even), as floats."""
    f = np.asarray(x, dtype=np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _exact(x):
    return x


def _rows(kind, q, t, qlen, tlen, kband, m, mm, indel, rnd=_exact):
    """Yield (row, dl) for j = 0..tlen: the DP's row j as float64
    [qlen + 1] (NEG outside the valid cells) and, for ``refine``, its
    deletion lane; ``rnd`` rounds after every operation."""
    open_ = 2 * indel + 1
    row = np.full(qlen + 1, NEG)
    ii = np.arange(0, min(kband, qlen) + 1)
    row[ii] = rnd(indel * ii.astype(np.float64))
    dl = np.full(qlen + 1, NEG)
    yield row, dl
    first = 1 if kind == "refine" else 0
    for j in range(1, tlen + 1):
        lo, hi = max(first, j - kband), min(qlen, j + kband)
        new = np.full(qlen + 1, NEG)
        ndl = np.full(qlen + 1, NEG)
        if lo <= hi:
            ii = np.arange(lo, hi + 1)
            prev = row[np.maximum(ii - 1, 0)]
            sub = np.where(q[np.maximum(ii - 1, 0)] == t[j - 1], m, mm)
            b = np.maximum(np.where(ii >= 1, rnd(prev + sub), NEG),
                           rnd(row[ii] + indel))
            if kind == "refine":
                ndl[ii] = np.maximum(rnd(row[ii] + open_), dl[ii])
                b = np.maximum(b, ndl[ii])
            elif lo == 0:
                b[0] = rnd(np.float64(indel * j))
            # a gap run along the row: max over k <= i of b[k] + indel (i-k)
            best = rnd(np.maximum.accumulate(b - indel * ii) + indel * ii)
            if kind == "refine":
                lane = rnd(np.maximum.accumulate(b)[:-1] + open_)
                best[1:] = np.maximum(best[1:], lane)
            new[ii] = best
        row, dl = new, ndl
        yield row, dl


def optimum(kind, q, t, qlen, tlen, kband, m, mm, indel, rnd=_exact):
    """The DP's value at (qlen, tlen) (NEG if unreachable)."""
    row = None
    for row, _dl in _rows(kind, q, t, qlen, tlen, kband, m, mm, indel,
                          rnd):
        pass
    return float(row[qlen])


def _runs(ops):
    out = []
    for op in ops:
        if out and out[-1][0] == op:
            out[-1][1] += 1
        else:
            out.append([op, 1])
    return out


def rescore(kind, ops, q, t, qlen, tlen, kband, m, mm, indel):
    """(score, valid) of the path ``ops`` (end-first) from (qlen, tlen).

    valid: the path ends at (0, 0) and visits only cells of the band
    inside the problem (for ``refine``, none of the closed column).  A
    gap run scores indel per base, or for ``refine`` the better of that
    and the flat lane (not on row 0, which has no lane)."""
    i, j = int(qlen), int(tlen)
    open_ = 2 * indel + 1
    score = 0
    ok = True
    for op, n in _runs(list(ops)):
        if op == DIAG:
            for _ in range(n):
                score += m if q[i - 1] == t[j - 1] else mm
                i -= 1
                j -= 1
                ok &= _cell_ok(kind, i, j, qlen, tlen, kband)
        elif op in (LEFT, DOWN):
            lin = indel * n
            row0 = op == LEFT and j == 0
            score += lin if (kind == "global" or row0) else max(lin, open_)
            for _ in range(n):
                if op == LEFT:
                    i -= 1
                else:
                    j -= 1
                ok &= _cell_ok(kind, i, j, qlen, tlen, kband)
        else:
            return score, False
        if not ok:
            return score, False
    return score, (i, j) == (0, 0)


def _cell_ok(kind, i, j, qlen, tlen, kband) -> bool:
    if i < 0 or j < 0 or i > qlen or j > tlen or abs(i - j) > kband:
        return False
    return not (kind == "refine" and i == 0 and j > 0)


def traceback(kind, q, t, qlen, tlen, kband, m, mm, indel, rnd):
    """A path (ops end-first) through the DP computed with ``rnd``: at
    each cell DIAG if the diagonal predecessor gives the cell's rounded
    value, else DOWN if the cell above (or the deletion lane) does, else
    LEFT."""
    rows, dls = zip(*[(r.copy(), d.copy()) for r, d in _rows(
        kind, q, t, qlen, tlen, kband, m, mm, indel, rnd)])
    i, j = int(qlen), int(tlen)
    ops = []
    while (i, j) != (0, 0):
        v = rows[j][i]
        if j == 0 or (i > 0 and rnd(rows[j - 1][i - 1] + (
                m if q[i - 1] == t[j - 1] else mm)) == v and j > 0):
            if j == 0:
                ops.append(LEFT)
                i -= 1
            else:
                ops.append(DIAG)
                i, j = i - 1, j - 1
        elif i == 0 or rnd(rows[j - 1][i] + indel) == v or dls[j][i] == v:
            ops.append(DOWN)
            j -= 1
        else:
            ops.append(LEFT)
            i -= 1
    return ops
