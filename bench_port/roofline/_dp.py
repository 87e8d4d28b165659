"""Shared arithmetic of the banded DP kernels (K4, K5, P1).

Frozen from chip_smoke.py:383-389 (``dp_bound``) and its OPS_PER_CELL
(chip_smoke.py:153-157), restricted to the call's real problems (a pad
problem has qlen = tlen = 0) and to each problem's own band of
2 kband + 1 cells, so that the count reads the work of the inputs
whatever kernel computes it."""

import numpy as np


def bound(args, ops_per_cell: int, out_bytes_per_problem):
    """(ops, bytes) of a call f(q, t, qlen, tlen, K, m, mm, indel,
    kband=): rows 0..tlen of each real problem's band, every code and
    the three lengths read once, ``out_bytes_per_problem(qlen, tlen, T)``
    written."""
    q, t, qlen, tlen = args[0], args[1], args[2], args[3]
    kband = args[-1]
    T = t.shape[1]
    ql = np.asarray(qlen, dtype=np.int64)
    tl = np.asarray(tlen, dtype=np.int64)
    kb = np.asarray(kband, dtype=np.int64)
    real = (ql > 0) | (tl > 0)
    ql, tl, kb = ql[real], tl[real], kb[real]
    rows = np.minimum(tl, T) + 1
    ops = float((rows * (2 * kb + 1)).sum()) * ops_per_cell
    nbytes = float((ql + tl + 12).sum()) + float(
        out_bytes_per_problem(ql, tl, T).sum())
    return ops, nbytes
