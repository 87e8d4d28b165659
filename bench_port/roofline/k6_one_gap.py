"""K6, the one-long-gap DP with its traceback (csrc/one_gap.cu).

Frozen from chip_smoke.py:392-420 (``one_gap_rows``, ``one_gap_real``,
``one_gap_bound``), restricted to the call's real problems (all but
gap_align's pad rows: qlen 1, tlen 4, kband 1).  Per problem the prefix
rows 1..min(D+K-1, tBoundary-1) at 2K+1 cells and the suffix rows up to
tlen at 2K+4 cells, each cell's int8 arrow written once, one arrow read
per traceback step; the head and tail codes (int32) read once, the ops,
the jump and the score written once."""

import math

import numpy as np

SITES = (("lra_tpu_torch.pipeline.gap_align", "one_gap_traced"),)
DEVICE = ("one_gap_warp_kernel", "one_gap_kernel")
OPS_PER_CELL = 20


def bound(args, kw, out):
    q_head, t_head, q_tail, t_tail = args[:4]
    qlen, tlen, kb = (np.asarray(a, dtype=np.int64) for a in args[4:7])
    K, D, L = int(args[7]), int(args[8]), int(args[12])
    real = ~((qlen == 1) & (tlen == 4) & (kb == 1))
    qlen, tlen, kb = qlen[real], tlen[real], kb[real]
    diag = np.minimum(qlen, tlen)
    prow = np.clip(np.minimum(diag + kb - 1, tlen), 0, D + K - 1)
    tlow = np.maximum(tlen - diag - kb - 2, 0)
    srow = np.clip(tlen - tlow, 0, D + K + 2)
    cells = float((prow * (2 * K + 1) + srow * (2 * K + 4)).sum())
    ops_out = np.asarray(out[0])[real]
    steps = float((ops_out >= 0).sum())
    per_cell = OPS_PER_CELL + 2 * math.ceil(math.log2(2 * K + 4))
    width = q_head.shape[1] + t_head.shape[1] + q_tail.shape[1] + \
        t_tail.shape[1]
    n = int(real.sum())
    nbytes = n * (4 * width + 12 + L + 8) + cells + steps
    return cells * per_cell, nbytes
