"""P1, the row-synchronous banded DP (rowsync_kernel, csrc/banded_global.cu).

Each real problem: rows 0..tlen of its 2 kband + 1 band cells at
10 operations a cell (chip_smoke.py's OPS_PER_CELL), its codes and
three lengths read once, its P plane's decoded ops, 2 bits a step written once."""

import numpy as np

from bench_port.roofline import _dp

SITES = (("lra_tpu_torch.pipeline.gap_align", "banded_pallas_rowsync"),)
DEVICE = ("rowsync_kernel",)
OPS_PER_CELL = 10


def bound(args, kw, out):
    a = list(args[:4]) + [kw.get("kband", args[8] if len(args) > 8
                                 else None)]
    return _dp.bound(a, OPS_PER_CELL, lambda ql, tl, T: np.ceil((ql + tl + 1) / 4.0))
