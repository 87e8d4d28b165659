"""K5, the indel-refine DP with its lane-aware traceback (csrc/banded_refine.cu).

Each real problem: rows 0..tlen of its 2 kband + 1 band cells at
18 operations a cell (chip_smoke.py's OPS_PER_CELL), its codes and
three lengths read once, its packed traceback, 2 bits a step and a terminator written once."""

import numpy as np

from bench_port.roofline import _dp

SITES = (("lra_tpu_torch.pipeline.gap_align", "banded_refine_traced_packed"),)
DEVICE = ("banded_refine_kernel",)
OPS_PER_CELL = 18


def bound(args, kw, out):
    a = list(args[:4]) + [kw.get("kband", args[8] if len(args) > 8
                                 else None)]
    return _dp.bound(a, OPS_PER_CELL, lambda ql, tl, T: np.ceil((ql + tl + 1) / 4.0))
