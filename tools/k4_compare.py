#!/usr/bin/env python3
"""K4 of other trees against this tree's, on one card, on the inputs
chip_smoke.py recorded:

    python3 chip_smoke.py --save-k4 PATH
    python3 tools/k4_compare.py PATH OTHER_TREE...

Each OTHER_TREE is an unpacked `git archive` of a commit (or a copy of
this tree with another csrc/banded_global.cu).  Its source is built with
nvcc into OTHER_TREE/_k4_build/ and called through ctypes: the
one-CTA-per-problem entry point of the design before the redesign (an
int8 arrow scratch [B, T+1, 2K+1]) or the planned one of this tree
(global_plan's plan, a plane scratch [B, T+1, P] and a counter).  On
each path's largest K4 input every kernel must equal this tree's plain
twin bit for bit; then CUDA-event medians in turns (each runner, this
tree's wrapper twice, each runner again in reverse order), this tree's
also with the walk skipped (the forward rows alone); and each runner
BACK_TO_BACK times between two events, the card's time per launch with
the host's work hidden.  Needs a CUDA device; prints the card's name and
power limit.  Every tree, this one too, is timed through the same bare
ctypes runner (its scratch allocated once, the output per call), and
this tree also through its wrapper, the main path's call."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACK_TO_BACK = 20
sys.path.insert(0, ROOT)


def build(tree: str):
    """(entry point, planned?) of tree's csrc/banded_global.cu."""
    from lra_tpu_torch.ops import _ext

    out = os.path.join(tree, "_k4_build")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libbanded_global.so")
    src = os.path.join(tree, "lra_tpu_torch", "csrc", "banded_global.cu")
    with open(os.path.join(out, "nvcc.log"), "w") as log:
        subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", so, src],
                       check=True, stdout=log, stderr=subprocess.STDOUT)
    planned = "void* counter" in open(src).read()
    fn = ctypes.CDLL(so).lra_banded_global_traced_packed
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 if planned
                   else [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7) + \
        [ctypes.c_void_p]
    return fn, planned


def runner(fn, planned, q, t, qlen, tlen, kband, K, m, mm, indel):
    import torch

    from lra_tpu_torch.ops import affine_kernel as ak

    B, Q = q.shape
    T = t.shape[1]
    plan = ak.global_plan(K, B, ak._sm_count(0))
    scratch = torch.empty(16 + B * (T + 1) * (plan["P"] if planned
                                              else 2 * K + 1),
                          dtype=torch.uint8, device="cuda")

    def run():
        out = torch.empty((B, (Q + T) // 4), dtype=torch.uint8,
                          device="cuda")
        ptrs = [x.data_ptr() for x in (q, t, qlen, tlen, kband)] + \
            [scratch.data_ptr() + 16, out.data_ptr()]
        if planned:
            args = ptrs + [scratch.data_ptr(), B, Q, T, K, m, mm, indel] + \
                [plan[k] for k in ("CPT", "WP", "PPC", "P", "R", "smem")] + \
                [1]
        else:
            args = ptrs + [B, Q, T, K, m, mm, indel]
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"K4: CUDA launch failed ({rc})")
        return out
    return run


def main() -> int:
    import torch

    import chip_smoke as cs
    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import affine_kernel as ak

    if not torch.cuda.is_available() or len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 1
    inputs = torch.load(sys.argv[1])
    trees = ["this"] + sys.argv[2:]
    built = [(_ext._entry("banded_global", "lra_banded_global_traced_packed",
                          ak._PLANNED_ARGS), True)] + \
        [build(tr) for tr in trees[1:]]
    cs.log(cs.smi_line())
    for label, (args, kw) in inputs.items():
        q, t, qlen, tlen = [a.cuda() for a in args[:4]]
        K, m, mm, indel = args[4:8]
        kband = kw["kband"].cuda()
        B, Q = q.shape
        runs = [runner(fn, planned, q, t, qlen, tlen, kband, K, m, mm,
                       indel) for fn, planned in built]
        this = lambda: ak.banded_global_traced_packed(q, t, qlen, tlen, K, m,
                                                      mm, indel, kband=kband)
        fwd = lambda: ak._global_cuda(q, t, qlen, tlen, kband, K, m, mm,
                                      indel, walk=False)
        ref = ak.banded_global_traced_packed_plain(q, t, qlen, tlen, K, m,
                                                   mm, indel, kband)
        for tr, run in zip(trees, runs):
            cs.exact(f"K4 of {tr} [{label}]", run(), ref)
        cs.exact(f"K4 [{label}]", this(), ref)
        torch.cuda.synchronize()
        first = [cs.cuda_ms(run, 10) for run in runs]
        mine = [cs.cuda_ms(this, 10), cs.cuda_ms(this, 10)]
        last = [cs.cuda_ms(run, 10) for run in runs[::-1]][::-1]
        f1 = cs.cuda_ms(fwd, 10)
        cs.log(f"K4 [{label}] B={B} S={Q} K={K}, all exact; this through "
               f"its wrapper {mine[0]:.4f}, {mine[1]:.4f} ms (forward rows "
               f"alone {f1:.4f}); runners: "
               + "; ".join(f"{tr} {a:.4f}, {b:.4f} ms"
                           for tr, a, b in zip(trees, first, last))
               + "; " + cs.plan_str(ak.global_plan(K, B, ak._sm_count(0))))
        # back to back: the card's time per launch, the host's enqueue
        # hidden behind the launches before it
        b2b = [[cs.cuda_ms(lambda: [run() for _ in range(BACK_TO_BACK)], 3)
                / BACK_TO_BACK for run in runs] for _ in range(2)]
        cs.log(f"K4 [{label}] back to back, ms per launch: "
               + "; ".join(f"{tr} {a:.4f}, {b:.4f}"
                           for tr, a, b in zip(trees, *b2b)))
    cs.log(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
