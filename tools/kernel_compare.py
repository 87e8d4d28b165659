#!/usr/bin/env python3
"""A hand kernel of other trees against this tree's, on one card, on the
inputs chip_smoke.py recorded:

    python3 chip_smoke.py --save-k2 PATH       # or --save-k4, --save-k6
    python3 tools/kernel_compare.py k2 PATH OTHER_TREE...
    python3 tools/kernel_compare.py k4 PATH OTHER_TREE...
    python3 tools/kernel_compare.py k6 PATH OTHER_TREE...
    python3 tools/kernel_compare.py p1 PATH OTHER_TREE...   # --save-p1
    python3 tools/kernel_compare.py k3 PATH OTHER_TREE...   # --save-k3
    python3 tools/kernel_compare.py k8 PATH OTHER_TREE...   # --save-k8
    python3 tools/kernel_compare.py k9 PATH OTHER_TREE...   # --save-k9

KERNEL is k2 (chain_scores_blocked, csrc/sdp_blocked.cu), k4
(banded_global_traced_packed, csrc/banded_global.cu), k6
(one_gap_traced, csrc/one_gap.cu), p1 (banded_pallas_rowsync, the
rowsync_kernel of csrc/banded_global.cu, or an earlier tree's
csrc/rowsync.cu), k3 (chain_mask_from_scores, csrc/chain_mask.cu), k8
(chain_scores: the scan instance of csrc/sdp_blocked.cu, or an earlier
tree's csrc/sdp_scan.cu) or k9 (banded_global_kernel: the arrows
instance of csrc/banded_global.cu, or an earlier tree's
csrc/banded_arrows.cu);
k6, p1 and k3 take every recorded launch of each path, with the device
time of a path's launches summed at the end.  Each OTHER_TREE
is an unpacked `git archive` of a commit (or a copy of this tree with
another source).  Its source is built with nvcc into
OTHER_TREE/_<kernel>_build/ and called through ctypes: the
one-CTA-per-problem entry point of the design before the kernel's
redesign, or the planned one of this tree (the plan from this tree's
plan function).  On each path's largest input every kernel must equal
this tree's plain twin bit for bit; then CUDA-event medians in turns
(each runner, this tree's wrapper twice, each runner again in reverse
order), K4 of this tree also with its walk skipped; and each runner
BACK_TO_BACK times between two events, the card's time per launch with
the host's work hidden (two rounds, the second in reverse order), and
BACK_TO_BACK times under torch.profiler, the device time of its kernels
a call.  With --phases, each OTHER_TREE with the old K2 entry point
is also built with its serial in-block pass and, separately, its
cross-block loop cut out, and timed: a phase split by subtraction (those
copies' outputs are not checked).  Needs a CUDA device; prints the
card's name and power limit.  Every tree, this one too, is timed through
the same bare ctypes runner (its scratch allocated once, the outputs per
call), and this tree also through its wrapper, the main path's call."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACK_TO_BACK = 20
sys.path.insert(0, ROOT)


def nvcc_build(src: str, out_dir: str, lib: str, patch=None) -> str:
    """Compile src (with `patch` = (old, new) applied to a copy in
    out_dir) into out_dir/lib<lib>.so; returns the library's path."""
    from lra_tpu_torch.ops import _ext

    os.makedirs(out_dir, exist_ok=True)
    inc = os.path.dirname(os.path.abspath(src))     # the tree's headers
    if patch is not None:
        text = open(src).read()
        if patch[0] not in text:
            raise SystemExit(f"kernel_compare: anchor not found in {src}: "
                             f"{patch[0].strip()[:60]!r}")
        src = os.path.join(out_dir, f"{lib}.cu")
        with open(src, "w") as f:
            f.write(text.replace(patch[0], patch[1], 1))
    so = os.path.join(out_dir, f"lib{lib}.so")
    with open(os.path.join(out_dir, f"{lib}.log"), "w") as log:
        subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-I", inc, "-o", so,
                        src], check=True, stdout=log,
                       stderr=subprocess.STDOUT)
    return so


def source(spec, tree: str) -> tuple:
    """(source file, library name) of a kernel in a tree."""
    if hasattr(spec, "source"):
        return spec.source(tree)
    return os.path.join(tree, "lra_tpu_torch", "csrc", spec.src), spec.lib


def is_planned(spec, src: str) -> bool:
    """Whether a kernel source has the planned entry point (the one that
    takes a launch plan) or the one-CTA-per-problem one."""
    if hasattr(spec, "planned"):
        return spec.planned(src)
    return spec.planned_mark in open(src).read()


class K4:
    """banded_global_traced_packed; inputs (q, t, qlen, tlen, K, m, mm,
    indel) and kband."""

    lib, src = "banded_global", "banded_global.cu"
    planned_mark = "void* counter"      # the persistent grid's

    def __init__(self, args, kw):
        self.q, self.t, self.qlen, self.tlen = [a.cuda() for a in args[:4]]
        self.K, self.m, self.mm, self.indel = args[4:8]
        self.kband = kw["kband"].cuda()

    def shape(self) -> str:
        from lra_tpu_torch.ops import _ext
        from lra_tpu_torch.ops import affine_kernel as ak

        B, Q = self.q.shape
        return (f"B={B} S={Q} K={self.K}; " + "CPT {CPT} WP {WP} PPC {PPC} "
                "P {P} R {R} smem {smem}".format(
                    **ak.global_plan(self.K, B, _ext.sm_count(0))))

    @staticmethod
    def entry(so: str, planned: bool):
        fn = ctypes.CDLL(so).lra_banded_global_traced_packed
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                       if planned else
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7) + \
            [ctypes.c_void_p]
        return fn

    def runner(self, fn, planned):
        import torch

        from lra_tpu_torch.ops import _ext
        from lra_tpu_torch.ops import affine_kernel as ak

        q, t, K = self.q, self.t, self.K
        B, Q = q.shape
        T = t.shape[1]
        plan = ak.global_plan(K, B, _ext.sm_count(0))
        scratch = torch.empty(16 + B * (T + 1) * (plan["P"] if planned
                                                  else 2 * K + 1),
                              dtype=torch.uint8, device="cuda")

        def run():
            out = torch.empty((B, (Q + T) // 4), dtype=torch.uint8,
                              device="cuda")
            ptrs = [x.data_ptr() for x in (q, t, self.qlen, self.tlen,
                                           self.kband)] + \
                [scratch.data_ptr() + 16, out.data_ptr()]
            if planned:
                args = ptrs + [scratch.data_ptr(), B, Q, T, K, self.m,
                               self.mm, self.indel] + \
                    [plan[k] for k in ("CPT", "WP", "PPC", "P", "R",
                                       "smem")] + [1]
            else:
                args = ptrs + [B, Q, T, K, self.m, self.mm, self.indel]
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"K4: CUDA launch failed ({rc})")
            return out
        return run

    def wrapper(self):
        from lra_tpu_torch.ops import affine_kernel as ak

        return ak.banded_global_traced_packed(
            self.q, self.t, self.qlen, self.tlen, self.K, self.m, self.mm,
            self.indel, kband=self.kband)

    def plain(self):
        from lra_tpu_torch.ops import affine_kernel as ak

        return ak.banded_global_traced_packed_plain(
            self.q, self.t, self.qlen, self.tlen, self.K, self.m, self.mm,
            self.indel, self.kband)

    def parts(self) -> list:
        from lra_tpu_torch.ops import affine_kernel as ak

        return [("forward rows alone", lambda: ak._global_cuda(
            self.q, self.t, self.qlen, self.tlen, self.kband, self.K,
            self.m, self.mm, self.indel, walk=False))]

    patches: dict = {}


class K2:
    """chain_scores_blocked; inputs (qS, qE, tS, tE, score, lane1, lane2,
    valid, pwl_key)."""

    lib, src = "sdp_blocked", "sdp_blocked.cu"
    planned_mark = "int tier"
    # the one-CTA-per-problem design of an earlier tree, a phase cut out
    patches = {
        "no in-block pass": ("    if (warp == 0) {\n      const bool va0",
                             "    if (false) {\n      const bool va0"),
        "no cross-block loop": ("for (int j = lane; j < b0; j += 32)",
                                "for (int j = lane; j < 0; j += 32)"),
    }

    def __init__(self, args, kw):
        self.args = [a.cuda() for a in args[:8]]
        self.key = args[8]

    def shape(self) -> str:
        from lra_tpu_torch.ops import sdp_blocked as sb

        B, N = self.args[0].shape
        return (f"B={B} N={N} ({int(self.args[7].sum())} valid rows); "
                + sb.plan_str(sb.sdp_plan(N)))

    @staticmethod
    def entry(so: str, planned: bool):
        fn = ctypes.CDLL(so).lra_chain_scores_blocked
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + \
            [ctypes.c_int] * (2 + (len(PLAN_KEYS) if planned else 0)) + \
            [ctypes.c_void_p]
        return fn

    def runner(self, fn, planned):
        import torch

        from lra_tpu_torch.ops import sdp_blocked as sb

        B, N = self.args[0].shape
        pwl = sb._pwl_host_params(self.key)
        plan = sb.sdp_plan(N) if planned else None

        def run():
            out = [torch.empty((B, N), dtype=dt, device="cuda")
                   for dt in (torch.float32, torch.int32, torch.int32)]
            ptrs = [x.data_ptr() for x in self.args + out]
            args = ptrs + [ctypes.addressof(pwl), B, N]
            if planned:
                args += [plan[k] for k in PLAN_KEYS]
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"K2: CUDA launch failed ({rc})")
            return out
        return run

    def wrapper(self):
        from lra_tpu_torch.ops import sdp_blocked as sb

        return sb.chain_scores_blocked(*self.args, self.key)

    def plain(self):
        from lra_tpu_torch.ops import sdp_blocked as sb

        return sb.chain_scores_blocked_plain(*self.args, self.key)


class K6:
    """one_gap_traced; inputs (q_head, t_head, q_tail, t_tail, qlen, tlen,
    kband, K, D, m, mm, indel, L).  chip_smoke.py --save-k6 saves every K6
    launch of each path, labelled "<path> #<launch>"."""

    lib, src = "one_gap", "one_gap.cu"
    planned_mark = "int tables_smem"    # the planned entry point's
    outs = ("ops", "jump", "score")
    patches: dict = {}

    def __init__(self, args, kw):
        self.args = [a.cuda() for a in args[:7]]
        self.K, self.D, self.m, self.mm, self.indel, self.L = args[7:13]

    def shape(self) -> str:
        import chip_smoke as cs

        B = self.args[0].shape[0]
        p, s = cs.one_gap_rows(self.args, self.K, self.D)
        real = int(cs.one_gap_real(self.args).sum())
        return (f"B={B} K={self.K} D={self.D} ({real} real problems, at "
                f"most {int((p + s).max())} rows a problem)")

    @staticmethod
    def entry(so: str, planned: bool):
        from lra_tpu_torch.ops import one_gap as og

        fn = ctypes.CDLL(so).lra_one_gap_traced
        fn.restype = ctypes.c_int
        fn.argtypes = (og._ONE_GAP_ARGS if planned else
                       [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7) + \
            [ctypes.c_void_p]
        return fn

    def runner(self, fn, planned):
        import torch

        K, D, L = self.K, self.D, self.L
        B = self.args[0].shape[0]
        consts = [self.m, self.mm, self.indel, L]
        if planned:
            from lra_tpu_torch.ops import _ext
            from lra_tpu_torch.ops import one_gap as og

            plan = og.one_gap_plan(K, D, B, _ext.sm_count(0))
            scratch = [torch.empty(max(1, plan["scratch"]),
                                   dtype=torch.uint8, device="cuda")]
            tail = [B, K, D] + consts + [plan[k] for k in og._OG_PLAN_KEYS]
        else:
            TP1, TS1, UP = D + K, D + K + 3, D + 3 * K + 4
            scratch = [torch.empty(n, dtype=dt, device="cuda") for n, dt in (
                (B * TP1 * (2 * K + 1), torch.int8),
                (B * TS1 * (2 * K + 4), torch.int8),
                (B * TP1, torch.float32), (B * TP1, torch.int32),
                (B * UP, torch.float32), (B * UP, torch.int32))]
            tail = [B, K, D] + consts

        head = [x.data_ptr() for x in self.args + scratch]

        def run():
            out = [torch.empty((B, L), dtype=torch.int8, device="cuda"),
                   torch.empty(B, dtype=torch.int32, device="cuda"),
                   torch.empty(B, dtype=torch.float32, device="cuda")]
            rc = fn(*head, *[x.data_ptr() for x in out], *tail,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"K6: CUDA launch failed ({rc})")
            return out
        run.scratch = scratch
        return run

    def wrapper(self):
        from lra_tpu_torch.ops import one_gap as og

        return og.one_gap_traced(*self.args, self.K, self.D, self.m,
                                 self.mm, self.indel, self.L)

    def plain(self):
        from lra_tpu_torch.ops import one_gap as og

        return og.one_gap_traced_plain(*self.args, self.K, self.D, self.m,
                                       self.mm, self.indel, self.L)


class P1:
    """banded_pallas_rowsync; inputs (q, t, qlen, tlen, K, m, mm, indel)
    and kband.  chip_smoke.py --save-p1 saves every P1 launch of each
    path.  An earlier tree's P1 is csrc/rowsync.cu (one CTA a problem,
    an int8 arrow plane in device memory) where it has one, else the
    rowsync_kernel of its csrc/banded_global.cu."""

    lib, src = "banded_global", "banded_global.cu"
    patches: dict = {}

    @staticmethod
    def source(tree: str) -> tuple:
        old = os.path.join(tree, "lra_tpu_torch", "csrc", "rowsync.cu")
        if os.path.exists(old):
            return old, "rowsync"
        return (os.path.join(tree, "lra_tpu_torch", "csrc", P1.src),
                P1.lib)

    @staticmethod
    def planned(src: str) -> bool:
        return not src.endswith("rowsync.cu")

    def __init__(self, args, kw):
        self.q, self.t, self.qlen, self.tlen = [a.cuda() for a in args[:4]]
        self.K, self.m, self.mm, self.indel = args[4:8]
        self.kband = kw["kband"].cuda()

    def plan(self) -> dict:
        from lra_tpu_torch.ops import _ext
        from lra_tpu_torch.ops import affine_pallas as ap

        return ap.rowsync_plan(self.q.shape[1], self.q.shape[0],
                               _ext.sm_count(0))

    def shape(self) -> str:
        B, S = self.q.shape
        return (f"B={B} S={S} K={self.K}; PPC {{PPC}} R {{R}} smem "
                f"{{smem}}, plane in shared memory: {{smem_plane}}"
                ).format(**self.plan())

    @staticmethod
    def entry(so: str, planned: bool):
        fn = ctypes.CDLL(so).lra_banded_pallas_rowsync
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       if planned else
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7) + \
            [ctypes.c_void_p]
        return fn

    def runner(self, fn, planned):
        import torch

        from lra_tpu_torch.ops import affine_pallas as ap

        q, K = self.q, self.K
        B, S = q.shape
        SP = ap._plane_width(S)
        plan = self.plan()
        scratch = torch.empty(16 + B * plan["plane_bytes"] if planned
                              else B * (S + 1) * (2 * K + 1),
                              dtype=torch.uint8, device="cuda")
        head = [x.data_ptr() for x in (q, self.t, self.qlen, self.tlen,
                                       self.kband)]
        consts = [B, S, SP, K, self.m, self.mm, self.indel]

        def run():
            P = torch.empty((B, SP), dtype=torch.uint8, device="cuda")
            if planned:
                args = head + [scratch.data_ptr() + 16, P.data_ptr(),
                               scratch.data_ptr()] + consts + \
                    [plan["PPC"], plan["R"], plan["smem"]]
            else:
                args = head + [scratch.data_ptr(), P.data_ptr()] + consts
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"P1: CUDA launch failed ({rc})")
            return P
        return run

    def wrapper(self):
        from lra_tpu_torch.ops import affine_pallas as ap

        return ap.banded_pallas_rowsync(
            self.q, self.t, self.qlen, self.tlen, self.K, self.m, self.mm,
            self.indel, kband=self.kband)

    def plain(self):
        from lra_tpu_torch.ops import affine_pallas as ap

        return ap.banded_pallas_rowsync_plain(
            self.q, self.t, self.qlen, self.tlen, self.K, self.m, self.mm,
            self.indel, self.kband)


class K3:
    """chain_mask_from_scores; inputs (V, bp, valid).  chip_smoke.py
    --save-k3 saves every K3 launch of each path."""

    lib, src = "chain_mask", "chain_mask.cu"
    planned_mark = "int ppb"        # the planned entry point's
    outs = ("vmax", "bits")
    patches: dict = {}

    def __init__(self, args, kw):
        self.args = [a.cuda() for a in args[:3]]

    def plan(self) -> dict:
        from lra_tpu_torch.ops import _ext
        from lra_tpu_torch.ops import sdp_blocked as sb

        B, N = self.args[0].shape
        return sb.mask_plan(N, B, _ext.sm_count(0))

    def shape(self) -> str:
        B, N = self.args[0].shape
        return (f"B={B} N={N}; tier {{tier}}, {{ppb}} a block, {{threads}} "
                f"threads, smem {{smem}}").format(**self.plan())

    @staticmethod
    def entry(so: str, planned: bool):
        fn = ctypes.CDLL(so).lra_chain_mask_from_scores
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * (6 if planned else 2) + [ctypes.c_void_p]
        return fn

    def runner(self, fn, planned):
        import torch

        B, N = self.args[0].shape
        plan = self.plan()
        head = [x.data_ptr() for x in self.args]

        def run():
            out = [torch.empty(B, dtype=torch.float32, device="cuda"),
                   torch.empty((B, N // 32), dtype=torch.int32,
                               device="cuda")]
            args = head + [x.data_ptr() for x in out] + [B, N]
            if planned:
                args += [plan[k] for k in ("tier", "ppb", "threads",
                                           "smem")]
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"K3: CUDA launch failed ({rc})")
            return out
        return run

    def wrapper(self):
        from lra_tpu_torch.ops import sdp_blocked as sb

        return sb.chain_mask_from_scores(*self.args)

    def plain(self):
        from lra_tpu_torch.ops import sdp_blocked as sb

        return sb.chain_mask_from_scores_plain(*self.args)


class K8:
    """chain_scores (the unblocked scan); inputs (qS, qE, tS, tE, score,
    lane1, lane2, valid, slope, inter, ceiling1, ceiling2).
    chip_smoke.py --save-k8 saves the mesh phase's input.  An earlier
    tree's csrc/sdp_scan.cu (one CTA a problem, before the redesign) or
    the scan instance of a tree's csrc/sdp_blocked.cu (scan_plan's
    plan)."""

    planned_mark = "scan_cta_kernel"
    patches: dict = {}

    def __init__(self, args, kw):
        self.args = [a.cuda() for a in args[:10]]
        self.c1, self.c2 = args[10:12]

    @staticmethod
    def source(tree: str) -> tuple:
        old = os.path.join(tree, "lra_tpu_torch", "csrc", "sdp_scan.cu")
        if os.path.exists(old):
            return old, "sdp_scan"
        return os.path.join(tree, "lra_tpu_torch", "csrc",
                            "sdp_blocked.cu"), "sdp_blocked"

    def shape(self) -> str:
        from lra_tpu_torch.ops import sdp

        B, N = self.args[0].shape
        return ("B={} N={}; tier {tier} threads {threads} smem {smem} "
                "scratch {scratch}".format(B, N, **sdp.scan_plan(N)))

    @staticmethod
    def entry(so: str, planned: bool):
        fn = ctypes.CDLL(so).lra_chain_scores_scan
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_float] * 2 +
                       [ctypes.c_int] * 5 if planned else
                       [ctypes.c_void_p] * 13 + [ctypes.c_float] * 2 +
                       [ctypes.c_int] * 3) + [ctypes.c_void_p]
        return fn

    def runner(self, fn, planned):
        import torch

        from lra_tpu_torch.ops import sdp

        B, N = self.args[0].shape
        head = [x.data_ptr() for x in self.args]
        plan = sdp.scan_plan(N)
        scratch = torch.empty(max(1, B * plan["scratch"]), dtype=torch.uint8,
                              device="cuda")
        # the earlier kernel's shared memory: slopes, intercepts and
        # reduction slots, and the columns (25 bytes a row) while they fit
        fixed = 2 * 24 * 4 + 2 * 32 * 8
        old_smem = fixed + 25 * N if fixed + 25 * N <= 232448 else fixed

        def run():
            out = [torch.empty((B, N), dtype=dt, device="cuda")
                   for dt in (torch.float32, torch.int32, torch.int32)]
            ptrs = head + [x.data_ptr() for x in out]
            if planned:
                args = ptrs + [scratch.data_ptr(), self.c1, self.c2, B, N,
                               plan["tier"], plan["threads"], plan["smem"]]
            else:
                args = ptrs + [self.c1, self.c2, B, N, old_smem]
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"K8: CUDA launch failed ({rc})")
            return out
        return run

    def wrapper(self):
        from lra_tpu_torch.ops import sdp

        return sdp.chain_scores(*self.args, self.c1, self.c2)

    def plain(self):
        from lra_tpu_torch.ops import sdp

        return sdp.chain_scores_plain(*self.args, self.c1, self.c2)


class K9:
    """banded_global_kernel (score and the full arrow plane); inputs (q,
    t, qlen, tlen, K, m, mm, indel) and kband.  chip_smoke.py --save-k9
    saves the mesh phase's input.  An earlier tree's
    csrc/banded_arrows.cu (one CTA a problem, before the redesign) or the
    arrows instance of a tree's csrc/banded_global.cu (arrows_plan's
    plan)."""

    planned_mark = "arrows_cta_kernel"     # not in banded_arrows.cu
    outs = ("score", "arrows")
    patches: dict = {}

    def __init__(self, args, kw):
        self.q, self.t, self.qlen, self.tlen = [a.cuda() for a in args[:4]]
        self.K, self.m, self.mm, self.indel = args[4:8]
        self.kband = kw["kband"].cuda()

    @staticmethod
    def source(tree: str) -> tuple:
        old = os.path.join(tree, "lra_tpu_torch", "csrc", "banded_arrows.cu")
        if os.path.exists(old):
            return old, "banded_arrows"
        return os.path.join(tree, "lra_tpu_torch", "csrc",
                            "banded_global.cu"), "banded_global"

    def plan(self) -> dict:
        from lra_tpu_torch.ops import _ext
        from lra_tpu_torch.ops import affine_kernel as ak

        return ak.arrows_plan(self.K, self.q.shape[0], _ext.sm_count(0))

    def shape(self) -> str:
        import chip_smoke as cs

        B, Q = self.q.shape
        return (f"B={B} S={Q} K={self.K}; "
                f"{cs.arrows_plan_str(self.plan(), self.K, self.t.shape[1])}")

    @staticmethod
    def entry(so: str, planned: bool):
        fn = ctypes.CDLL(so).lra_banded_arrows
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 13
                       if planned else
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8) + \
            [ctypes.c_void_p]
        return fn

    def runner(self, fn, planned):
        import torch

        from lra_tpu_torch.ops import affine_kernel as ak

        B, Q = self.q.shape
        T, K = self.t.shape[1], self.K
        head = [x.data_ptr() for x in (self.q, self.t, self.qlen, self.tlen,
                                       self.kband)]
        plan = self.plan()
        sp, smem = ak.arrows_launch(plan, K, T)
        counter = torch.empty(4, dtype=torch.int32, device="cuda")
        tail = [B, Q, T, K, self.m, self.mm, self.indel]
        if planned:
            tail += [plan["CPT"], plan["WP"], plan["PPC"], sp,
                     plan["threads"], smem]
        else:   # the earlier kernel: one thread a cell, at most 1024
            tail += [min(1024, 32 * -(-(2 * K + 1) // 32))]

        def run():
            out = [torch.empty(B, dtype=torch.float32, device="cuda"),
                   torch.empty((B, T + 1, 2 * K + 1), dtype=torch.int8,
                               device="cuda")]
            ptrs = head + [x.data_ptr() for x in out] + \
                ([counter.data_ptr()] if planned else [])
            rc = fn(*ptrs, *tail, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"K9: CUDA launch failed ({rc})")
            return out
        return run

    def wrapper(self):
        from lra_tpu_torch.ops import affine_kernel as ak

        return ak.banded_global_kernel(self.q, self.t, self.qlen, self.tlen,
                                       self.K, self.m, self.mm, self.indel,
                                       kband=self.kband)

    def plain(self):
        from lra_tpu_torch.ops import affine_kernel as ak

        return ak.banded_global_kernel_plain(
            self.q, self.t, self.qlen, self.tlen, self.K, self.m, self.mm,
            self.indel, self.kband)


KERNELS = {"k2": K2, "k4": K4, "k6": K6, "p1": P1, "k3": K3, "k8": K8,
           "k9": K9}
PLAN_KEYS = ("tier", "threads", "smem")     # K2's planned entry point


def device_ms(run, n: int = BACK_TO_BACK) -> tuple:
    """(device ms a call, kernels a call) of n calls of run under
    torch.profiler: every kernel it launched, no memset or copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    tot, cnt = 0.0, 0
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        if dt and ev.device_type == torch.autograd.DeviceType.CUDA and \
                "Memset" not in ev.key and "Memcpy" not in ev.key:
            tot += dt
            cnt += ev.count
    return tot / 1e3 / n, cnt / n


def exact_all(cs, spec, name, got, ref) -> None:
    if isinstance(ref, (tuple, list)):
        for nm, x, y in zip(getattr(spec, "outs", ("V", "bp", "lane")),
                            got, ref):
            cs.exact(f"{name} {nm}", x, y)
    else:
        cs.exact(name, got, ref)


def main() -> int:
    import torch

    import chip_smoke as cs
    from lra_tpu_torch.ops import _ext

    argv = [a for a in sys.argv[1:] if a != "--phases"]
    if not torch.cuda.is_available() or len(argv) < 3 or \
            argv[0] not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 1
    spec = KERNELS[argv[0]]
    inputs = torch.load(argv[1])
    _ext.build_all()
    built = []      # (tree, entry point, planned?)
    for tr in [ROOT] + argv[2:]:
        src, lib = source(spec, tr)
        so = (os.path.join(_ext.BUILD_DIR, f"lib{lib}.so") if tr == ROOT
              else nvcc_build(src, os.path.join(tr, f"_{argv[0]}_build"),
                              lib))
        planned = is_planned(spec, src)
        built.append(("this" if tr == ROOT else tr,
                      spec.entry(so, planned), planned))
    cut = []        # (label, entry) of the phase-cut copies
    if "--phases" in sys.argv:
        for tr, _, planned in built[1:]:
            if planned:
                continue
            src, lib = source(spec, tr)
            for k, (name, patch) in enumerate(spec.patches.items()):
                so = nvcc_build(src, os.path.join(tr, f"_{argv[0]}_cut{k}"),
                                lib, patch)
                cut.append((f"{tr} {name}", spec.entry(so, False)))
    cs.log(cs.smi_line())
    sums: dict = {}     # path: [device ms summed over its launches, per tree]
    for label, (args, kw) in inputs.items():
        k = spec(args, kw)
        runs = [k.runner(fn, planned) for _, fn, planned in built]
        names = [tr for tr, _, _ in built]
        ref = k.plain()
        for tr, run in zip(names, runs):
            exact_all(cs, spec, f"{argv[0]} of {tr} [{label}]", run(), ref)
        exact_all(cs, spec, f"{argv[0]} [{label}]", k.wrapper(), ref)
        torch.cuda.synchronize()
        first = [cs.cuda_ms(run, 10) for run in runs]
        mine = [cs.cuda_ms(k.wrapper, 10), cs.cuda_ms(k.wrapper, 10)]
        last = [cs.cuda_ms(run, 10) for run in runs[::-1]][::-1]
        parts = [(n, cs.cuda_ms(f, 10)) for n, f in k.parts()] \
            if hasattr(k, "parts") else []
        cs.log(f"{argv[0]} [{label}] {k.shape()}, all exact; this through "
               f"its wrapper {mine[0]:.4f}, {mine[1]:.4f} ms"
               + "".join(f" ({n} {t:.4f})" for n, t in parts)
               + "; runners: "
               + "; ".join(f"{tr} {a:.4f}, {b:.4f} ms"
                           for tr, a, b in zip(names, first, last)))
        # back to back: the card's time per launch, the host's enqueue
        # hidden behind the launches before it
        # (two rounds, the second in reverse order)
        b2b = [[cs.cuda_ms(lambda: [run() for _ in range(BACK_TO_BACK)], 3)
                / BACK_TO_BACK for run in rnd] for rnd in (runs, runs[::-1])]
        b2b[1] = b2b[1][::-1]
        cs.log(f"{argv[0]} [{label}] back to back, ms per launch: "
               + "; ".join(f"{tr} {a:.4f}, {b:.4f}"
                           for tr, a, b in zip(names, *b2b)))
        dev = [device_ms(run) for run in runs]
        path = label.split(" #")[0]
        sums[path] = [a + t for a, (t, _) in
                      zip(sums.get(path, [0.0] * len(runs)), dev)]
        cs.log(f"{argv[0]} [{label}] device time under the profiler, ms a "
               f"call: " + "; ".join(f"{tr} {t:.4f} ({k:g} kernels)"
                                     for tr, (t, k) in zip(names, dev)))
        if cut:
            whole = [cs.cuda_ms(lambda: [run() for _ in range(BACK_TO_BACK)],
                                3) / BACK_TO_BACK for run in runs[1:]]
            res = [(n, cs.cuda_ms(lambda r=k.runner(fn, False):
                                  [r() for _ in range(BACK_TO_BACK)], 3)
                    / BACK_TO_BACK) for n, fn in cut]
            cs.log(f"{argv[0]} [{label}] phase split, back to back, ms per "
                   f"launch: whole " + ", ".join(f"{w:.4f}" for w in whole)
                   + "; " + "; ".join(f"{n} {t:.4f}" for n, t in res))
    if any(" #" in label for label in inputs):
        for path, tot in sums.items():
            cs.log(f"{argv[0]} [{path}] device time of the recorded launches "
                   f"summed (a run's), ms: " + "; ".join(
                       f"{tr} {t:.4f}" for tr, t in zip(names, tot)))
    cs.log(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
