#!/usr/bin/env python3
"""Per-phase time of K2's CTA tier (lra_tpu_torch/csrc/sdp_blocked.cu) on
the card.

    python3 chip_smoke.py --save-k2 PATH      # each path's largest K2 input
    python3 tools/k2_phases.py PATH           # from the repository root

Writes a copy of the kernel source with clock64() marks between its
phases, builds it with nvcc into lra_tpu_torch/_build/k2_phases/, runs it
with sdp_plan's plan on each recorded input of N >= 128 (the CTA tier),
checks V/bp/lane against the plain twin, and prints the cycles per
problem, in µs at the card's maximum SM clock, for lane 0 of warp 0
(the resolver) and of warp 1 (the first folding warp): loading the
PWL tables, the set-up (n_eff, receiver lists, block 0's triangle), phase
A (the fold into the next block, all threads), phase B (the resolve; the
fold into later blocks; the next triangle) and the wait at B's barrier.
The marks are anchored on lines of the source; the script stops if one
is missing."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("set-up", "A: fold into the next block", "B: resolve",
          "B: next record, fold into later blocks", "B: next triangle",
          "B: barrier", "PWL tables")
MARKS = (
    ("  const int warp = tid >> 5;\n  pwl_load(s_pw, ph);\n",
     "  const int warp = tid >> 5;\n  long long tlast = clock64();\n"
     "  pwl_load(s_pw, ph);\n"),
    ("  if (tid == 0) s_last = -1;\n  __syncthreads();\n",
     "  if (tid == 0) s_last = -1;\n  __syncthreads();\n  MARK(6);\n"
     "  if (tid == 0) atomicAdd(&g_prof[0][15], 1ull);\n"),
    ("lane);\n  __syncthreads();\n  for (int b = 0;",
     "lane);\n  __syncthreads();\n  MARK(0);\n  for (int b = 0;"),
    ("                 NT);\n    __syncthreads();\n",
     "                 NT);\n    __syncthreads();\n    MARK(1);\n"
     "    if (tid == 0) atomicAdd(&g_prof[0][14], 1ull);\n"),
    ("&st[b & 1], lane);\n",
     "&st[b & 1], lane);\n      MARK(2);\n"),
    ("                    cost, tid - 32, NT - 32);\n",
     "                    cost, tid - 32, NT - 32);\n      MARK(3);\n"),
    ("                 (NT >> 5) - 1, lane);\n      }\n    }\n"
     "    __syncthreads();\n",
     "                 (NT >> 5) - 1, lane);\n      }\n      MARK(4);\n"
     "    }\n    __syncthreads();\n    MARK(5);\n"),
)
HEAD = """namespace {
__device__ unsigned long long g_prof[2][16];
}
#define MARK(i) do { if (lane == 0 && warp < 2) { \\
    long long t_ = clock64(); \\
    atomicAdd(&g_prof[warp][i], \\
              (unsigned long long)(t_ - tlast)); tlast = t_; } } while (0)
"""
TAIL = """
extern "C" int lra_prof_read(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(g_prof));
}
"""


def instrumented_source(src: str) -> str:
    src = src.replace('#include "pwl.cuh"\n', '#include "pwl.cuh"\n' + HEAD,
                      1)
    for old, new in MARKS:
        if old not in src:
            raise SystemExit(f"k2_phases: anchor not found in the kernel "
                             f"source: {old.strip()[:60]!r}")
        src = src.replace(old, new, 1)
    return src + TAIL


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import sdp_blocked as sb

    out = os.path.join(_ext.BUILD_DIR, "k2_phases")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "sdp_blocked_phases.cu")
    with open(os.path.join(_ext.SRC_DIR, "sdp_blocked.cu")) as f:
        text = instrumented_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(out, "libk2_phases.so")
    r = subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-I", _ext.SRC_DIR,
                        "-o", so, src], capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    fn = lib.lra_chain_scores_blocked
    fn.restype = ctypes.c_int
    fn.argtypes = sb._SDP_ARGS + [ctypes.c_void_p]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True)
        .stdout.split()[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"(max SM {mhz:.0f} MHz)")
    inputs = torch.load(sys.argv[1])
    for label, (args, _kw) in inputs.items():
        a = [x.cuda() for x in args[:8]]
        key = args[8]
        B, N = a[0].shape
        if N < 128:
            continue
        plan = sb.sdp_plan(N)
        ref = sb.chain_scores_blocked_plain(*a, key)
        V = torch.empty((B, N), dtype=torch.float32, device="cuda")
        bp = torch.empty((B, N), dtype=torch.int32, device="cuda")
        ln = torch.empty_like(bp)
        buf = (ctypes.c_longlong * 32)()
        for _ in range(2):      # the first run warms up
            lib.lra_prof_read(buf)
            rc = fn(*[x.data_ptr() for x in a + [V, bp, ln]],
                    ctypes.addressof(sb._pwl_host_params(key)), B, N,
                    *[plan[k] for k in sb._PLAN_KEYS],
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"k2_phases: launch failed ({rc})")
            torch.cuda.synchronize()
        lib.lra_prof_read(buf)
        exact = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                    for x, y in zip((V, bp, ln), ref))
        probs, blocks = buf[15], buf[14]
        print(f"[{label}] B={B} N={N} ({sb.plan_str(plan)}), exact {exact}; "
              f"{probs} problems, {blocks} block steps past the first; µs "
              f"per problem (resolver / first folder):")
        for i, p in enumerate(PHASES):
            if buf[i] or buf[16 + i]:
                print(f"  {p:28s} {buf[i] / probs / mhz:8.2f} / "
                      f"{buf[16 + i] / probs / mhz:8.2f}")
        if not exact:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
