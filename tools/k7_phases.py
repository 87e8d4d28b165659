#!/usr/bin/env python3
"""Per-phase time of K7 (lra_tpu_torch/csrc/sdp_windowed.cu) on the card.

    python3 tools/k7_phases.py      # from the repository root, one H100

Writes a copy of the kernel source with clock64() marks between its
phases (a block barrier before each mark, so the copy runs a little
slower than the kernel), builds it with nvcc into lra_tpu_torch/_build/,
runs it on contig-like problems (lra_tpu_torch.sim.contig_chain_arrays,
numpy seed 0) at clusters of 8 and 16 CTAs, checks V/bp/lane against
the plain twin, and prints the cycles per block of 64 rows, in µs at the
card's maximum SM clock, for thread 0 of the leader (rank 0) and of the
first window CTA (rank 1).  The marks are anchored on comment lines of
the source; the script stops if one is missing."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("top", "refresh", "closure | setup", "near", "barrier 1", "merge",
          "stage+edges", "vfin", "recovery", "-", "ring", "barrier 2")

MARKS = (
    ("  for (int b = 0; b < nb; ++b) {\n    const int b0 = b * L;\n",
     "  long long tlast = clock64();\n"
     "  for (int b = 0; b < nb; ++b) {\n    const int b0 = b * L;\n"
     "    MARK(0);\n"),
    ("      cluster.sync();  // P1/P2 are complete for the leader's gather\n"
     "    }\n",
     "      cluster.sync();  // P1/P2 are complete for the leader's gather\n"
     "    }\n    MARK(1);\n"),
    ("      const float* res = closure(",
     "      MARK(6);\n      const float* res = closure("),
    ("    __syncthreads();\n\n    // ---- near window",
     "    MARK(2);\n\n    // ---- near window"),
    ("    cluster.sync();  // every CTA's partials are written\n",
     "    MARK(3);\n    cluster.sync();  // every CTA's partials are written\n"
     "    MARKN(4);\n"),
    ("      const float* Cm = s_clo;", "      MARK(5);\n"
     "      const float* Cm = s_clo;"),
    ("      __syncthreads();\n\n      // ---- bp/lane recovery",
     "      MARK(7);\n\n      // ---- bp/lane recovery"),
    ("      __syncthreads();\n\n      // ---- the finished block into",
     "      MARK(8);\n\n      // ---- the finished block into"),
    ("    cluster.sync();  // the block is in V and in its owner's ring\n",
     "    MARK(10);\n"
     "    cluster.sync();  // the block is in V and in its owner's ring\n"
     "    MARKN(11);\n"),
)
HEAD = """namespace cg = cooperative_groups;
__device__ long long g_prof[2][16];
#define MARK(i) do { __syncthreads(); MARKN(i); } while (0)
#define MARKN(i) do { if (threadIdx.x == 0 && rank < 2) { \\
    long long t_ = clock64(); g_prof[rank][i] += t_ - tlast; tlast = t_; \\
  } } while (0)"""
TAIL = """
extern "C" int lra_prof_read(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(g_prof));
}
"""


def instrumented_source(src: str) -> str:
    src = src.replace("namespace cg = cooperative_groups;", HEAD, 1)
    for old, new in MARKS:
        if old not in src:
            raise SystemExit(f"k7_phases: anchor not found in the kernel "
                             f"source: {old.strip()[:60]!r}")
        src = src.replace(old, new, 1)
    return src + TAIL


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k7_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lra_tpu_torch import preset
    from lra_tpu_torch.chain import driver
    from lra_tpu_torch.ops import _ext
    from lra_tpu_torch.ops import sdp_windowed as sw
    from lra_tpu_torch.ops.gapcost import from_options
    from lra_tpu_torch.ops.sdp_blocked import _pwl_host_params
    from lra_tpu_torch.sim import contig_chain_arrays

    out = os.path.join(_ext.BUILD_DIR, "k7_phases")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "sdp_windowed_phases.cu")
    with open(os.path.join(_ext.SRC_DIR, "sdp_windowed.cu")) as f:
        text = instrumented_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(out, "libk7_phases.so")
    r = subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-I", _ext.SRC_DIR,
                        "-o", so, src], capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    fn = lib.lra_chain_scores_windowed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True)
        .stdout.split()[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"(max SM {mhz:.0f} MHz)")
    key = from_options(preset("contig")).static_key()
    pwl = _pwl_host_params(key)
    for n, N, W in ((20322, 24576, 4096), (14195, 16384, 4096),
                    (16000, 16384, 16384), (1600, 1664, 64)):
        plist = [driver.ChainProblem(*contig_chain_arrays(
            np.random.default_rng(0), n))]
        a = [torch.from_numpy(x).cuda() for x in
             driver.pad_problems(plist, 1, N) +
             driver.pad_far_schedules(plist, 1, N)]
        ref = sw.chain_scores_windowed_plain(*a, key, W=W)
        for C in (8, 16):
            V = torch.empty((1, N), dtype=torch.float32, device="cuda")
            bp = torch.empty((1, N), dtype=torch.int32, device="cuda")
            ln = torch.empty_like(bp)
            scratch = torch.empty((2, 1, N), dtype=torch.float32,
                                  device="cuda")
            buf = (ctypes.c_longlong * 32)()
            for _ in range(2):      # the first run warms up
                lib.lra_prof_read(buf)
                rc = fn(*[x.data_ptr() for x in a], V.data_ptr(),
                        bp.data_ptr(), ln.data_ptr(), scratch.data_ptr(),
                        ctypes.addressof(pwl), 1, N, W,
                        sw._refresh_blocks(64, W, N), C,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"k7_phases: launch failed ({rc})")
                torch.cuda.synchronize()
            lib.lra_prof_read(buf)
            exact = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                        for x, y in zip((V, bp, ln), ref))
            print(f"N={N} W={W} C={C} ({n} fragments), exact {exact}, "
                  f"µs per block:")
            nb = N // 64
            for rk, who in ((0, "leader"), (1, "window CTA")):
                print(f"  {who:10s} " + ", ".join(
                    f"{p} {buf[16 * rk + i] / nb / mhz:.2f}"
                    for i, p in enumerate(PHASES) if buf[16 * rk + i]))
            if not exact:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
