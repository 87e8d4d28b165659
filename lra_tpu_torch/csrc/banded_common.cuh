// Shared pieces of the banded DP kernels, banded_global.cu (K4 and P1)
// and banded_refine.cu (K5): the op codes, NEGF and the q pad code, the
// cp.async staging of plane rows into shared memory, and the named
// barrier of a problem's warps.  Each kernel computes its band rows at
// warp level with its own code; P1 runs K4's rows (banded_global.cu's
// rowsync_kernel).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lra {

constexpr float NEGF = -1.0e30f;
constexpr int DONE = 0, LEFT = 1, DOWN = 2, DIAG = 3;
constexpr int QPAD = 5;  // q code outside [0, Q): never equals a t code
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Rows [lo, lo + n) of a plane (pitch P bytes, 16-byte aligned) into
// shared memory, one warp, 16-byte copies; one commit group.
__device__ __forceinline__ void stage_rows(uint8_t* dst, const void* pl,
                                           int lo, int n, int P, int lane) {
  const int nv = n * P / 16;
  const uint8_t* src = (const uint8_t*)pl + (size_t)lo * P;
  for (int v = lane; v < nv; v += 32) cp_async16(dst + 16 * v, src + 16 * v);
  asm volatile("cp.async.commit_group;\n" ::);
}

// A named barrier of nthreads threads (whole warps).
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

}  // namespace lra

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
