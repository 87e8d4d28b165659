// Shared pieces of the banded DP kernels (banded_global.cu, rowsync.cu,
// banded_refine.cu): op codes, a block-wide prefix-max scan, and the
// forward row of the linear-gap banded global DP.  banded_global.cu and
// rowsync.cu both call banded_row(), so their forward passes cannot
// drift apart.
//
// Layout: one CTA per problem.  A row of the band (2K+1 diagonal offsets
// d, cell i = j + d - K) is spread over the CTA, thread t owning the CPT
// contiguous cells [t*CPT, t*CPT + CPT).  CPT is 1 up to a band of 1024
// and 2 for the widest tier (K=512, band 1025).
//
// Exactness: every DP value is a small integer (or NEGF) held in f32, so
// sums are exact and maxima are order-free.  The in-row insertion chain
// (lra_tpu's log2(band) max-plus doubling) is computed as
//   row[d] = indel*d + prefixmax_e<=d (base[e] - indel*e),
// which is the same value: both are max_e base[e] + indel*(d - e), and a
// NEGF term stays NEGF under either grouping (|indel * band| is far below
// half an ulp of 1e30).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lra {

constexpr float NEGF = -1.0e30f;
constexpr int DONE = 0, LEFT = 1, DOWN = 2, DIAG = 3;
constexpr int QPAD = 5;  // q code outside [0, Q): never equals a t code

// Inclusive and exclusive prefix max over the CTA's cells, NV arrays at
// once.  x[v][c] is the value of cell t*CPT + c; on return incl holds the
// max over cells <= it and excl the max over cells < it (-INF for cell 0).
// s_warp: NV*32 floats of shared memory.  Ends with a barrier, so s_warp
// may be reused by the caller's next scan.
template <int CPT, int NV>
__device__ __forceinline__ void block_scan_max(const float (&x)[NV][CPT],
                                               float (&incl)[NV][CPT],
                                               float (&excl)[NV][CPT],
                                               float* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float wpre[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float run = -INFINITY;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      excl[v][c] = run;  // thread-local part, completed below
      run = fmaxf(run, x[v][c]);
      incl[v][c] = run;
    }
    float s = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = fmaxf(s, y);
    }
    // exclusive within the warp
    float e = __shfl_up_sync(0xffffffffu, s, 1);
    wpre[v] = lane == 0 ? -INFINITY : e;
    if (lane == 31) s_warp[v * 32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float s = lane < nwarps ? s_warp[v * 32 + lane] : -INFINITY;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s = fmaxf(s, y);
      }
      // exclusive over warps: max of the warps before this one
      const float e = __shfl_up_sync(0xffffffffu, s, 1);
      __syncwarp();
      s_warp[v * 32 + lane] = lane == 0 ? -INFINITY : e;
    }
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float before = fmaxf(s_warp[v * 32 + warp], wpre[v]);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      excl[v][c] = fmaxf(excl[v][c], before);
      incl[v][c] = fmaxf(incl[v][c], before);
    }
  }
  __syncthreads();
}

// One problem of a banded bucket, as the CTA sees it.
struct Band {
  const int8_t* q;  // [Q] codes
  const int8_t* t;  // [T] codes
  int Q, T, K, band, qlen, tlen, kband;
  float m, mm, indel;
};

// Row 0 of the linear-gap DP: P[i, 0] = indel * i inside the band.
template <int CPT>
__device__ __forceinline__ void banded_row0(const Band& p, float* cur,
                                            int8_t* arrow_row) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = threadIdx.x * CPT + c;
    if (d >= p.band) continue;
    const int offs = d - p.K;
    const bool inb = offs >= -p.kband && offs <= p.kband;
    cur[d] = (offs >= 0 && inb) ? p.indel * (float)offs : NEGF;
    arrow_row[d] =
        inb ? (int8_t)(offs > 0 ? LEFT : (offs == 0 ? DONE : -1)) : (int8_t)-1;
  }
  if (threadIdx.x == 0) cur[p.band] = NEGF;
}

// Forward DP row j >= 1 of lra_tpu/ops/affine_kernel.py:_banded_arrows:
// reads row j-1 from prev[0..band] (prev[band] == NEGF), writes row j to
// cur[0..band] and its arrows (tie order LEFT > DOWN > DIAG; the i=0
// column is DOWN; -1 outside the valid cells) to arrow_row.
template <int CPT>
__device__ __forceinline__ void banded_row(const Band& p, int j,
                                           const float* prev, float* cur,
                                           int8_t* arrow_row, float* s_warp) {
  float g[1][CPT], gi[1][CPT], ge[1][CPT];
  float sDel[CPT];
  bool valid[CPT], is_i0[CPT];
  const int tj = p.t[j - 1];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = threadIdx.x * CPT + c;
    g[0][c] = -INFINITY;
    valid[c] = false;
    is_i0[c] = false;
    sDel[c] = NEGF;
    if (d >= p.band) continue;
    const int offs = d - p.K;
    const int i = j + offs;
    const int qi = i - 1;
    const int qc = (qi >= 0 && qi < p.Q) ? p.q[qi] : QPAD;
    const float sub = qc == tj ? p.m : p.mm;
    const float sMat = prev[d] + sub;
    sDel[c] = prev[d + 1] + p.indel;
    float base = fmaxf(sMat, sDel[c]);
    is_i0[c] = i == 0;
    if (is_i0[c]) base = p.indel * (float)j;
    valid[c] = i >= 0 && i <= p.qlen && j <= p.tlen && offs >= -p.kband &&
               offs <= p.kband;
    if (!valid[c]) base = NEGF;
    g[0][c] = base - p.indel * (float)d;
  }
  block_scan_max<CPT, 1>(g, gi, ge, s_warp);
  float row[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = threadIdx.x * CPT + c;
    row[c] = valid[c] ? gi[0][c] + p.indel * (float)d : NEGF;
    if (d < p.band) cur[d] = row[c];
  }
  if (threadIdx.x == 0) cur[p.band] = NEGF;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = threadIdx.x * CPT + c;
    if (d >= p.band) continue;
    const float left = d > 0 ? cur[d - 1] : NEGF;
    int a = row[c] == left + p.indel ? LEFT
                                     : (row[c] == sDel[c] ? DOWN : DIAG);
    if (is_i0[c]) a = DOWN;
    if (!valid[c]) a = -1;
    arrow_row[d] = (int8_t)a;
  }
}

}  // namespace lra

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
