// Single-best chain traceback to a bitmask (K3): chain_mask_from_scores.
//
// Replaces lra_tpu/ops/sdp_blocked.py:chain_mask_from_scores (a max, an
// argmax and an N-step lax.scan walk).  Same outputs, bit for bit:
//   * vmax = max over rows of where(valid, V, NEG), NEG = -3e38;
//   * the walk starts at the FIRST row holding vmax, or nowhere when
//     vmax <= 0;
//   * it sets the bit of every row it visits and follows bp while the
//     row is >= 0, for at most N steps;
//   * word w of a problem's int32[N/32] holds rows 32w .. 32w+31, row
//     32w + k in bit k.
// bp entries must be < N (K2's backpointers are -1 or an earlier row).
//
// Design: one CTA (256 threads) per problem.  A block argmax (ties to
// the smaller row), then thread 0 walks bp into a bitmask in shared
// memory (N <= 8192: at most 256 words), then the CTA stores the words.
// Bound: latency.  The argmax reads V and valid once (bytes); the walk
// is a chain of dependent global loads, one per chain fragment.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr float NEG = -3.0e38f;

// (value, row) max with the smaller row winning ties
__device__ __forceinline__ void better_first(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(NTHREADS)
chain_mask_kernel(const float* __restrict__ V, const int* __restrict__ bp,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ vmax_out, int* __restrict__ bits_out,
                  int N) {
  extern __shared__ unsigned s_mask[];  // N / 32 words
  __shared__ float s_v[NTHREADS / 32];
  __shared__ int s_i[NTHREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int W = N / 32;
  V += (size_t)b * N;
  bp += (size_t)b * N;
  valid += (size_t)b * N;

  for (int w = tid; w < W; w += NTHREADS) s_mask[w] = 0u;
  float bv = -INFINITY;
  int bi = N;
  for (int x = tid; x < N; x += NTHREADS) {
    const float v = valid[x] ? V[x] : NEG;
    if (v > bv) {  // ascending rows: the first keeps a tie
      bv = v;
      bi = x;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    better_first(bv, bi, ov, oi);
  }
  if (lane == 0) {
    s_v[warp] = bv;
    s_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < NTHREADS / 32; ++w) better_first(bv, bi, s_v[w], s_i[w]);
    vmax_out[b] = bv;
    int cur = bv > 0.f ? bi : -1;
    for (int s = 0; s < N && cur >= 0 && cur < N; ++s) {
      s_mask[cur >> 5] |= 1u << (cur & 31);
      cur = bp[cur];
    }
  }
  __syncthreads();
  for (int w = tid; w < W; w += NTHREADS)
    bits_out[(size_t)b * W + w] = (int)s_mask[w];
}

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// V: f32 [B, N]; bp: int32 [B, N]; valid: bool [B, N]; N % 32 == 0.
// Out: vmax f32 [B], bits int32 [B, N/32].
extern "C" int lra_chain_mask_from_scores(const void* V, const void* bp,
                                          const void* valid, void* vmax,
                                          void* bits, int B, int N,
                                          void* stream) {
  const size_t smem = (size_t)(N / 32) * sizeof(unsigned);
  chain_mask_kernel<<<B, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)V, (const int*)bp, (const uint8_t*)valid, (float*)vmax,
      (int*)bits, N);
  return (int)cudaGetLastError();
}
