// Single-best chain traceback to a bitmask (K3): chain_mask_from_scores.
//
// Replaces lra_tpu/ops/sdp_blocked.py:chain_mask_from_scores (:143; a
// max, an argmax and an N-step lax.scan walk).  Same outputs, bit for
// bit:
//   * vmax = max over rows of where(valid, V, NEG), NEG = -3e38;
//   * the walk starts at the FIRST row holding vmax, or nowhere when
//     vmax <= 0;
//   * it sets the bit of every row it visits and follows bp while the
//     row is >= 0 and < N, for at most N steps;
//   * word w of a problem's int32[N/32] holds rows 32w .. 32w+31, row
//     32w + k in bit k.
//
// Bound: the bytes, V and valid read once (5 B a row), bp read for the
// rows the walk visits, vmax and the words written once; on the only
// launch chip_smoke.py's driver path makes (CCS SDP-2 with
// need_full=False, B=256 N=64: 82 KB) that is ~0.03 us of HBM time, so
// a launch is bound by its latency: one pass over a problem's rows and
// then one dependent load per chain row.
//
// Design (ops/sdp_blocked.py:mask_plan chooses the tier):
// - N <= 1024, the warp tier: one warp a problem, PPB problems a block
//   (8 when the bucket gives every SM 8 warps, else fewer, so that a
//   small bucket spreads over the SMs).  The warp reads V as float4 and
//   valid as 4 bytes, 4 rows a lane a turn, and copies bp's 16 bytes of
//   the same rows into shared memory with cp.async as it reads (4 KB a
//   problem at N = 1024).  Each lane keeps the first of its own maxima;
//   a 5-step shuffle merges them by (value, then smaller row), a total
//   order, so the first row of vmax wins.  Lane 0 then walks bp in shared
//   memory, one dependent shared load (~30 cycles) a step instead of a
//   global one: the current mask word stays in a register and is OR-ed
//   into shared memory when the walk leaves it.  The <= 32 words go out
//   one a lane, in one coalesced store.
// - N > 1024 up to 8192, the CTA tier: one CTA of 32 * ceil(N / 256)
//   threads (at most 1024) a problem, the same loads and cp.async
//   staging (bp up to 32 KB), a block argmax (warps, then warp 0 over
//   their winners), thread 0's walk from shared memory and a block-wide
//   store of the words.
// - With vmax <= 0 a problem costs its pass over the rows and its zero
//   words: the walk does not start.
// Each lane's or thread's rows are whole 16-byte vectors (N % 32 == 0;
// the wrapper checks 16-byte aligned V and bp and 4-byte aligned valid).
//
// ptxas (sm_90a, chip_smoke.py logs it): 32 registers in the warp tier,
// 27 in the CTA tier (256 bytes of static shared memory), no spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 48 * 1024;  // no opt-in: N <= 8192 stays below

// (value, row) max with the smaller row winning ties
__device__ __forceinline__ void better_first(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    better_first(v, i, ov, oi);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// One thread's share of a problem's rows: 4-row vectors first, first +
// stride, ... in ascending order, keeping the first of its maxima in (bv,
// bi); bp's vectors go to s_bp by cp.async (one commit group).
__device__ __forceinline__ void scan_rows(const float* V, const int* bp,
                                          const uint8_t* valid, int* s_bp,
                                          int N, int first, int stride,
                                          float& bv, int& bi) {
  for (int x = first; x < N / 4; x += stride) {
    cp_async16(s_bp + 4 * x, bp + 4 * x);
    const float4 v = __ldg((const float4*)V + x);
    const unsigned ok = __ldg((const unsigned*)valid + x);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float y = (ok >> (8 * c)) & 0xffu ? e[c] : NEG;
      if (y > bv) {  // ascending rows: the first keeps a tie
        bv = y;
        bi = 4 * x + c;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The walk from row cur (none when cur < 0) over bp in shared memory,
// setting the bit of every row visited in s_mask (zeroed by the caller).
__device__ __forceinline__ void walk_mask(const int* s_bp, unsigned* s_mask,
                                          int cur, int N) {
  int w = -1;
  unsigned bits = 0;
  for (int s = 0; s < N && cur >= 0 && cur < N; ++s) {
    const int next = s_bp[cur];
    if (cur >> 5 != w) {
      if (w >= 0) s_mask[w] |= bits;
      w = cur >> 5;
      bits = 0;
    }
    bits |= 1u << (cur & 31);
    cur = next;
  }
  if (w >= 0) s_mask[w] |= bits;
}

__global__ void __launch_bounds__(256)
chain_mask_warp_kernel(const float* __restrict__ V,
                       const int* __restrict__ bp,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ vmax_out,
                       int* __restrict__ bits_out, int B, int N) {
  extern __shared__ __align__(16) int smem_w[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int W = N / 32;
  int* s_bp = smem_w + warp * (N + 32);  // bp, then <= 32 mask words
  unsigned* s_mask = (unsigned*)(s_bp + N);
  float bv = -INFINITY;
  int bi = N;
  scan_rows(V + (size_t)b * N, bp + (size_t)b * N, valid + (size_t)b * N,
            s_bp, N, lane, 32, bv, bi);
  warp_best(bv, bi);
  if (lane < W) s_mask[lane] = 0u;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) {
    vmax_out[b] = bv;
    walk_mask(s_bp, s_mask, bv > 0.f ? bi : -1, N);
  }
  __syncwarp();
  if (lane < W) bits_out[(size_t)b * W + lane] = (int)s_mask[lane];
}

__global__ void __launch_bounds__(1024)
chain_mask_cta_kernel(const float* __restrict__ V,
                      const int* __restrict__ bp,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ vmax_out,
                      int* __restrict__ bits_out, int N) {
  extern __shared__ __align__(16) int smem_c[];
  __shared__ float s_v[32];
  __shared__ int s_i[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int W = N / 32;
  int* s_bp = smem_c;  // bp, then the N / 32 mask words
  unsigned* s_mask = (unsigned*)(smem_c + N);
  for (int w = tid; w < W; w += blockDim.x) s_mask[w] = 0u;
  float bv = -INFINITY;
  int bi = N;
  scan_rows(V + (size_t)b * N, bp + (size_t)b * N, valid + (size_t)b * N,
            s_bp, N, tid, blockDim.x, bv, bi);
  warp_best(bv, bi);
  if (lane == 0) {
    s_v[warp] = bv;
    s_i[warp] = bi;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    bv = lane < nw ? s_v[lane] : -INFINITY;
    bi = lane < nw ? s_i[lane] : N;
    warp_best(bv, bi);
    if (lane == 0) {
      vmax_out[b] = bv;
      walk_mask(s_bp, s_mask, bv > 0.f ? bi : -1, N);
    }
  }
  __syncthreads();
  for (int w = tid; w < W; w += blockDim.x)
    bits_out[(size_t)b * W + w] = (int)s_mask[w];
}

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// V: f32 [B, N]; bp: int32 [B, N]; valid: bool [B, N]; N % 32 == 0, N <=
// 8192.  Out: vmax f32 [B], bits int32 [B, N/32].  tier, ppb, threads
// and smem from ops/sdp_blocked.py:mask_plan (tier 0: a warp a problem,
// ppb a block; 1: a CTA of `threads` a problem).
extern "C" int lra_chain_mask_from_scores(const void* V, const void* bp,
                                          const void* valid, void* vmax,
                                          void* bits, int B, int N, int tier,
                                          int ppb, int threads, int smem,
                                          void* stream) {
  if (B == 0) return 0;
  if (N % 32 || N <= 0 || N > 8192 || smem > SMEM_LIMIT || threads % 32 ||
      threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tier == 0) {
    if (ppb < 1 || threads != 32 * ppb || smem != ppb * 4 * (N + 32))
      return (int)cudaErrorInvalidValue;
    chain_mask_warp_kernel<<<(B + ppb - 1) / ppb, threads, smem, st>>>(
        (const float*)V, (const int*)bp, (const uint8_t*)valid,
        (float*)vmax, (int*)bits, B, N);
  } else if (tier == 1) {
    if (smem != 4 * (N + N / 32)) return (int)cudaErrorInvalidValue;
    chain_mask_cta_kernel<<<B, threads, smem, st>>>(
        (const float*)V, (const int*)bp, (const uint8_t*)valid,
        (float*)vmax, (int*)bits, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
