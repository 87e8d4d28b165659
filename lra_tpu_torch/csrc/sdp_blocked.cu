// Blocked chaining DP (SDP) for Hopper: chain_scores_blocked.
//
// Replaces lra_tpu/ops/sdp_blocked.py:chain_scores_blocked (a jitted
// lax.scan over blocks of L=64 fragments) and, inlined, the PWL gap cost
// lra_tpu/ops/gapcost.py:pwl_select_jnp.  Same recurrence, same f32
// arithmetic, same tie rules:
//   * argmax takes the first index (cross-block and in-block);
//   * lane 2 only if c2 > c1 at the argmax;
//   * an in-block candidate wins only if strictly better;
//   * a chain starts when the best candidate is <= 0;
//   * NEG = -3e38 marks "no predecessor".
// The PWL piece value s*x + b is two separately rounded f32 ops
// (__fmul_rn, __fadd_rn): nvcc would otherwise contract it into an FMA
// and the floor could see a different value.
//
// Design: one CTA (8 warps) per problem, V kept in shared memory.  For
// each block of 64 rows, every warp owns 8 rows and its lanes stride over
// the earlier fragments j < b0 (the cross-block max over V[j] + w; later
// fragments still hold NEG, so they can never win); warp 0 then resolves
// the 64-row in-block triangle in order, two columns per lane.
// Bound: operations.  The cross-block phase evaluates the PWL for both
// lanes of every (i, j < i) pair, N^2/2 pairs per problem; memory
// traffic is the [B, N] inputs and outputs only.  With one CTA per
// problem a small batch leaves most SMs idle — splitting a problem's
// rows over several CTAs per block step is the next speed step.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int L = 64;
constexpr int NPIECE = 24;
constexpr int NTHREADS = 256;
constexpr float NEG = -3.0e38f;

__constant__ int c_stops[NPIECE + 1] = {
    0, 5, 10, 20, 40, 80, 100, 200, 300, 500, 1000, 2000, 3000, 4000, 5000,
    6000, 7000, 8000, 9000, 15000, 20000, 30000, 40000, 50000, 100000};

struct Pwl {
  float slope[NPIECE];
  float inter[NPIECE];
  float c1, c2;
};

// PWL_w(x): pieces overwrite ascending (the last piece with STOPS[i] <= x
// wins; zero-slope pieces are skipped), then floor and two ceilings.
__device__ __forceinline__ float pwl(int x, const Pwl& p) {
  const float xf = __int2float_rn(x);
  float pen = 0.f;
#pragma unroll
  for (int i = 0; i < NPIECE; ++i) {
    if (p.slope[i] != 0.f && x >= c_stops[i])
      pen = __fadd_rn(__fmul_rn(p.slope[i], xf), p.inter[i]);
  }
  pen = floorf(pen);
  if (pen >= p.c1 && pen < p.c2) pen = p.c1;
  if (pen > p.c2) pen = p.c2;
  return x <= 2 ? 0.f : pen;
}

__device__ __forceinline__ float pair_cost(int di, int dj, const Pwl& p) {
  return -pwl(abs(di - dj) + 1, p);
}

// (value, index) max with the first index winning ties
__device__ __forceinline__ void better(float& v, int& a, int& f, float ov,
                                       int oa, int of) {
  if (ov > v || (ov == v && oa < a)) {
    v = ov;
    a = oa;
    f = of;
  }
}

__global__ void __launch_bounds__(NTHREADS)
sdp_blocked_kernel(const int* __restrict__ qS, const int* __restrict__ qE,
                   const int* __restrict__ tS, const int* __restrict__ tE,
                   const float* __restrict__ score,
                   const uint8_t* __restrict__ lane1,
                   const uint8_t* __restrict__ lane2,
                   const uint8_t* __restrict__ valid, float* __restrict__ Vout,
                   int* __restrict__ bpout, int* __restrict__ laneout, Pwl pw,
                   int N) {
  extern __shared__ float Vs[];  // V of this problem, rows < b0 final
  __shared__ float s_best[L];
  __shared__ int s_arg[L];
  __shared__ int s_lane[L];
  __shared__ float s_tc[L][L + 1];
  __shared__ int8_t s_tl[L][L];

  const size_t off = (size_t)blockIdx.x * N;
  qS += off; qE += off; tS += off; tE += off; score += off;
  lane1 += off; lane2 += off; valid += off;
  Vout += off; bpout += off; laneout += off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = NTHREADS / 32;

  for (int b0 = 0; b0 < N; b0 += L) {
    // ---- cross-block candidates against V of rows < b0 ----
    for (int l = warp; l < L; l += nwarps) {
      const int i = b0 + l;
      const int qSi = qS[i], tSi = tS[i], tEi = tE[i];
      const bool l1i = lane1[i], l2i = lane2[i];
      const int d1si = tSi - qSi, d2si = tEi + qSi;
      float best = NEG;
      int arg = 0, flag = 0;
      for (int j = lane; j < b0; j += 32) {
        const int qEj = qE[j];
        if (!valid[j] || qEj > qSi) continue;
        const int tSj = tS[j], tEj = tE[j];
        float c1 = NEG, c2 = NEG;
        if (l1i && lane1[j] && tEj <= tSi)
          c1 = Vs[j] + pair_cost(d1si, tEj - qEj, pw);
        if (l2i && lane2[j] && tSj >= tEi)
          c2 = Vs[j] + pair_cost(d2si, tSj + qEj, pw);
        const float c = fmaxf(c1, c2);
        if (c > best) {
          best = c;
          arg = j;
          flag = c2 > c1;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
        const int of = __shfl_xor_sync(0xffffffffu, flag, o);
        better(best, arg, flag, ov, oa, of);
      }
      if (lane == 0) {
        s_best[l] = best;
        s_arg[l] = arg;
        s_lane[l] = flag ? 2 : 1;
      }
    }
    // ---- in-block triangle weights [l][l'] (l' a predecessor of l) ----
    for (int e = tid; e < L * L; e += NTHREADS) {
      const int l = e / L, lp = e % L;
      const int i = b0 + l, jj = b0 + lp;
      const bool tvis = qE[jj] <= qS[i];
      const bool tm1 = tvis && tE[jj] <= tS[i] && lane1[jj] && lane1[i];
      const bool tm2 = tvis && tS[jj] >= tE[i] && lane2[jj] && lane2[i];
      const float tc1 =
          tm1 ? pair_cost(tS[i] - qS[i], tE[jj] - qE[jj], pw) : NEG;
      const float tc2 =
          tm2 ? pair_cost(tE[i] + qS[i], tS[jj] + qE[jj], pw) : NEG;
      s_tc[l][lp] = fmaxf(tc1, tc2);
      s_tl[l][lp] = tc2 > tc1 ? 2 : 1;
    }
    __syncthreads();
    // ---- sequential in-block resolution, warp 0, columns lane/lane+32 ----
    if (warp == 0) {
      const bool va0 = valid[b0 + lane], va1 = valid[b0 + lane + 32];
      float vl0 = NEG, vl1 = NEG;
      for (int l = 0; l < L; ++l) {
        const float x0 = va0 ? s_tc[l][lane] + vl0 : NEG;
        const float x1 = va1 ? s_tc[l][lane + 32] + vl1 : NEG;
        float bv = x0;
        int ba = lane, dummy = 0;
        if (x1 > x0) {
          bv = x1;
          ba = lane + 32;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oa = __shfl_xor_sync(0xffffffffu, ba, o);
          better(bv, ba, dummy, ov, oa, 0);
        }
        const int i = b0 + l;
        const float bprev = s_best[l];
        const bool use_in = bv > bprev;
        const float best = fmaxf(bv, bprev);
        const bool take = best > 0.f;
        float v = score[i] + (take ? best : 0.f);
        if (!valid[i]) v = NEG;
        if (l < 32) {
          if (lane == l) vl0 = v;
        } else if (lane == l - 32) {
          vl1 = v;
        }
        if (lane == 0) {
          Vs[i] = v;
          Vout[i] = v;
          bpout[i] = take ? (use_in ? b0 + ba : s_arg[l]) : -1;
          laneout[i] = take ? (use_in ? (int)s_tl[l][ba] : s_lane[l]) : 0;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// pwl_host: slope[24], inter[24], ceiling1, ceiling2 (f32, host memory)
extern "C" int lra_chain_scores_blocked(
    const void* qS, const void* qE, const void* tS, const void* tE,
    const void* score, const void* lane1, const void* lane2,
    const void* valid, void* V, void* bp, void* lane,
    const void* pwl_host, int B, int N, void* stream) {
  Pwl p;
  memcpy(&p, pwl_host, sizeof(Pwl));
  const int dyn = N * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sdp_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  sdp_blocked_kernel<<<B, NTHREADS, dyn, (cudaStream_t)stream>>>(
      (const int*)qS, (const int*)qE, (const int*)tS, (const int*)tE,
      (const float*)score, (const uint8_t*)lane1, (const uint8_t*)lane2,
      (const uint8_t*)valid, (float*)V, (int*)bp, (int*)lane, p, N);
  return (int)cudaGetLastError();
}
