// Unblocked chaining scan (K8): chain_scores.
//
// Replaces lra_tpu/ops/sdp.py:chain_scores (:52; a jitted lax.scan over
// the fragments in index order, vmapped over problems).  Same outputs,
// bit for bit (ops/sdp.py:chain_scores_plain is the plain twin):
//   * row i takes the best of V[j] + w over the candidates j of either
//     lane, w = -PWL(|d_i - d_j| + 1) with pwl_jnp's formula: the piece
//     is the count of the 23 inner stops <= x, slope[piece] and
//     inter[piece] come from the runtime f32[24] arrays even where the
//     slope is 0, and slope * x + inter is two separately rounded f32
//     ops (__fmul_rn / __fadd_rn, so nvcc cannot contract them into one
//     FMA), then the floor, the two ceilings and x <= 2 free;
//   * the first j of the maximum wins; at that j lane 2 wins only when
//     its candidate is strictly larger (c2 > c1);
//   * take = best > 0: V[i] = score[i] + best, else score[i] + 0,
//     bp = -1 and lane = 0; bp and lane are written for invalid rows
//     too, V is NEG there;
//   * at row i every V[j >= i] is still NEG and NEG + w rounds to NEG,
//     so only j < i can win once take holds: the scan reads j < i only.
//   * coordinates are int32 and wrap as XLA's do (d2 = tE + qS).
//
// Design: one CTA of 256 threads a problem.  slope and inter go to shared
// memory once.  While they fit (N <= 9269), V and the per-fragment
// columns a row needs as a predecessor (qE, tS, tE, d1e, d2e, and a flag
// byte of valid / lane1 / lane2) are staged in shared memory, else
// read from global memory (V then lives in the output array, which the
// kernel fills with NEG first).  Row i: each thread scans its j < i (j =
// tid, tid + 256, ...) keeping the first of its maxima, a warp shuffle and
// then warp 0 merge them by (value, then smaller j), and thread 0 writes
// the row and publishes V[i] before the next row's barrier.  Rows are
// sequential, so a problem costs N barriers and N^2 / 2 pair
// evaluations: a simple kernel, far above its operation bound at N of a
// few hundred.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int FIXED_SMEM = 2 * 24 * 4 + 2 * 32 * 8;  // = ops/sdp.py
constexpr int SMEM_MAX = 232448;

// int32 arithmetic that wraps, as XLA's does
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
// |a - b| + 1 with jnp.abs's wrap (abs(INT_MIN) == INT_MIN)
__device__ __forceinline__ int gap_x(int a, int b) {
  const unsigned d = (unsigned)a - (unsigned)b;
  const unsigned ad = (int)d < 0 ? 0u - d : d;
  return (int)(ad + 1u);
}

// pwl_jnp for one int32 x (lra_tpu/ops/gapcost.py:103)
__device__ __forceinline__ float pwl(int x, const float* sl, const float* in,
                                     float c1, float c2) {
  const int piece = (x >= 5) + (x >= 10) + (x >= 20) + (x >= 40) +
                    (x >= 80) + (x >= 100) + (x >= 200) + (x >= 300) +
                    (x >= 500) + (x >= 1000) + (x >= 2000) + (x >= 3000) +
                    (x >= 4000) + (x >= 5000) + (x >= 6000) + (x >= 7000) +
                    (x >= 8000) + (x >= 9000) + (x >= 15000) +
                    (x >= 20000) + (x >= 30000) + (x >= 40000) +
                    (x >= 50000);
  float pen = __fadd_rn(__fmul_rn(sl[piece], __int2float_rn(x)), in[piece]);
  pen = floorf(pen);
  if (pen >= c1 && pen < c2) pen = c1;
  if (pen > c2) pen = c2;
  return x <= 2 ? 0.0f : pen;
}

// (value, j) max with the smaller j winning ties; the lane-2 flag travels
// with its j
__device__ __forceinline__ void better_first(float& v, int& j, int& l2,
                                             float ov, int oj, int ol2) {
  if (ov > v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
    l2 = ol2;
  }
}

struct Args {
  const int *qS, *qE, *tS, *tE;
  const float* score;
  const uint8_t *lane1, *lane2, *valid;
  const float *slope, *inter;
  float* V;
  int *bp, *lane;
  float c1, c2;
  int N;
};

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
    chain_scores_scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_sl = (float*)smem;
  float* s_in = s_sl + 24;
  float* s_rv = s_in + 24;            // warp winners: value,
  int* s_rj = (int*)(s_rv + 32);      // j,
  int* s_rl = s_rj + 32;              // lane-2 flag
  const int N = a.N, tid = threadIdx.x, wid = tid >> 5, ln = tid & 31;
  const size_t base = (size_t)blockIdx.x * N;
  float* Vg = a.V + base;
  // staged columns (STAGED) after the fixed part
  float* sV = (float*)(smem + FIXED_SMEM);
  int* sqE = (int*)(sV + N);
  int* stS = sqE + N;
  int* stE = stS + N;
  int* sd1 = stE + N;
  int* sd2 = sd1 + N;
  uint8_t* sfl = (uint8_t*)(sd2 + N);
  if (tid < 24) {
    s_sl[tid] = a.slope[tid];
    s_in[tid] = a.inter[tid];
  }
  for (int j = tid; j < N; j += THREADS) {
    if (STAGED) {
      const int qE = a.qE[base + j], tS = a.tS[base + j],
                tE = a.tE[base + j];
      sV[j] = NEG;
      sqE[j] = qE;
      stS[j] = tS;
      stE[j] = tE;
      sd1[j] = wsub(tE, qE);
      sd2[j] = wadd(tS, qE);
      sfl[j] = (uint8_t)((a.valid[base + j] ? 1 : 0) |
                         (a.lane1[base + j] ? 2 : 0) |
                         (a.lane2[base + j] ? 4 : 0));
    } else {
      Vg[j] = NEG;
    }
  }
  __syncthreads();
  const float c1 = a.c1, c2 = a.c2;
  for (int i = 0; i < N; ++i) {
    const int qSi = a.qS[base + i], tSi = a.tS[base + i],
              tEi = a.tE[base + i];
    const int d1s = wsub(tSi, qSi), d2s = wadd(tEi, qSi);
    const bool l1i = a.lane1[base + i] != 0, l2i = a.lane2[base + i] != 0;
    float best = -INFINITY;
    int barg = INT_MAX, bl2 = 0;
    for (int j = tid; j < i; j += THREADS) {
      int qE, tS, tE, d1e, d2e;
      unsigned fl;
      float Vj;
      if (STAGED) {
        qE = sqE[j];
        tS = stS[j];
        tE = stE[j];
        d1e = sd1[j];
        d2e = sd2[j];
        fl = sfl[j];
        Vj = sV[j];
      } else {
        qE = a.qE[base + j];
        tS = a.tS[base + j];
        tE = a.tE[base + j];
        d1e = wsub(tE, qE);
        d2e = wadd(tS, qE);
        fl = (a.valid[base + j] ? 1u : 0u) | (a.lane1[base + j] ? 2u : 0u) |
             (a.lane2[base + j] ? 4u : 0u);
        Vj = Vg[j];
      }
      const bool vis = qE <= qSi && (fl & 1u);
      float cl1 = NEG, cl2 = NEG;
      if (vis && tE <= tSi && (fl & 2u) && l1i)
        cl1 = __fadd_rn(Vj, -pwl(gap_x(d1s, d1e), s_sl, s_in, c1, c2));
      if (vis && tS >= tEi && (fl & 4u) && l2i)
        cl2 = __fadd_rn(Vj, -pwl(gap_x(d2s, d2e), s_sl, s_in, c1, c2));
      const float c = fmaxf(cl1, cl2);
      if (c > best) {
        best = c;
        barg = j;
        bl2 = cl2 > cl1;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, best, o);
      const int oj = __shfl_xor_sync(FULL, barg, o);
      const int ol = __shfl_xor_sync(FULL, bl2, o);
      better_first(best, barg, bl2, ov, oj, ol);
    }
    if (ln == 0) {
      s_rv[wid] = best;
      s_rj[wid] = barg;
      s_rl[wid] = bl2;
    }
    __syncthreads();
    if (wid == 0) {
      best = ln < NWARP ? s_rv[ln] : -INFINITY;
      barg = ln < NWARP ? s_rj[ln] : INT_MAX;
      bl2 = ln < NWARP ? s_rl[ln] : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL, best, o);
        const int oj = __shfl_xor_sync(FULL, barg, o);
        const int ol = __shfl_xor_sync(FULL, bl2, o);
        better_first(best, barg, bl2, ov, oj, ol);
      }
      if (ln == 0) {
        const bool take = best > 0.0f;
        const float vi = __fadd_rn(a.score[base + i], take ? best : 0.0f);
        const float Vi = a.valid[base + i] ? vi : NEG;
        if (STAGED) sV[i] = Vi;
        Vg[i] = Vi;
        a.bp[base + i] = take ? barg : -1;
        a.lane[base + i] = take ? (bl2 ? 2 : 1) : 0;
      }
    }
    __syncthreads();
  }
}

// Raise the staged kernel's shared-memory limit once per device, to the
// largest size any N can ask for, and never lower it.
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done.load() >> dev & 1) return cudaSuccess;
  e = cudaFuncSetAttribute((const void*)chain_scores_scan_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX);
  if (e == cudaSuccess) done.fetch_or(1ull << dev);
  return e;
}

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// qS, qE, tS, tE: int32 [B, N]; score: f32 [B, N]; lane1, lane2, valid:
// bool [B, N]; slope, inter: f32 [24] on the device.  Out: V f32, bp and
// lane int32 [B, N].  smem from ops/sdp.py:scan_smem (the staged kernel
// when it exceeds the fixed part).
extern "C" int lra_chain_scores_scan(
    const void* qS, const void* qE, const void* tS, const void* tE,
    const void* score, const void* lane1, const void* lane2,
    const void* valid, const void* slope, const void* inter, void* V,
    void* bp, void* lane, float c1, float c2, int B, int N, int smem,
    void* stream) {
  if (B == 0 || N == 0) return 0;
  const bool staged = smem > FIXED_SMEM;
  if (N < 0 || smem > SMEM_MAX ||
      (staged && smem != FIXED_SMEM + 25 * N) ||
      (!staged && smem != FIXED_SMEM))
    return (int)cudaErrorInvalidValue;
  const Args a{(const int*)qS,      (const int*)qE,      (const int*)tS,
               (const int*)tE,      (const float*)score, (const uint8_t*)lane1,
               (const uint8_t*)lane2, (const uint8_t*)valid,
               (const float*)slope, (const float*)inter, (float*)V,
               (int*)bp,            (int*)lane,          c1,
               c2,                  N};
  const cudaStream_t st = (cudaStream_t)stream;
  if (staged) {
    const cudaError_t e = allow_smem();
    if (e != cudaSuccess) return (int)e;
    chain_scores_scan_kernel<true><<<B, THREADS, smem, st>>>(a);
  } else {
    chain_scores_scan_kernel<false><<<B, THREADS, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}
