// Banded global DP with the full arrow plane (K9): banded_global_kernel.
//
// Replaces lra_tpu/ops/affine_kernel.py:banded_global_kernel (:142; the
// lax.scan of _banded_arrows, :34-139, its rows transposed to [B, T+1,
// band]).  Same outputs, bit for bit (ops/affine_kernel.py:
// banded_global_kernel_plain is the plain twin):
//   * arrows int8 [B, T+1, 2K+1]: arrows[b, j, d] is the op at cell
//     i = j + d - K, -1 outside the valid cells; row 0 is DONE at d = K,
//     LEFT right of it, -1 left of it and outside kband;
//   * row j: sMat = prev[d] + sub, sDel = prev[d+1] + indel, base = their
//     max (indel * j on the i = 0 column), NEGF outside the valid cells,
//     then the LEFT closure by log-doubling steps (row = max(row,
//     row[d - sh] + indel * sh)), NEGF outside the valid cells again, and
//     the arrow with the tie order LEFT > DOWN > DIAG (DOWN on i = 0);
//   * score[b] = rows[tlen, b, qlen - tlen + K] with JAX's gather: an
//     index below 0 wraps once by the axis' size, then it is clamped into
//     the axis (qlen - tlen + K = -8 at K = 4 reads d = 1; 14 reads d = 8).
// All values are small integers in f32 or NEGF = -1e30, which absorbs
// them, so every order of the same maxima gives the same bits.
//
// Design: one CTA a problem, 32 * ceil(band / 32) threads (at most
// 1024; a thread takes cells d = tid, tid + nt, ...).  The previous row,
// two closure buffers, sDel and the cells' flags live in shared memory;
// a row costs 3 + ceil(log2(band)) block barriers.  Each row's arrows go
// out as one coalesced store of band bytes.  The kernel writes the whole
// plane, so it is bound by those bytes (B * (T+1) * band) at full
// buckets; a simple kernel, not tuned.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEGF = -1.0e30f;
constexpr int DONE = 0, LEFT = 1, DOWN = 2, DIAG = 3;
constexpr int QPAD = 5;  // q code outside [0, Q): never equals a t code
constexpr int SMEM_MAX = 232448;

__host__ __device__ constexpr int smem_bytes(int band) {
  return 16 * band + ((band + 15) / 16) * 16;
}

// JAX's gather index: a negative index wraps once, then clamps
__device__ __forceinline__ int gather_index(int x, int size) {
  if (x < 0) x += size;
  return x < 0 ? 0 : (x > size - 1 ? size - 1 : x);
}

__global__ void __launch_bounds__(1024)
    banded_arrows_kernel(const int8_t* __restrict__ q,
                         const int8_t* __restrict__ t,
                         const int* __restrict__ qlen,
                         const int* __restrict__ tlen,
                         const int* __restrict__ kband, float* score,
                         int8_t* arrows, int Q, int T, int K, float m,
                         float mm, float indel, int logs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int band = 2 * K + 1, b = blockIdx.x, nt = blockDim.x;
  float* prev = (float*)smem;
  float* bufA = prev + band;
  float* bufB = bufA + band;
  float* sdel = bufB + band;
  uint8_t* flag = (uint8_t*)(sdel + band);  // 1: valid, 2: i == 0
  const int ql = qlen[b], tl = tlen[b], kb = kband[b];
  const int8_t* qb = q + (size_t)b * Q;
  const int8_t* tb = t + (size_t)b * T;
  int8_t* ab = arrows + (size_t)b * (T + 1) * band;
  const int jf = gather_index(tl, T + 1);
  const int df = gather_index(ql - tl + K, band);

  // row 0: P[i, 0] = indel * i for 0 <= i <= kband (d = i + K)
  for (int d = threadIdx.x; d < band; d += nt) {
    const int off = d - K;
    const bool inb = off >= -kb && off <= kb;
    const float v = off >= 0 && inb ? indel * (float)off : NEGF;
    prev[d] = v;
    ab[d] = (int8_t)(!inb ? -1 : off > 0 ? LEFT : off == 0 ? DONE : -1);
    if (jf == 0 && d == df) score[b] = v;
  }
  __syncthreads();
  for (int j = 1; j <= T; ++j) {
    const int tj = tb[j - 1];
    for (int d = threadIdx.x; d < band; d += nt) {
      const int i = j + d - K;
      const int qc = i - 1 >= 0 && i - 1 < Q ? qb[i - 1] : QPAD;
      const float sMat = __fadd_rn(prev[d], qc == tj ? m : mm);
      const float sDel = __fadd_rn(d + 1 < band ? prev[d + 1] : NEGF, indel);
      float base = fmaxf(sMat, sDel);
      if (i == 0) base = indel * (float)j;
      const int off = d - K;
      const bool valid = i >= 0 && i <= ql && j <= tl && off >= -kb &&
                         off <= kb;
      bufA[d] = valid ? base : NEGF;
      sdel[d] = sDel;
      flag[d] = (uint8_t)((valid ? 1 : 0) | (i == 0 ? 2 : 0));
    }
    __syncthreads();
    float* src = bufA;
    float* dst = bufB;
    for (int s = 0; s < logs; ++s) {
      const int sh = 1 << s;
      const float add = indel * (float)sh;
      for (int d = threadIdx.x; d < band; d += nt)
        dst[d] = fmaxf(src[d], __fadd_rn(d >= sh ? src[d - sh] : NEGF, add));
      __syncthreads();
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    // the masked row becomes the next row's prev
    for (int d = threadIdx.x; d < band; d += nt)
      prev[d] = flag[d] & 1 ? src[d] : NEGF;
    __syncthreads();
    int8_t* arow = ab + (size_t)j * band;
    for (int d = threadIdx.x; d < band; d += nt) {
      const float r = prev[d];
      const float left = __fadd_rn(d > 0 ? prev[d - 1] : NEGF, indel);
      int a = r == left ? LEFT : (r == sdel[d] ? DOWN : DIAG);
      if (flag[d] & 2) a = DOWN;
      arow[d] = (int8_t)(flag[d] & 1 ? a : -1);
      if (j == jf && d == df) score[b] = r;
    }
    __syncthreads();
  }
}

// Raise the kernel's shared-memory limit once per device, to the most
// any band can ask for, and never lower it.
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done.load() >> dev & 1) return cudaSuccess;
  e = cudaFuncSetAttribute((const void*)banded_arrows_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX);
  if (e == cudaSuccess) done.fetch_or(1ull << dev);
  return e;
}

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q: int8 [B, Q]; t: int8 [B, T]; qlen, tlen, kband: int32 [B].  Out:
// score f32 [B], arrows int8 [B, T+1, 2K+1].  threads: 32 * ceil(band /
// 32), at most 1024 (ops/affine_kernel.py:arrows_threads).
extern "C" int lra_banded_arrows(const void* q, const void* t,
                                 const void* qlen, const void* tlen,
                                 const void* kband, void* score, void* arrows,
                                 int B, int Q, int T, int K, int m, int mm,
                                 int indel, int threads, void* stream) {
  if (B == 0) return 0;
  const int band = 2 * K + 1;
  if (K < 0 || Q < 0 || T < 0 || threads % 32 || threads < 32 ||
      threads > 1024 || smem_bytes(band) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  int logs = 0;
  while ((1 << logs) < band) ++logs;
  const int smem = smem_bytes(band);
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem();
    if (e != cudaSuccess) return (int)e;
  }
  banded_arrows_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const int8_t*)t, (const int*)qlen, (const int*)tlen,
      (const int*)kband, (float*)score, (int8_t*)arrows, Q, T, K, (float)m,
      (float)mm, (float)indel, logs);
  return (int)cudaGetLastError();
}
