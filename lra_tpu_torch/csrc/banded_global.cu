// Banded global alignment with device traceback, 2-bit packed ops:
// banded_global_traced_packed.
//
// Replaces lra_tpu/ops/affine_kernel.py:banded_global_traced_packed
// (_banded_arrows + _traceback_ops_device, two jitted lax.scans).  Same
// recurrence, masks and tie order (see banded_common.cuh), same output:
// per problem the ops walking back from (qlen, tlen), one per step,
// packed 4 to a byte (LEFT/DOWN/DIAG = 1/2/3, 0 after the end).
//
// Design: one CTA per problem.  The CTA computes the rows j = 1..tlen of
// the band in order (rows past tlen are never visited by the traceback),
// keeping two rows in shared memory and writing each row's int8 arrows
// to a global scratch plane [T+1, band]; then thread 0 walks the arrows
// from (qlen, tlen) and writes the packed ops.
// Bound: the forward pass is latency-bound on its per-row barriers (a
// band of 61..1025 cells is one to 33 warps); the traceback is a chain of
// dependent global loads, one per op.  Arrows in shared memory (they fit
// for the narrow tiers) and several problems per CTA are the next speed
// steps.

#include "banded_common.cuh"

namespace {

using namespace lra;

template <int CPT>
__global__ void __launch_bounds__(1024)
banded_global_kernel(const int8_t* __restrict__ q,
                                     const int8_t* __restrict__ t,
                                     const int* __restrict__ qlen,
                                     const int* __restrict__ tlen,
                                     const int* __restrict__ kband, int Q,
                                     int T, int K, float m, float mm,
                                     float indel, int8_t* __restrict__ arrows,
                                     uint8_t* __restrict__ out, int L) {
  extern __shared__ float rows[];  // two rows of band + 1
  __shared__ float s_warp[32];
  const int b = blockIdx.x;
  Band p;
  p.q = q + (size_t)b * Q;
  p.t = t + (size_t)b * T;
  p.Q = Q;
  p.T = T;
  p.K = K;
  p.band = 2 * K + 1;
  p.qlen = qlen[b];
  p.tlen = tlen[b];
  p.kband = kband[b];
  p.m = m;
  p.mm = mm;
  p.indel = indel;
  const int band = p.band;
  int8_t* arr = arrows + (size_t)b * (T + 1) * band;
  float* prev = rows;
  float* cur = rows + band + 1;

  banded_row0<CPT>(p, prev, arr);
  __syncthreads();
  const int jmax = min(p.tlen, T);
  for (int j = 1; j <= jmax; ++j) {
    banded_row<CPT>(p, j, prev, cur, arr + (size_t)j * band, s_warp);
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  __syncthreads();

  // traceback (lra_tpu _traceback_ops_device): one op per step
  if (threadIdx.x == 0) {
    uint8_t* o = out + (size_t)b * (L / 4);
    int i = p.qlen, j = p.tlen;
    bool active = true;
    unsigned byte = 0;
    for (int s = 0; s < L; ++s) {
      int a = -1;
      if (active) {
        const int d = i - j + K;
        const bool ok = i >= 0 && j >= 0 && d >= 0 && d < band;
        if (ok) {
          const int jc = min(j, T);
          a = arr[(size_t)jc * band + d];
          if (a == DONE) a = -1;
        }
      }
      active = a >= 0;
      if (active) {
        i -= (a == DIAG || a == LEFT);
        j -= (a == DIAG || a == DOWN);
        byte |= (unsigned)a << (2 * (s & 3));
      }
      if ((s & 3) == 3) {
        o[s >> 2] = (uint8_t)byte;
        byte = 0;
      }
    }
  }
}

template <int CPT>
int launch(const void* q, const void* t, const void* qlen, const void* tlen,
           const void* kband, int B, int Q, int T, int K, int m, int mm,
           int indel, void* arrows, void* out, cudaStream_t stream) {
  const int band = 2 * K + 1;
  const int threads = ((band + CPT - 1) / CPT + 31) / 32 * 32;
  const size_t smem = 2 * (band + 1) * sizeof(float);
  banded_global_kernel<CPT><<<B, threads, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)t, (const int*)qlen, (const int*)tlen,
      (const int*)kband, Q, T, K, (float)m, (float)mm, (float)indel,
      (int8_t*)arrows, (uint8_t*)out, Q + T);
  return (int)cudaGetLastError();
}

}  // namespace

// q, t: int8 [B, Q], [B, T]; qlen, tlen, kband: int32 [B];
// arrows: int8 scratch [B, T+1, 2K+1]; out: uint8 [B, (Q+T)/4].
extern "C" int lra_banded_global_traced_packed(
    const void* q, const void* t, const void* qlen, const void* tlen,
    const void* kband, void* arrows, void* out, int B, int Q, int T, int K,
    int m, int mm, int indel, void* stream) {
  const int band = 2 * K + 1;
  if (band <= 1024)
    return launch<1>(q, t, qlen, tlen, kband, B, Q, T, K, m, mm, indel,
                     arrows, out, (cudaStream_t)stream);
  if (band <= 2048)
    return launch<2>(q, t, qlen, tlen, kband, B, Q, T, K, m, mm, indel,
                     arrows, out, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
