// Fused banded DP + row-synchronous traceback: banded_pallas_rowsync.
//
// Replaces the repository's Pallas TPU kernel,
// lra_tpu/ops/affine_pallas.py:_kernel (via banded_pallas_rowsync).  It
// computes what that kernel computes — the forward pass of
// _banded_arrows, then a traceback that visits each DP row once:
//   rl = length of the LEFT run ending at the current cell of row j,
//   a2 = the arrow just left of the run: DIAG (code 1), DOWN (2) or stop (3),
//   P[b, j] = rl << 2 | code;  i -= rl + (a2 == DIAG);  j -= 1
// — and emits the same uint8 plane P [B, SP] (SP = ceil((S+1)/128)*128,
// zero where no row was visited), decoded on the host by
// blocks_from_rowsync.  The TPU tiling (BT rows of 128 lanes, the 4 MB
// VMEM budget, the precomputed eq plane) is not carried over.
//
// Design: one CTA of 64 threads (two warps) per problem covers the band
// (2K+1 <= 63).  The forward pass is banded_row() of banded_common.cuh —
// the same function banded_global.cu runs — with int8 arrows [S+1, band]
// in a global scratch plane.  Warp 0 then walks the rows: one coalesced
// load of the row's arrows, a ballot of its LEFT cells, the run length
// from a count of leading zeros, the arrow after the run by a shuffle.
// Bound: latency — a barrier-bound row loop, then one dependent row load
// per visited row.

#include "banded_common.cuh"

namespace {

using namespace lra;

__global__ void __launch_bounds__(64)
rowsync_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
               const int* __restrict__ qlen, const int* __restrict__ tlen,
               const int* __restrict__ kband, int S, int K, float m,
               float mm, float indel, int8_t* __restrict__ arrows,
               uint8_t* __restrict__ P, int SP) {
  __shared__ float rows[2][64];
  __shared__ float s_warp[32];
  const int b = blockIdx.x;
  Band p;
  p.q = q + (size_t)b * S;
  p.t = t + (size_t)b * S;
  p.Q = S;
  p.T = S;
  p.K = K;
  p.band = 2 * K + 1;
  p.qlen = qlen[b];
  p.tlen = tlen[b];
  p.kband = kband[b];
  p.m = m;
  p.mm = mm;
  p.indel = indel;
  const int band = p.band;
  int8_t* arr = arrows + (size_t)b * (S + 1) * band;
  uint8_t* Pb = P + (size_t)b * SP;
  for (int x = threadIdx.x; x < SP; x += blockDim.x) Pb[x] = 0;

  float* prev = rows[0];
  float* cur = rows[1];
  banded_row0<1>(p, prev, arr);
  __syncthreads();
  const int jmax = min(p.tlen, S);
  for (int j = 1; j <= jmax; ++j) {
    banded_row<1>(p, j, prev, cur, arr + (size_t)j * band, s_warp);
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  __syncthreads();

  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int iv = p.qlen;
  for (int j = jmax; j >= 0; --j) {
    const int dk = iv - j + K;
    if (dk < 0 || dk >= band) break;  // off the band: the walk stops
    const int8_t* row = arr + (size_t)j * band;
    const int a_lo = lane < band ? row[lane] : -1;
    const int a_hi = lane + 32 < band ? row[lane + 32] : -1;
    const unsigned long long M =
        (unsigned long long)__ballot_sync(0xffffffffu, a_lo == LEFT) |
        ((unsigned long long)__ballot_sync(0xffffffffu, a_hi == LEFT) << 32);
    // LEFT run ending at dk: the ones of M from bit dk downward
    const unsigned long long upto =
        dk == 63 ? ~0ull : ((1ull << (dk + 1)) - 1ull);
    const unsigned long long z = ~M & upto;
    const int rl = z == 0 ? dk + 1 : dk - (63 - __clzll((long long)z));
    const int d2 = max(dk - rl, 0);
    const int a2 = __shfl_sync(0xffffffffu, d2 < 32 ? a_lo : a_hi, d2 & 31);
    const int code = a2 == DIAG ? 1 : (a2 == DOWN ? 2 : 3);
    if (lane == 0) Pb[j] = (uint8_t)((rl << 2) | code);
    if (code == 3) break;
    iv -= rl + (code == 1);
  }
}

}  // namespace

// q, t: int8 [B, S]; qlen, tlen, kband: int32 [B]; arrows: int8 scratch
// [B, S+1, 2K+1]; P: uint8 [B, SP].  Needs 2K+1 <= 63.
extern "C" int lra_banded_pallas_rowsync(const void* q, const void* t,
                                         const void* qlen, const void* tlen,
                                         const void* kband, void* arrows,
                                         void* P, int B, int S, int SP, int K,
                                         int m, int mm, int indel,
                                         void* stream) {
  if (2 * K + 1 > 63) return (int)cudaErrorInvalidValue;
  rowsync_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const int8_t*)t, (const int*)qlen, (const int*)tlen,
      (const int*)kband, S, K, (float)m, (float)mm, (float)indel,
      (int8_t*)arrows, (uint8_t*)P, SP);
  return (int)cudaGetLastError();
}
