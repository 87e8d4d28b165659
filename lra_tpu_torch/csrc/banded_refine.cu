// Indel-refine DP with lane-aware device traceback, 2-bit packed ops:
// banded_refine_traced_packed.
//
// Replaces lra_tpu/ops/affine_kernel.py:banded_refine_traced_packed
// (_refine_arrows + _traceback_refine_device).  The reference's
// IndelRefine matrix: linear single-step gaps (cost indel) plus affine
// del/ins lanes with open 2*indel+1 and extend 0.  Per row:
//   D    = max(S[j-1][d+1] + open, D[j-1][d+1])       (del lane)
//   base = max(S[j-1][d] + sub, S[j-1][d+1] + indel, D)
//   S    = max(leftclosure(base)[d], prefixmax(base)[d-1] + open)
// with the i=0 column a rail for j >= 1.  Planes carry the main arrow
// (bits 0-2, tie order match > ins > del > delClose > insClose) and the
// del-open (bit 3) / ins-open (bit 4) flags.  Output: the same packed op
// plane as banded_global_traced_packed.
//
// Design: as banded_global.cu — one CTA per problem, two rows of S and D
// in shared memory, int8 planes in a global scratch [T+1, band], both
// in-row closures from one two-array block scan, thread 0 walks back.
// Bound: latency (per-row barriers, then one dependent load per op).

#include "banded_common.cuh"

namespace {

using namespace lra;

constexpr int REF_DELC = 4, REF_INSC = 5;
constexpr int DEL_OPEN_BIT = 8, INS_OPEN_BIT = 16;

template <int CPT>
__global__ void __launch_bounds__(1024)
banded_refine_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ t,
                     const int* __restrict__ qlen,
                     const int* __restrict__ tlen,
                     const int* __restrict__ kband, int Q, int T, int K,
                     float m, float mm, float indel,
                     int8_t* __restrict__ planes, uint8_t* __restrict__ out,
                     int L) {
  extern __shared__ float rows[];  // S, D: two rows each of band + 1
  __shared__ float s_warp[64];
  const int b = blockIdx.x;
  const int band = 2 * K + 1;
  const int8_t* qb = q + (size_t)b * Q;
  const int8_t* tb = t + (size_t)b * T;
  const int ql = qlen[b], tl = tlen[b], kb = kband[b];
  const float open = 2.f * indel + 1.f;
  int8_t* pl = planes + (size_t)b * (T + 1) * band;
  float* Sp = rows;
  float* Sc = rows + (band + 1);
  float* Dp = rows + 2 * (band + 1);
  float* Dc = rows + 3 * (band + 1);

  // row 0: S[i, 0] = indel * i for 0 <= i <= min(kband, qlen); D = NEGF
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = threadIdx.x * CPT + c;
    if (d >= band) continue;
    const int offs = d - K;
    const bool ok = offs >= -kb && offs <= kb && offs <= ql;
    Sp[d] = (offs >= 0 && ok) ? indel * (float)offs : NEGF;
    Dp[d] = NEGF;
    pl[d] = ok ? (int8_t)(offs > 0 ? LEFT : (offs == 0 ? DONE : -1))
               : (int8_t)-1;
  }
  if (threadIdx.x == 0) {
    Sp[band] = Sc[band] = Dp[band] = Dc[band] = NEGF;
  }
  __syncthreads();

  const int jmax = min(tl, T);
  for (int j = 1; j <= jmax; ++j) {
    float x[2][CPT], inc[2][CPT], exc[2][CPT];
    float sMat[CPT], delLin[CPT], Dn[CPT];
    bool valid[CPT], dopen[CPT];
    const int tj = tb[j - 1];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = threadIdx.x * CPT + c;
      x[0][c] = x[1][c] = -INFINITY;
      valid[c] = false;
      dopen[c] = false;
      sMat[c] = delLin[c] = Dn[c] = NEGF;
      if (d >= band) continue;
      const int offs = d - K;
      const int i = j + offs;
      const int qi = i - 1;
      const int qc = (qi >= 0 && qi < Q) ? qb[qi] : QPAD;
      const float sub = qc == tj ? m : mm;
      const float shiftS = Sp[d + 1], shiftD = Dp[d + 1];
      Dn[c] = fmaxf(shiftS + open, shiftD);
      dopen[c] = Dn[c] == shiftS + open;
      sMat[c] = Sp[d] + sub;
      delLin[c] = shiftS + indel;
      float base = fmaxf(fmaxf(sMat[c], delLin[c]), Dn[c]);
      valid[c] = i >= 1 && i <= ql && j <= tl && offs >= -kb && offs <= kb;
      if (!valid[c]) base = NEGF;
      x[0][c] = base - indel * (float)d;  // linear closure
      x[1][c] = base;                     // plain prefix max
    }
    block_scan_max<CPT, 2>(x, inc, exc, s_warp);
    float Srow[CPT], Irow[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = threadIdx.x * CPT + c;
      const float L0 = inc[0][c] + indel * (float)d;
      const float pm_left = d > 0 ? exc[1][c] : NEGF;
      Irow[c] = pm_left + open;
      Srow[c] = valid[c] ? fmaxf(L0, Irow[c]) : NEGF;
      if (!valid[c]) Irow[c] = NEGF;
      if (d < band) {
        Sc[d] = Srow[c];
        Dc[d] = valid[c] ? Dn[c] : NEGF;
      }
    }
    __syncthreads();
    int8_t* prow = pl + (size_t)j * band;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = threadIdx.x * CPT + c;
      if (d >= band) continue;
      const float Sl = d > 0 ? Sc[d - 1] : NEGF;
      const bool iopen = Irow[c] == Sl + open;
      int a;
      if (Srow[c] == sMat[c]) a = DIAG;
      else if (Srow[c] == Sl + indel) a = LEFT;
      else if (Srow[c] == delLin[c]) a = DOWN;
      else if (Srow[c] == Dn[c]) a = REF_DELC;
      else a = REF_INSC;
      a |= (dopen[c] ? DEL_OPEN_BIT : 0) | (iopen ? INS_OPEN_BIT : 0);
      prow[d] = valid[c] ? (int8_t)a : (int8_t)-1;
    }
    float* tmp = Sp; Sp = Sc; Sc = tmp;
    tmp = Dp; Dp = Dc; Dc = tmp;
  }
  __syncthreads();

  // lane-aware traceback (lra_tpu _traceback_refine_device)
  if (threadIdx.x == 0) {
    constexpr int MAIN = 0, DEL = 1, INS = 2;
    uint8_t* o = out + (size_t)b * (L / 4);
    int i = ql, j = tl, lane = MAIN;
    bool active = true;
    unsigned byte = 0;
    for (int s = 0; s < L; ++s) {
      int a = -1;
      if (active) {
        const int d = i - j + K;
        const bool ok = i >= 0 && j >= 0 && d >= 0 && d < band;
        const int p = ok ? (int)pl[(size_t)min(j, T) * band + d] : -1;
        const int code = p & 7;
        const bool rail = p < 0 || !ok;
        const bool act_del =
            !rail && (lane == DEL || (lane == MAIN && code == REF_DELC));
        const bool act_ins =
            !rail && (lane == INS || (lane == MAIN && code == REF_INSC));
        const bool plain = lane == MAIN && !rail && code != REF_DELC &&
                           code != REF_INSC && code != DONE;
        a = act_del ? DOWN : (act_ins ? LEFT : (plain ? code : -1));
        lane = act_del ? ((p & DEL_OPEN_BIT) ? MAIN : DEL)
                       : (act_ins ? ((p & INS_OPEN_BIT) ? MAIN : INS) : MAIN);
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
           int indel, void* planes, void* out, cudaStream_t stream) {
  const int band = 2 * K + 1;
  const int threads = ((band + CPT - 1) / CPT + 31) / 32 * 32;
  const size_t smem = 4 * (band + 1) * sizeof(float);
  banded_refine_kernel<CPT><<<B, threads, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)t, (const int*)qlen, (const int*)tlen,
      (const int*)kband, Q, T, K, (float)m, (float)mm, (float)indel,
      (int8_t*)planes, (uint8_t*)out, Q + T);
  return (int)cudaGetLastError();
}

}  // namespace

// q, t: int8 [B, Q], [B, T]; qlen, tlen, kband: int32 [B];
// planes: int8 scratch [B, T+1, 2K+1]; out: uint8 [B, (Q+T)/4].
extern "C" int lra_banded_refine_traced_packed(
    const void* q, const void* t, const void* qlen, const void* tlen,
    const void* kband, void* planes, void* out, int B, int Q, int T, int K,
    int m, int mm, int indel, void* stream) {
  const int band = 2 * K + 1;
  if (band <= 1024)
    return launch<1>(q, t, qlen, tlen, kband, B, Q, T, K, m, mm, indel,
                     planes, out, (cudaStream_t)stream);
  if (band <= 2048)
    return launch<2>(q, t, qlen, tlen, kband, B, Q, T, K, m, mm, indel,
                     planes, out, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
