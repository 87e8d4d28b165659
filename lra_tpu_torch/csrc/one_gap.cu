// One-long-gap banded DP with device traceback (K6): one_gap_traced.
//
// Replaces lra_tpu/ops/one_gap.py:one_gap_traced (_prefix_pass,
// _suffix_pass and _traceback, three jitted lax.scans).  Same recurrence,
// masks, tie orders and outputs, bit for bit:
//   * prefix arrows LEFT (incl. the i=0 rail equality) > DOWN > DIAG;
//   * suffix arrows LEFT > DOWN > DIAG > GAPLEFT > GAPDOWN; border seed
//     cells are assigned, never maxed;
//   * lowerMax[j] is a max whose LAST lane wins; upperMax[i] a windowed
//     strict-> update row by row, so the EARLIEST j wins;
//   * ops end-first, -1 padded; the walk stops at DONE or at an arrow < 0.
// NEGF = -1e9 is not absorbing in f32 (NEGF + indel*sh moves it), so the
// in-column insertion closure is the reference's log-step doubling, step
// for step: the same shifts, NEGF in the first sh lanes, f32 adds.  No
// prefix-max rewrite (banded_common.cuh's may use one only because its
// -1e30 absorbs).  All adds are of small exact integers or NEGF, with no
// product that could be contracted into an inexact FMA.
//
// Design: one CTA per problem.  The band's lanes (prefix 2K+1, suffix
// 2K+4) spread over the threads, CPT contiguous lanes each (CPT 1, 2 or
// 4; up to K = 1024 with 544 threads).  A row: the base values into
// shared memory, the doubling closure in a shared ping-pong pair (one
// barrier per step), the row, then its int8 arrows to a global plane,
// the lowerMax block reduction and the upperMax window update (global,
// in row order).  Rows past tBoundary (prefix) or tlen (suffix) hold no
// valid cell in the reference either: they are not computed, and the
// traceback reads them as -1.  Thread 0 walks the planes.
// Bound: latency.  Per row ~log2(band) + 3 barriers of a CTA of one to
// 17 warps, and a serial traceback of dependent global loads; the work
// is (rows x band) cells of a few f32 ops.  Several problems per CTA and
// the arrows in shared memory are the next speed steps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEGF = -1.0e9f;
constexpr int DONE = 0, LEFT = 1, DOWN = 2, DIAG = 3, GAPLEFT = 5,
              GAPDOWN = 6;
constexpr int PADC = 9;  // the reference's pad code outside the windows

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ceil(log2(max(2, width))): the reference's closure step count
__device__ __forceinline__ int log_steps(int width) {
  int s = 0;
  while ((1 << s) < max(2, width)) ++s;
  return s;
}

// row[e] = max(row[e], row[e - sh] + indel*sh), sh = 1, 2, 4, ... over
// `width` lanes, starting from src; returns the buffer holding the result.
template <int CPT>
__device__ __forceinline__ float* closure_left(float* src, float* dst,
                                               int width, int nsteps,
                                               float indel) {
  for (int st = 0; st < nsteps; ++st) {
    const int sh = 1 << st;
    const float add = indel * (float)sh;  // exact: small integers
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = threadIdx.x * CPT + c;
      if (e >= width) continue;
      const float sv = e >= sh ? src[e - sh] : NEGF;
      dst[e] = fmaxf(src[e], __fadd_rn(sv, add));
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// (value, lane) max with the larger lane winning ties
__device__ __forceinline__ void better_last(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi > i)) {
    v = ov;
    i = oi;
  }
}

template <int CPT>
__global__ void __launch_bounds__(1024)
one_gap_kernel(const int* __restrict__ qh, const int* __restrict__ th,
               const int* __restrict__ qt, const int* __restrict__ tt,
               const int* __restrict__ qlen_, const int* __restrict__ tlen_,
               const int* __restrict__ kband_, int K, int D, float m,
               float mm, float indel, int L, int8_t* __restrict__ parr,
               int8_t* __restrict__ sarr, float* __restrict__ lmax,
               int* __restrict__ lidx, float* __restrict__ up,
               int* __restrict__ upi, int8_t* __restrict__ ops,
               int* __restrict__ jump_out, float* __restrict__ score_out) {
  extern __shared__ float smem[];
  const int LP = 2 * K + 1, LS = 2 * K + 4;
  float* s_prev = smem;         // previous row, LS + 1 (NEGF sentinel)
  float* s_x = smem + LS + 1;   // closure ping
  float* s_y = s_x + LS;        // closure pong
  __shared__ float s_wv[32];
  __shared__ int s_wi[32];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int HP = D + K, HS = D + K + 4;
  const int TPs = D + K - 1, TSs = D + K + 2;
  const int TP1 = TPs + 1, TS1 = TSs + 1;
  const int UP = D + 3 * K + 4;
  qh += (size_t)b * HP;
  th += (size_t)b * HP;
  qt += (size_t)b * HS;
  tt += (size_t)b * HS;
  parr += (size_t)b * TP1 * LP;
  sarr += (size_t)b * TS1 * LS;
  lmax += (size_t)b * TP1;
  lidx += (size_t)b * TP1;
  up += (size_t)b * UP;
  upi += (size_t)b * UP;
  ops += (size_t)b * L;
  const int qlen = qlen_[b], tlen = tlen_[b], kband = kband_[b];
  const int diag = min(qlen, tlen);

  // ------------------------------------------------------------ prefix ---
  const int qB1 = min(diag + kband - 1, qlen);  // qBoundary - 1
  const int tB1 = min(diag + kband - 1, tlen);  // tBoundary - 1
  // rows past tB1 have no valid cell: NEGF rows, -1 arrows, no upperMax
  // update, lowerMax NEGF at the last lane (j + K)
  const int jP = max(0, min(TPs, tB1));
  for (int x = tid; x < L; x += blockDim.x) ops[x] = -1;
  for (int x = tid; x < UP; x += blockDim.x) {
    up[x] = (x == K && qlen <= tlen) ? 0.f : NEGF;
    upi[x] = 0;
  }
  for (int j = jP + 1 + tid; j <= TPs; j += blockDim.x) {
    lmax[j] = NEGF;
    lidx[j] = j + K;
  }
  if (tid == 0) {
    lmax[0] = qlen >= tlen ? 0.f : NEGF;
    lidx[0] = 0;
  }
  // row j = 0: P[i, 0] = indel * i for 0 <= i <= kband
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = tid * CPT + c;
    if (d >= LP) continue;
    const int offs = d - K;
    const bool inb = abs(offs) <= kband;
    float v = (offs >= 0 && inb) ? indel * (float)offs : NEGF;
    if (offs > qB1) v = NEGF;
    s_prev[d] = v;
    parr[d] = (inb && offs <= qB1)
                  ? (int8_t)(offs > 0 ? LEFT : (offs == 0 ? DONE : -1))
                  : (int8_t)-1;
  }
  if (tid == 0) s_prev[LP] = NEGF;
  __syncthreads();

  const int nls_p = log_steps(LP);
  for (int j = 1; j <= jP; ++j) {
    const int tj = th[min(j - 1, HP - 1)];
    float sDel[CPT], rail[CPT];
    bool valid[CPT], is_i0[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tid * CPT + c;
      sDel[c] = NEGF;
      rail[c] = NEGF;
      valid[c] = false;
      is_i0[c] = false;
      if (d >= LP) continue;
      const int offs = d - K, i = j + offs;
      const bool inb = abs(offs) <= kband;
      const int x = i - 1;  // q index of the cell
      const int qc = (x >= 0 && x < HP) ? qh[x] : PADC;
      const float sub = qc == tj ? m : mm;
      const float sMat = s_prev[d] + sub;
      sDel[c] = s_prev[d + 1] + indel;
      float base = fmaxf(sMat, sDel[c]);
      valid[c] = i >= 1 && i <= qB1 && j <= tB1 && inb;
      // i=0 rail: P[0, j] = indel*j, injected into the i=1 cell
      rail[c] = (i == 1 && j <= kband + 1 && valid[c])
                    ? indel * (float)(j + 1) : NEGF;
      base = fmaxf(base, rail[c]);
      s_x[d] = valid[c] ? base : NEGF;
      is_i0[c] = i == 0 && inb && j <= tB1;
    }
    __syncthreads();
    const float* X = closure_left<CPT>(s_x, s_y, LP, nls_p, indel);
    float row[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tid * CPT + c;
      row[c] = NEGF;
      if (d >= LP) continue;
      float r = valid[c] ? X[d] : NEGF;
      if (is_i0[c]) r = indel * (float)j;
      row[c] = r;
      s_prev[d] = r;
    }
    __syncthreads();
    float bv = -INFINITY;
    int bi = -1;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tid * CPT + c;
      if (d >= LP) continue;
      const int offs = d - K, i = j + offs;
      const float left = d > 0 ? s_prev[d - 1] : NEGF;
      const bool is_ins = row[c] == left + indel || row[c] == rail[c];
      int a = is_ins ? LEFT : (row[c] == sDel[c] ? DOWN : DIAG);
      if (is_i0[c]) a = DOWN;
      if (!(valid[c] || is_i0[c])) a = -1;
      parr[(size_t)j * LP + d] = (int8_t)a;
      // lowerMax[j]: main cells with i < qlen - kband, last lane wins
      const bool lm_ok = valid[c] && i < qlen - kband && j <= diag;
      better_last(bv, bi, lm_ok ? row[c] : NEGF, d);
      // upperMax[i], padded index i + K = j + d: strict >, earliest j
      const bool um_ok = valid[c] && i <= diag && j < tlen;
      const float cand = um_ok ? row[c] : NEGF;
      if (cand > up[j + d]) {
        up[j + d] = cand;
        upi[j + d] = j;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      better_last(bv, bi, ov, oi);
    }
    if (lane == 0) {
      s_wv[warp] = bv;
      s_wi[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nwarps; ++w) better_last(bv, bi, s_wv[w], s_wi[w]);
      lmax[j] = bv;
      lidx[j] = j + bi - K;
    }
  }
  __syncthreads();  // lmax/lidx/up/upi final and visible to the CTA

  // ------------------------------------------------------------ suffix ---
  // lanes e = i - j - (qlen - tlen) + K + 2; row s is column
  // j = tLow + 1 + s; the reference's pre-shift gathers are read in place
  const bool isA = qlen > tlen;
  const int dqt = qlen - tlen;
  const int qStart = qlen - diag, tStart = tlen - diag;
  const int tLow = max(0, tlen - diag - kband - 2);
  const int qLow = max(0, qlen - diag - kband - 1);
  const int eA_idx = qLow - 1 - dqt + K + 2;  // case A border-b lane
  const int eB_idx = K + kband + 3;           // case B border-b' lane
  const int tB_hi = min(tStart + kband + 1, tlen);
  const int UPW = UP + TSs + LS + 2;          // padded upper width
  const float upK = up[K];
  // rows with j > tlen have no valid or seed cell
  const int sRows = max(0, min(TSs, tlen - tLow));

  {  // row 0 (column tLow): border seeds
    const float lm_tlow = lmax[clampi(tLow, 0, TP1 - 1)];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = tid * CPT + c;
      if (e >= LS) continue;
      const int i0 = tLow + dqt + e - (K + 2);
      const bool bA = isA && i0 >= qLow && i0 <= qStart + kband;
      const bool bB = !isA && i0 == 0;
      s_prev[e] = bA ? lm_tlow : (bB ? upK : NEGF);
      sarr[e] = (int8_t)(bA ? GAPLEFT : (bB ? GAPDOWN : -1));
    }
    if (tid == 0) s_prev[LS] = NEGF;
  }
  __syncthreads();

  const int nls_s = log_steps(LS);
  const int tzoff = tLow - tlen + HS;
  const int qpre = HS + LS + 4;  // left pad of the reference's q plane
  const int qW = qpre + HS + TSs + LS + 4;
  const int qzoff = tLow - tlen - K - 2 + HS + qpre;
  const int uoff2 = tLow + 1 + dqt - 2;
  const int ubidx = tLow + 1 - tStart + kband + 1 + K;
  float acc = NEGF;
  for (int s = 0; s < sRows; ++s) {
    const int j = tLow + 1 + s;
    const int tx = clampi(tzoff + s, 0, HS + TSs + 1);
    const int tcode = tx < HS ? tt[tx] : PADC;
    const int lx = clampi(tLow + 1 + s, 0, TP1 + TSs + 1);
    const float lms = lx < TP1 ? lmax[lx] : NEGF;
    const int ubx = clampi(ubidx + s, 0, UPW - 1);
    const float ubs = ubx < UP ? up[ubx] : NEGF;
    const int i_b = j - tStart + kband + 1;
    float sMat[CPT], sDel[CPT], delC[CPT], bval[CPT];
    bool valid[CPT], seed[CPT], bAc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = tid * CPT + c;
      valid[c] = false;
      seed[c] = false;
      bAc[c] = false;
      sMat[c] = sDel[c] = delC[c] = bval[c] = NEGF;
      if (e >= LS) continue;
      const int eo = e - (K + 2), i = j + dqt + eo;
      const int qx = clampi(qzoff + s + e, 0, qW - 1) - qpre;
      const int qc = (qx >= 0 && qx < HS) ? qt[qx] : PADC;
      const float sub = qc == tcode ? m : mm;
      sMat[c] = s_prev[e] + sub;
      sDel[c] = s_prev[e + 1] + indel;
      valid[c] = abs(eo) <= kband && i >= qLow + 1 && i <= qlen &&
                 j <= tlen;
      delC[c] = (isA && j <= diag && valid[c]) ? lms : NEGF;
      float insC = NEGF;
      if (!isA && i <= diag && valid[c]) {
        const int ux = clampi(uoff2 + s + e, 0, UPW - 1);
        insC = ux < UP ? up[ux] : NEGF;
      }
      float base = fmaxf(fmaxf(sMat[c], sDel[c]), fmaxf(delC[c], insC));
      base = valid[c] ? base : NEGF;
      // border seeds of this column, injected before the closure
      bAc[c] = isA && e == eA_idx && j <= diag && i >= 0 && i <= qlen &&
               j <= tlen;
      const bool bBc = !isA && i == 0 && j >= tLow && j <= tB_hi;
      const bool bB2c = !isA && e == eB_idx && i_b >= 1 && i_b <= diag &&
                        i <= qlen && j <= tlen;
      bval[c] = bAc[c] ? lms : (bBc ? upK : (bB2c ? ubs : NEGF));
      seed[c] = (bAc[c] || bBc || bB2c) && !valid[c];
      s_x[e] = seed[c] ? bval[c] : base;
    }
    __syncthreads();
    const float* X = closure_left<CPT>(s_x, s_y, LS, nls_s, indel);
    float row[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = tid * CPT + c;
      row[c] = NEGF;
      if (e >= LS) continue;
      // seed cells keep the pure seed (assigned, never maxed)
      float r = (valid[c] || seed[c]) ? X[e] : NEGF;
      if (seed[c]) r = bval[c];
      row[c] = r;
      s_prev[e] = r;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = tid * CPT + c;
      if (e >= LS) continue;
      const float left = e > 0 ? s_prev[e - 1] : NEGF;
      const float r = row[c];
      int a = r == left + indel
                  ? LEFT
                  : (r == sDel[c] ? DOWN
                                  : (r == sMat[c] ? DIAG
                                                  : (r == delC[c] ? GAPLEFT
                                                                  : GAPDOWN)));
      if (seed[c]) a = bAc[c] ? GAPLEFT : GAPDOWN;
      if (!(valid[c] || seed[c])) a = -1;
      sarr[(size_t)(s + 1) * LS + e] = (int8_t)a;
      if (e == K + 2 && j == tlen) acc = r;
    }
  }
  if (tid * CPT <= K + 2 && K + 2 < tid * CPT + CPT) score_out[b] = acc;
  __syncthreads();  // planes complete and visible to thread 0

  // --------------------------------------------------------- traceback ---
  if (tid == 0) {
    int i = qlen, j = tlen, phase = 0, jump = 0;
    for (int step = 0; step < L; ++step) {
      int a;
      if (phase == 0) {
        const int srow = clampi(j - tLow, 0, TS1 - 1);
        const int slane = clampi(i - j - dqt + K + 2, 0, 2 * K + 3);
        a = srow <= sRows ? sarr[(size_t)srow * LS + slane] : -1;
      } else {
        const int prow = clampi(j, 0, TP1 - 1);
        const int plane = clampi(i - j + K, 0, 2 * K);
        a = prow <= jP ? parr[(size_t)prow * LP + plane] : -1;
      }
      if (!(i >= 0 && j >= 0 && a >= 0 && a != DONE)) break;
      ops[step] = (int8_t)a;
      if (a == GAPLEFT) {
        const int li = lidx[clampi(j, 0, TP1 - 1)];
        jump = i - li;
        i = li;
        phase = 1;
      } else if (a == GAPDOWN) {
        const int lj = upi[clampi(i + K, 0, UP - 1)];
        jump = j - lj;
        j = lj;
        phase = 1;
      } else {
        if (a == DIAG || a == LEFT) --i;
        if (a == DIAG || a == DOWN) --j;
      }
    }
    jump_out[b] = jump;
  }
}

template <int CPT>
int launch(const void* qh, const void* th, const void* qt, const void* tt,
           const void* qlen, const void* tlen, const void* kband, void* parr,
           void* sarr, void* lmax, void* lidx, void* up, void* upi, void* ops,
           void* jump, void* score, int B, int K, int D, int m, int mm,
           int indel, int L, cudaStream_t stream) {
  const int LS = 2 * K + 4;
  const int threads = ((LS + CPT - 1) / CPT + 31) / 32 * 32;
  const size_t smem = (size_t)(3 * LS + 1) * sizeof(float);
  one_gap_kernel<CPT><<<B, threads, smem, stream>>>(
      (const int*)qh, (const int*)th, (const int*)qt, (const int*)tt,
      (const int*)qlen, (const int*)tlen, (const int*)kband, K, D, (float)m,
      (float)mm, (float)indel, L, (int8_t*)parr, (int8_t*)sarr,
      (float*)lmax, (int*)lidx, (float*)up, (int*)upi, (int8_t*)ops,
      (int*)jump, (float*)score);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// qh, th: int32 [B, D+K]; qt, tt: int32 [B, D+K+4]; qlen, tlen, kband:
// int32 [B].  Scratch: parr int8 [B, D+K, 2K+1], sarr int8 [B, D+K+3,
// 2K+4], lmax f32 / lidx int32 [B, D+K], up f32 / upi int32 [B, D+3K+4].
// Out: ops int8 [B, L], jump int32 [B], score f32 [B].
extern "C" int lra_one_gap_traced(const void* qh, const void* th,
                                  const void* qt, const void* tt,
                                  const void* qlen, const void* tlen,
                                  const void* kband, void* parr, void* sarr,
                                  void* lmax, void* lidx, void* up,
                                  void* upi, void* ops, void* jump,
                                  void* score, int B, int K, int D, int m,
                                  int mm, int indel, int L, void* stream) {
  const int LS = 2 * K + 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (LS <= 1024)
    return launch<1>(qh, th, qt, tt, qlen, tlen, kband, parr, sarr, lmax,
                     lidx, up, upi, ops, jump, score, B, K, D, m, mm, indel,
                     L, s);
  if (LS <= 2048)
    return launch<2>(qh, th, qt, tt, qlen, tlen, kband, parr, sarr, lmax,
                     lidx, up, upi, ops, jump, score, B, K, D, m, mm, indel,
                     L, s);
  if (LS <= 4096)
    return launch<4>(qh, th, qt, tt, qlen, tlen, kband, parr, sarr, lmax,
                     lidx, up, upi, ops, jump, score, B, K, D, m, mm, indel,
                     L, s);
  return (int)cudaErrorInvalidValue;
}
