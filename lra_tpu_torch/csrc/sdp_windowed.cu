// Windowed large-N chaining DP for Hopper: chain_scores_windowed (K7).
//
// Replaces lra_tpu/ops/sdp_windowed.py:chain_scores_windowed (a jitted
// lax.scan over refresh rounds of R blocks of L=64 fragments) and,
// inlined, the PWL gap cost (pwl.cuh).  Per block of 64 q-sorted rows:
//   * NEAR: the exact masked max of V[j] + w over the previous W rows
//     j in [b0-W, b0) (both lanes), first index on ties, lane 2 only if
//     c2 > c1 at the argmax; rows before 0 are the reference's invalid
//     front pad, so with no candidate the argmax is b0 - W;
//   * FAR: the stale prefix maxima P1/P2 (rebuilt at the start of every
//     round of R blocks from the V finalized so far, masked by
//     qer < ins_hi[round's first block]) gathered at rank - 1, charged
//     ceiling2; the exact near term wins ties (far_best > near_best),
//     FAR1 wins when far1 >= far2;
//   * IN-BLOCK: the max-plus closure of the [64, 64] edge matrix by
//     log2(64) = 6 squarings, C'[i][j] = max_k (C[i][k] + C[k][j]), the
//     same f32 sums as the reference's squaring tree (max is exact and
//     order-free, each sum one IEEE add), then vfin, and bp/lane recovered
//     against vfin with the sequential tie rules, as the reference.
// Arithmetic: IEEE f32 throughout (no fast-math: NEG + NEG must overflow
// to -inf and NEG + score must absorb, as in the reference), the PWL
// piece as a separately rounded multiply and add.
//
// Design: one CTA of 1024 threads per problem, blocks in sequence.  The
// near phase gives each warp two rows and strides its lanes over the
// window (the window's fragment data is read from global memory: at
// W = 16384 it does not fit in shared memory, and it stays in L1/L2);
// each lane keeps a running max with the first index, then a warp
// reduction where the smaller index wins ties.  V lives in the output
// array itself (initialised to NEG, the reference's V0), P1/P2 in a
// [2, B, N] global scratch the wrapper allocates; the refresh is a
// CTA-wide inclusive prefix-max scan over N in tiles of 1024.  The
// closure ping-pongs between two 64 x 65 f32 shared-memory matrices,
// one barrier per squaring.
// Bound: operations.  The near phase evaluates the PWL for both lanes of
// L x W pairs per block (N x W pairs per problem, less the front pad);
// the closure adds 6 x 64^3 add+max per block.  Memory traffic is the
// [B, N] inputs and outputs.  One CTA per problem leaves all but B of
// the 132 SMs idle for a single contig: splitting the window across the
// CTAs of a cluster (or split-K with a merge) is the next speed step.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "pwl.cuh"

namespace {

constexpr int L = 64;
constexpr int NT = 1024;
constexpr int NWARP = NT / 32;
constexpr int LOG2L = 6;
constexpr int FAR1 = -2;
constexpr int FAR2 = -3;
constexpr float NEG = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

struct Frag {
  const int *qS, *qE, *tS, *tE;
  const float* score;
  const uint8_t *lane1, *lane2, *valid;
};

// P[k] = max_{k' <= k} (ok[k'] && qer[k'] < hi ? V[perm[k']] : NEG),
// in tiles of NT: a warp shuffle scan, a scan over the warp totals, and
// the carry from the previous tile.  Max is exact, so this equals the
// reference's cummax bit for bit.
__device__ void refresh_scan(float* P, const int* __restrict__ perm,
                             const uint8_t* __restrict__ ok,
                             const int* __restrict__ qer, const float* V,
                             int hi, int N, float* s_warp, float* s_carry) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) *s_carry = NEG;
  __syncthreads();
  for (int t0 = 0; t0 < N; t0 += NT) {
    const int k = t0 + tid;
    float x = NEG;
    if (k < N && ok[k] && qer[k] < hi) x = V[perm[k]];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x = fmaxf(x, y);
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      float w = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w = fmaxf(w, y);
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    if (warp > 0) x = fmaxf(x, s_warp[warp - 1]);
    x = fmaxf(x, *s_carry);
    if (k < N) P[k] = x;
    __syncthreads();  // every thread has read s_warp and the carry
    if (tid == NT - 1) *s_carry = x;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
sdp_windowed_kernel(Frag f, const int* __restrict__ perm1,
                    const int* __restrict__ perm2,
                    const uint8_t* __restrict__ ok1,
                    const uint8_t* __restrict__ ok2,
                    const int* __restrict__ qer1, const int* __restrict__ qer2,
                    const int* __restrict__ rank1,
                    const int* __restrict__ rank2,
                    const int* __restrict__ ins_hi, float* V, int* bpout,
                    int* laneout, float* scratch, Pwl pw, int B, int N, int W,
                    int R) {
  extern __shared__ float s_C[];  // [2][L][L + 1] closure ping-pong
  __shared__ float s_tc[L][L + 1];
  __shared__ int8_t s_tl[L][L];
  __shared__ float s_nbest[L];
  __shared__ int s_narg[L], s_nlane[L];
  __shared__ float s_bprev[L], s_W0[L], s_vfin[L];
  __shared__ int s_aprev[L], s_lprev[L];
  __shared__ float s_warp[NWARP];
  __shared__ float s_carry;

  const int pb = blockIdx.x;
  const size_t off = (size_t)pb * N;
  const int *qS = f.qS + off, *qE = f.qE + off, *tS = f.tS + off,
            *tE = f.tE + off;
  const float* score = f.score + off;
  const uint8_t *lane1 = f.lane1 + off, *lane2 = f.lane2 + off,
                *valid = f.valid + off;
  perm1 += off; perm2 += off; ok1 += off; ok2 += off;
  qer1 += off; qer2 += off; rank1 += off; rank2 += off;
  ins_hi += (size_t)pb * (N / L);
  V += off; bpout += off; laneout += off;
  float* P1 = scratch + off;
  float* P2 = scratch + (size_t)B * N + off;
  const float c2 = pw.c2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < N; k += NT) V[k] = NEG;
  __syncthreads();

  const int nb = N / L;
  for (int b = 0; b < nb; ++b) {
    const int b0 = b * L;
    if (b % R == 0) {  // refresh the far structures for this round
      const int hi = ins_hi[b];
      refresh_scan(P1, perm1, ok1, qer1, V, hi, N, s_warp, &s_carry);
      refresh_scan(P2, perm2, ok2, qer2, V, hi, N, s_warp, &s_carry);
    }

    // ---- near window: rows warp and warp + 32, lanes stride over j ----
    {
      const int la = warp, lb = warp + 32;
      const int ia = b0 + la, ib = b0 + lb;
      const int qSa = qS[ia], tSa = tS[ia], tEa = tE[ia];
      const int qSb = qS[ib], tSb = tS[ib], tEb = tE[ib];
      const bool l1a = lane1[ia], l2a = lane2[ia];
      const bool l1b = lane1[ib], l2b = lane2[ib];
      const int d1sa = tSa - qSa, d2sa = tEa + qSa;
      const int d1sb = tSb - qSb, d2sb = tEb + qSb;
      const bool act_a = l1a || l2a, act_b = l1b || l2b;
      float besta = NEG, bestb = NEG;
      int arga = b0 - W, argb = b0 - W, fla = 0, flb = 0;
      const int jlo = max(b0 - W, 0);
      if (act_a || act_b) {
        for (int j = jlo + lane; j < b0; j += 32) {
          if (!valid[j]) continue;
          const int qEj = qE[j];
          const bool va = act_a && qEj <= qSa, vb = act_b && qEj <= qSb;
          if (!va && !vb) continue;
          const int tSj = tS[j], tEj = tE[j];
          const bool l1j = lane1[j], l2j = lane2[j];
          const float Vj = V[j];
          const int d1ej = tEj - qEj, d2ej = tSj + qEj;
          if (va) {
            const float c1 = (l1a && l1j && tEj <= tSa)
                                 ? Vj + pair_cost(d1sa, d1ej, pw) : NEG;
            const float cc2 = (l2a && l2j && tSj >= tEa)
                                  ? Vj + pair_cost(d2sa, d2ej, pw) : NEG;
            const float c = fmaxf(c1, cc2);
            if (c > besta) {
              besta = c;
              arga = j;
              fla = cc2 > c1;
            }
          }
          if (vb) {
            const float c1 = (l1b && l1j && tEj <= tSb)
                                 ? Vj + pair_cost(d1sb, d1ej, pw) : NEG;
            const float cc2 = (l2b && l2j && tSj >= tEb)
                                  ? Vj + pair_cost(d2sb, d2ej, pw) : NEG;
            const float c = fmaxf(c1, cc2);
            if (c > bestb) {
              bestb = c;
              argb = j;
              flb = cc2 > c1;
            }
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        float ov = __shfl_xor_sync(FULL, besta, o);
        int oa = __shfl_xor_sync(FULL, arga, o);
        int of = __shfl_xor_sync(FULL, fla, o);
        better(besta, arga, fla, ov, oa, of);
        ov = __shfl_xor_sync(FULL, bestb, o);
        oa = __shfl_xor_sync(FULL, argb, o);
        of = __shfl_xor_sync(FULL, flb, o);
        better(bestb, argb, flb, ov, oa, of);
      }
      if (lane == 0) {
        s_nbest[la] = besta;
        s_narg[la] = arga;
        s_nlane[la] = fla ? 2 : 1;
        s_nbest[lb] = bestb;
        s_narg[lb] = argb;
        s_nlane[lb] = flb ? 2 : 1;
      }
    }

    // ---- in-block edges [l][j] (j a predecessor of l) and C0 = I (+) M --
    float* C = s_C;
    float* Cn = s_C + L * (L + 1);
    for (int e = tid; e < L * L; e += NT) {
      const int l = e / L, j = e % L;
      const int i = b0 + l, jj = b0 + j;
      const bool tvis = qE[jj] <= qS[i];
      const bool tm1 = tvis && tE[jj] <= tS[i] && lane1[jj] && lane1[i];
      const bool tm2 = tvis && tS[jj] >= tE[i] && lane2[jj] && lane2[i];
      const float tc1 =
          tm1 ? pair_cost(tS[i] - qS[i], tE[jj] - qE[jj], pw) : NEG;
      const float tc2 =
          tm2 ? pair_cost(tE[i] + qS[i], tS[jj] + qE[jj], pw) : NEG;
      const float tc = fmaxf(tc1, tc2);
      s_tc[l][j] = tc;
      s_tl[l][j] = tc2 > tc1 ? 2 : 1;
      const bool edge_ok = j < l && valid[jj] && valid[i];
      const float m = edge_ok ? __fadd_rn(tc, score[i]) : NEG;
      C[l * (L + 1) + j] = fmaxf(m, l == j ? 0.f : NEG);
    }
    __syncthreads();

    // ---- far term and the best predecessor outside the block ----
    if (tid < L) {
      const int l = tid, i = b0 + l;
      const int r1 = rank1[i], r2 = rank2[i];
      const float g1 = P1[max(r1 - 1, 0)];
      const float g2 = P2[max(r2 - 1, 0)];
      const float far1 = (r1 > 0 && lane1[i]) ? __fsub_rn(g1, c2) : NEG;
      const float far2 = (r2 > 0 && lane2[i]) ? __fsub_rn(g2, c2) : NEG;
      const float far_best = fmaxf(far1, far2);
      const bool far_first = far1 >= far2;
      const float near_best = s_nbest[l];
      const bool use_far = far_best > near_best;
      const float bprev = fmaxf(near_best, far_best);
      s_bprev[l] = bprev;
      s_aprev[l] = use_far ? (far_first ? FAR1 : FAR2) : s_narg[l];
      s_lprev[l] = use_far ? (far_first ? 1 : 2) : s_nlane[l];
      s_W0[l] = valid[i] ? __fadd_rn(score[i], fmaxf(bprev, 0.f)) : NEG;
    }

    // ---- closure: log2(L) max-plus squarings ----
    for (int s = 0; s < LOG2L; ++s) {
      for (int e = tid; e < L * L; e += NT) {
        const int i = e / L, j = e % L;
        float m = __fadd_rn(C[i * (L + 1)], C[j]);
#pragma unroll 8
        for (int k = 1; k < L; ++k)
          m = fmaxf(m, __fadd_rn(C[i * (L + 1) + k], C[k * (L + 1) + j]));
        Cn[i * (L + 1) + j] = m;
      }
      __syncthreads();
      float* t = C;
      C = Cn;
      Cn = t;
    }

    // ---- vfin[l] = max_j (W0[j] + C[l][j]) ----
    for (int l = warp; l < L; l += NWARP) {
      float v = fmaxf(__fadd_rn(s_W0[lane], C[l * (L + 1) + lane]),
                      __fadd_rn(s_W0[lane + 32], C[l * (L + 1) + lane + 32]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
      if (lane == 0) s_vfin[l] = v;
    }
    __syncthreads();

    // ---- bp/lane recovery against vfin, the block's outputs ----
    for (int l = warp; l < L; l += NWARP) {
      const int i = b0 + l;
      const bool vi = valid[i];
      const bool e0 = lane < l && vi && valid[b0 + lane];
      const bool e1 = lane + 32 < l && vi && valid[b0 + lane + 32];
      const float x0 = e0 ? __fadd_rn(s_tc[l][lane], s_vfin[lane]) : NEG;
      const float x1 =
          e1 ? __fadd_rn(s_tc[l][lane + 32], s_vfin[lane + 32]) : NEG;
      float bv = x0;
      int ba = lane, dummy = 0;
      if (x1 > x0) {
        bv = x1;
        ba = lane + 32;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, o);
        const int oa = __shfl_xor_sync(FULL, ba, o);
        better(bv, ba, dummy, ov, oa, 0);
      }
      if (lane == 0) {
        const float bprev = s_bprev[l];
        const bool use_in = bv > bprev;
        const float best = fmaxf(bv, bprev);
        const bool take = best > 0.f;
        float v = __fadd_rn(score[i], take ? best : 0.f);
        if (!vi) v = NEG;
        V[i] = v;
        bpout[i] = take ? (use_in ? b0 + ba : s_aprev[l]) : -1;
        laneout[i] = take ? (use_in ? (int)s_tl[l][ba] : s_lprev[l]) : 0;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// pwl_host: slope[24], inter[24], ceiling1, ceiling2 (f32, host memory);
// scratch: f32 [2, B, N]; R: the refresh cadence in blocks
// (ops/sdp_windowed.py:_refresh_blocks)
extern "C" int lra_chain_scores_windowed(
    const void* qS, const void* qE, const void* tS, const void* tE,
    const void* score, const void* lane1, const void* lane2,
    const void* valid, const void* perm1, const void* perm2, const void* ok1,
    const void* ok2, const void* qer1, const void* qer2, const void* rank1,
    const void* rank2, const void* ins_hi, void* V, void* bp, void* lane,
    void* scratch, const void* pwl_host, int B, int N, int W, int R,
    void* stream) {
  Pwl p;
  memcpy(&p, pwl_host, sizeof(Pwl));
  Frag f{(const int*)qS, (const int*)qE, (const int*)tS, (const int*)tE,
         (const float*)score, (const uint8_t*)lane1, (const uint8_t*)lane2,
         (const uint8_t*)valid};
  const int dyn = 2 * L * (L + 1) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sdp_windowed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  sdp_windowed_kernel<<<B, NT, dyn, (cudaStream_t)stream>>>(
      f, (const int*)perm1, (const int*)perm2, (const uint8_t*)ok1,
      (const uint8_t*)ok2, (const int*)qer1, (const int*)qer2,
      (const int*)rank1, (const int*)rank2, (const int*)ins_hi, (float*)V,
      (int*)bp, (int*)lane, (float*)scratch, p, B, N, W, R);
  return (int)cudaGetLastError();
}
