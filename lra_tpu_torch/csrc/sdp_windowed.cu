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
//     log2(64) = 6 squarings, C'[i][j] = max_k (C[i][k] + C[k][j]), then
//     vfin, and bp/lane recovered against vfin with the sequential tie
//     rules, as the reference.
// Arithmetic: IEEE f32 throughout (no fast-math: NEG + NEG must overflow
// to -inf and NEG + score must absorb, as in the reference), the PWL
// piece as a separately rounded multiply and add.
//
// Bound: operations.  The near phase evaluates the PWL for the valid
// rows of the window, L x W pairs per block; the closure adds 6 x 64^3
// add+max per block.  Memory traffic is the [B, N] inputs and outputs.
//
// Design: one thread-block cluster of C CTAs of 1024 threads per problem
// (C = ops/sdp_windowed.py:CLUSTER, 2..16), the blocks of 64 rows in
// sequence, two cluster barriers a block (cg cluster.sync:
// barrier.cluster arrive.release / wait.acquire) and two more in each
// block that starts a refresh round.
//   * NEAR, on CTAs 1..C-1.  Block k of q-ranks belongs to CTA
//     1 + k mod (C-1), which keeps it in a ring in shared memory of S =
//     ceil(W/64 / (C-1)) slots, block k in slot (k / (C-1)) mod S (two
//     blocks of one CTA inside one window differ by fewer than
//     S (C-1) >= W/64 blocks, so they never share a slot).  A slot holds
//     two compacted lists, the valid lane-1 rows and the valid lane-2
//     rows (a row with both lanes in both), each entry an int4 (qE, t
//     bound, diagonal, V bits) and its q-rank: 2,560 bytes a slot, 10
//     slots (25.6 KB) at W = 4096 and C = 8, 37 slots at W = 16384.  A
//     warp takes one (row, lane) item of the block and its lanes stride
//     over that lane's list in the CTA's slots, so a warp never pays for
//     the other lane's branch.  Each thread keeps (best, first index)
//     with the full tie rule (c > best, or c == best at a smaller
//     index), so the scan order is free; a window row with V[j] < best
//     is skipped before its PWL (w <= 0, so V[j] + w <= V[j] < best: it
//     can neither win nor tie).  A warp reduction gives the CTA's
//     partial per row and lane, which it stores into the leader's
//     shared memory (distributed shared memory).
//   * CLOSE, on the leader (rank 0), meanwhile: the block's rows staged
//     in shared memory, the far gathers, the in-block edges (j < l only:
//     nothing else is read), and the closure (below).  None of it needs
//     the near term.
//   * MERGE and FINISH, on the leader after the barrier.  Each lane's
//     partials merge with better(): larger value, then smaller index, a
//     total order, so any merge order gives the reference's first-index
//     argmax; a CTA with no window rows contributes the start
//     (NEG, b0 - W).  The lanes combine exactly: best = max(best1,
//     best2); at a tie the smaller index; lane 2 only when best2 > best1
//     or, at a tie, its index is strictly smaller: what "lane 2 iff
//     c2 > c1 at the first argmax of max(c1, c2)" gives (at one j,
//     c1 == c2 is lane 1).  Then the far term, vfin and the recovery;
//     the leader writes the block to V/bp/lane in global memory and its
//     lane lists into the owner's ring slot.
//   * REFRESH, split across the cluster: each CTA reduces its N/C slice
//     of both permutations, reads the lower ranks' totals through
//     distributed shared memory for its carry, and scans its slice.  Max
//     is exact and order-free, so P equals the reference's cummax.
// The closure computes the lower triangle only, in 2 x 2 register tiles
// listed by diagonal (s_tile), the long ones with their k range split in
// two halves.  C0 = I (+) M is NEG above the diagonal and 0 on it, and
// the chain scores below it are far below 2^103, half an ulp of NEG.  So
// a term C[i][k] + C[k][j] with k < j or k > i holds an upper-triangle
// NEG and gives NEG + x = NEG (|x| < 2^103 rounds away) or NEG + NEG =
// -inf: never above the term k = i, C[i][i] + C[i][j] = 0 + C[i][j] >=
// NEG.  Each entry may therefore take its max over any k range that
// holds [j, i] (a tile's [j0, i0 + 1]), the upper triangle stays NEG and
// the diagonal 0 (never rewritten), and vfin[l] takes j <= l only.  A
// squaring that changes no bit has reached the fixed point, and the
// rest are skipped: the next would map the same matrix to itself.  The
// sums are the reference's (each one IEEE add, max exact and
// order-free), so the result is bit-equal.
// Global data written inside the kernel (V, P1/P2) is read with __ldcg
// (L2), never through a non-coherent path.
//
// ptxas (sm_90a, nvcc 12.8): 64 registers (1024 threads), no spills,
// 46,144 bytes of static shared memory; dynamic shared memory 2,580 S +
// 32,776 bytes: 58,576 at W = 4096 and 128,236 at W = 16384 with C = 8.
// chip_smoke.py logs them with the cluster occupancy, and
// tools/k7_phases.py times the phases.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "pwl.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int L = 64;
constexpr int NT = 1024;
constexpr int NWARP = NT / 32;
constexpr int LOG2L = 6;
constexpr int NTILE = (L / 2) * (L / 2 + 1) / 2;  // 2 x 2 closure tiles
constexpr int NEDGE = L * (L - 1) / 2;            // in-block pairs j < l
constexpr int DSPLIT = 12;  // closure tiles on diagonals >= 12 split k
constexpr int NSPLIT = (L / 2 - DSPLIT) * (L / 2 - DSPLIT + 1) / 2;
constexpr int MAXC = 16;
constexpr int FAR1 = -2;
constexpr int FAR2 = -3;
constexpr float NEG = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

struct Frag {
  const int *qS, *qE, *tS, *tE;
  const float* score;
  const uint8_t *lane1, *lane2, *valid;
};

struct Sched {
  const int *perm1, *perm2;
  const uint8_t *ok1, *ok2;
  const int *qer1, *qer2, *rank1, *rank2, *ins_hi;
};

// One ring slot: the valid lane-1 rows of a block, then its lane-2 rows,
// compacted; (qE, tE, tE - qE, V) for lane 1, (qE, tS, tS + qE, V) for
// lane 2.
struct Slot {
  int4 ent[2][L];
  int j[2][L];
};

// dynamic shared memory: the ring, the closure ping-pong, the slot
// counts, the window's slots and their list offsets
struct Dyn {
  Slot* ring;    // [S]
  float* C;      // [2][L * L]
  int* cnt;      // [S][2]
  int* wslot;    // [S]
  int* pref;     // [2][S + 1]
};

__host__ __device__ inline size_t dyn_bytes(int S) {
  return (size_t)S * sizeof(Slot) + 2 * L * L * sizeof(float) +
         ((size_t)S * 2 + S + 2 * (S + 1)) * sizeof(int);
}

__device__ inline Dyn dyn_layout(char* base, int S) {
  Dyn d;
  d.ring = reinterpret_cast<Slot*>(base);
  d.C = reinterpret_cast<float*>(base + (size_t)S * sizeof(Slot));
  d.cnt = reinterpret_cast<int*>(d.C + 2 * L * L);
  d.wslot = d.cnt + 2 * S;
  d.pref = d.wslot + S;
  return d;
}

__device__ __forceinline__ float far_x(const Sched& s, int which,
                                       const float* V, int k, int hi) {
  const uint8_t* ok = which ? s.ok2 : s.ok1;
  const int* qer = which ? s.qer2 : s.qer1;
  const int* perm = which ? s.perm2 : s.perm1;
  return (ok[k] && qer[k] < hi) ? __ldcg(V + perm[k]) : NEG;
}

// max over the CTA of x (every thread passes its value); the result is
// valid in every thread after the call
__device__ float block_max(float x, float* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  __syncthreads();
  if (lane == 0) s_warp[warp] = x;
  __syncthreads();
  x = s_warp[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// P[k] = max(carry, max_{lo <= k' <= k} x(k')) for k in [lo, hi_k), in
// tiles of NT: a warp shuffle scan, a scan over the warp totals, and the
// carry from the previous tile.
__device__ void scan_slice(float* P, const Sched& s, int which,
                           const float* V, int hi, int lo, int hi_k,
                           float carry, float* s_warp, float* s_carry) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) *s_carry = carry;
  __syncthreads();
  for (int t0 = lo; t0 < hi_k; t0 += NT) {
    const int k = t0 + tid;
    float x = k < hi_k ? far_x(s, which, V, k, hi) : NEG;
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
    if (k < hi_k) P[k] = x;
    __syncthreads();  // every thread has read s_warp and the carry
    if (tid == NT - 1) *s_carry = x;
    __syncthreads();
  }
}

// Up to log2(L) max-plus squarings of C (pitch L, diagonal 0, upper
// triangle NEG), lower triangle only, ping-ponging with C + L*L; returns
// the buffer that holds the result.  Work item t < NTILE is the 2 x 2
// tile s_tile[t], which takes k over [j0, i0 + 1], a superset of each
// entry's [j, i]; the extra terms read an upper-triangle NEG (see the
// note at the top).  A tile on a diagonal >= DSPLIT (the last NSPLIT
// tiles) takes only the lower half of its k range; item NTILE + u takes
// the upper half of split tile u and leaves its four maxima in s_half
// for it (max is exact and order-free).  A squaring that changes no bit
// of C has reached the fixed point: every later one maps the same matrix
// to itself, so the rest are skipped.
__device__ const float* closure(float* C, const uint16_t* s_tile,
                                float4* s_half) {
  const int tid = threadIdx.x;
  float* Cm = C;
  float* Cn = C + L * L;
  const bool upper = tid >= NTILE;
  const int t = upper ? NTILE - NSPLIT + (tid - NTILE) : tid;
  const bool work = tid < NTILE + NSPLIT;
  const int I = work ? s_tile[t] >> 8 : 0, J = work ? s_tile[t] & 0xff : 0;
  const bool split = work && I - J >= DSPLIT;
  const int i0 = 2 * I, j0 = 2 * J, mid = j0 + 2 * ((I - J + 1) / 2);
  const int k0 = upper ? mid : j0, k1 = split && !upper ? mid : i0 + 2;
  for (int s = 0; s < LOG2L; ++s) {
    float m00 = NEG, m01 = NEG, m10 = NEG, m11 = NEG;
    if (work) {
      const float* A0 = Cm + i0 * L;
      const float* A1 = A0 + L;
#pragma unroll 2
      for (int k = k0; k < k1; k += 2) {
        const float2 a0 = *reinterpret_cast<const float2*>(A0 + k);
        const float2 a1 = *reinterpret_cast<const float2*>(A1 + k);
        const float2 b0 = *reinterpret_cast<const float2*>(Cm + k * L + j0);
        const float2 b1 =
            *reinterpret_cast<const float2*>(Cm + (k + 1) * L + j0);
        m00 = fmaxf(m00, fmaxf(__fadd_rn(a0.x, b0.x), __fadd_rn(a0.y, b1.x)));
        m01 = fmaxf(m01, fmaxf(__fadd_rn(a0.x, b0.y), __fadd_rn(a0.y, b1.y)));
        m10 = fmaxf(m10, fmaxf(__fadd_rn(a1.x, b0.x), __fadd_rn(a1.y, b1.x)));
        m11 = fmaxf(m11, fmaxf(__fadd_rn(a1.x, b0.y), __fadd_rn(a1.y, b1.y)));
      }
      if (upper) s_half[tid - NTILE] = make_float4(m00, m01, m10, m11);
    }
    __syncthreads();
    bool changed = false;
    if (work && !upper) {
      if (split) {
        const float4 h = s_half[t - (NTILE - NSPLIT)];
        m00 = fmaxf(m00, h.x);
        m01 = fmaxf(m01, h.y);
        m10 = fmaxf(m10, h.z);
        m11 = fmaxf(m11, h.w);
      }
      float* D0 = Cn + i0 * L + j0;
      const float* S0 = Cm + i0 * L + j0;
      changed = __float_as_int(m00) != __float_as_int(S0[0]) ||
                __float_as_int(m10) != __float_as_int(S0[L]) ||
                __float_as_int(m11) != __float_as_int(S0[L + 1]) ||
                (I != J && __float_as_int(m01) != __float_as_int(S0[1]));
      D0[0] = m00;
      if (I != J) D0[1] = m01;
      D0[L] = m10;
      D0[L + 1] = m11;
    }
    if (!__syncthreads_or(changed)) return Cm;
    float* tmp = Cm;
    Cm = Cn;
    Cn = tmp;
  }
  return Cm;
}

__global__ void __launch_bounds__(NT, 1)
sdp_windowed_kernel(Frag f, Sched sc, float* V, int* bpout, int* laneout,
                    float* scratch, Pwl pw, int B, int N, int W, int R,
                    int S) {
  extern __shared__ __align__(16) char s_dyn[];
  __shared__ PwlSmem s_pw;
  __shared__ float s_tc[L][L + 1];
  __shared__ int8_t s_tl[L][L];
  __shared__ uint16_t s_tile[NTILE];      // lower 2 x 2 tiles by diagonal
  __shared__ float s_pv[MAXC][2][L];      // leader: every CTA's partials
  __shared__ int s_pa[MAXC][2][L];
  __shared__ int s_rows[2][L];            // the block's rows per lane
  __shared__ int s_nrows[2], s_nws;
  __shared__ float s_far[2][L];
  __shared__ int s_qS[L], s_qE[L], s_tS[L], s_tE[L];  // leader: the block
  __shared__ float s_sc[L];
  __shared__ uint8_t s_l1[L], s_l2[L], s_va[L];
  __shared__ const float* s_clo;                    // the closure result
  __shared__ float4 s_half[NSPLIT];
  __shared__ float s_bprev[L], s_W0[L], s_vfin[L], s_vout[L];
  __shared__ int s_aprev[L], s_lprev[L];
  __shared__ float s_warp[NWARP];
  __shared__ float s_carry, s_tot[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool leader = rank == 0;
  const Dyn d = dyn_layout(s_dyn, S);
  const int NO = C - 1;  // CTAs 1..C-1 own the window blocks

  const int pb = blockIdx.x / C;
  const size_t off = (size_t)pb * N;
  const int *qS = f.qS + off, *qE = f.qE + off, *tS = f.tS + off,
            *tE = f.tE + off;
  const float* score = f.score + off;
  const uint8_t *lane1 = f.lane1 + off, *lane2 = f.lane2 + off,
                *valid = f.valid + off;
  sc.perm1 += off; sc.perm2 += off; sc.ok1 += off; sc.ok2 += off;
  sc.qer1 += off; sc.qer2 += off; sc.rank1 += off; sc.rank2 += off;
  sc.ins_hi += (size_t)pb * (N / L);
  V += off; bpout += off; laneout += off;
  float* P1 = scratch + off;
  float* P2 = scratch + (size_t)B * N + off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  pwl_load(s_pw, pw);
  for (int e = tid; e < NTILE; e += NT) {
    int dg = 0, o = 0;
    while (e >= o + (L / 2 - dg)) o += L / 2 - dg++;
    const int J = e - o;
    s_tile[e] = (uint16_t)(((J + dg) << 8) | J);
  }
  // the closure's diagonals stay 0 and its upper triangles NEG for the
  // whole run (C0 = I (+) M; squarings write the diagonal as 0 + 0)
  if (leader)
    for (int e = tid; e < L * L; e += NT)
      if (e % L >= e / L)
        d.C[e] = d.C[L * L + e] = e % L == e / L ? 0.f : NEG;
  for (int k = rank * NT + tid; k < N; k += C * NT) V[k] = NEG;
  cluster.sync();

  const int nb = N / L, nwb = W / L;
  const int chunk = (N + C - 1) / C;
  const int slo = min(N, rank * chunk), shi = min(N, slo + chunk);
  for (int b = 0; b < nb; ++b) {
    const int b0 = b * L;

    // ---- refresh the far structures for this round, split by slices --
    if (b % R == 0) {
      const int hi = sc.ins_hi[b];
      float t1 = NEG, t2 = NEG;
      for (int k = slo + tid; k < shi; k += NT) {
        t1 = fmaxf(t1, far_x(sc, 0, V, k, hi));
        t2 = fmaxf(t2, far_x(sc, 1, V, k, hi));
      }
      t1 = block_max(t1, s_warp);
      t2 = block_max(t2, s_warp);
      if (tid == 0) {
        s_tot[0] = t1;
        s_tot[1] = t2;
      }
      cluster.sync();
      float c1 = NEG, c2 = NEG;
      for (int r = 0; r < rank; ++r) {
        const float* rt = cluster.map_shared_rank(s_tot, r);
        c1 = fmaxf(c1, rt[0]);
        c2 = fmaxf(c2, rt[1]);
      }
      scan_slice(P1, sc, 0, V, hi, slo, shi, c1, s_warp, &s_carry);
      scan_slice(P2, sc, 1, V, hi, slo, shi, c2, s_warp, &s_carry);
      cluster.sync();  // P1/P2 are complete for the leader's gather
    }

    if (leader) {
      // ---- far term inputs (P is fixed for the round), in-block edges
      // and C0 = I (+) M, and the closure: none of it needs this block's
      // near term, so it runs while CTAs 1..C-1 scan the window ----
      if (tid < L) {
        const int l = tid, i = b0 + l;
        s_qS[l] = qS[i];
        s_qE[l] = qE[i];
        s_tS[l] = tS[i];
        s_tE[l] = tE[i];
        s_sc[l] = score[i];
        s_l1[l] = lane1[i];
        s_l2[l] = lane2[i];
        s_va[l] = valid[i];
        const int r1 = sc.rank1[i], r2 = sc.rank2[i];
        const float g1 = __ldcg(P1 + max(r1 - 1, 0));
        const float g2 = __ldcg(P2 + max(r2 - 1, 0));
        s_far[0][l] = (r1 > 0 && s_l1[l]) ? __fsub_rn(g1, s_pw.c2) : NEG;
        s_far[1][l] = (r2 > 0 && s_l2[l]) ? __fsub_rn(g2, s_pw.c2) : NEG;
      }
      __syncthreads();
      // only j < l is an edge and only those entries are read later
      float* Cm = d.C;
      for (int e = tid; e < NEDGE; e += NT) {
        int l = (int)((1.f + sqrtf(1.f + 8.f * e)) * 0.5f);
        while (l * (l - 1) / 2 > e) --l;
        while ((l + 1) * l / 2 <= e) ++l;
        const int j = e - l * (l - 1) / 2;
        const bool tvis = s_qE[j] <= s_qS[l];
        const bool tm1 = tvis && s_tE[j] <= s_tS[l] && s_l1[j] && s_l1[l];
        const bool tm2 = tvis && s_tS[j] >= s_tE[l] && s_l2[j] && s_l2[l];
        const float tc1 = tm1 ? pair_cost(s_tS[l] - s_qS[l],
                                          s_tE[j] - s_qE[j], s_pw)
                              : NEG;
        const float tc2 = tm2 ? pair_cost(s_tE[l] + s_qS[l],
                                          s_tS[j] + s_qE[j], s_pw)
                              : NEG;
        const float tc = fmaxf(tc1, tc2);
        s_tc[l][j] = tc;
        s_tl[l][j] = tc2 > tc1 ? 2 : 1;
        const bool edge_ok = s_va[j] && s_va[l];
        const float m = edge_ok ? __fadd_rn(tc, s_sc[l]) : NEG;
        Cm[l * L + j] = fmaxf(m, NEG);
      }
      __syncthreads();
      const float* res = closure(d.C, s_tile, s_half);
      if (tid == 0) s_clo = res;
    } else if (warp == 0) {
      int n1 = 0, n2 = 0;
      for (int h = 0; h < L; h += 32) {
        const int l = h + lane;
        const bool a1 = lane1[b0 + l], a2 = lane2[b0 + l];
        const unsigned m1 = __ballot_sync(FULL, a1);
        const unsigned m2 = __ballot_sync(FULL, a2);
        const unsigned lt = (1u << lane) - 1;
        if (a1) s_rows[0][n1 + __popc(m1 & lt)] = l;
        if (a2) s_rows[1][n2 + __popc(m2 & lt)] = l;
        n1 += __popc(m1);
        n2 += __popc(m2);
      }
      if (lane == 0) {
        s_nrows[0] = n1;
        s_nrows[1] = n2;
      }
    } else if (tid == 32) {
      // owned blocks k in [max(0, b - W/64), b), k = rank - 1 mod C - 1,
      // newest first
      const int kmin = max(0, b - nwb);
      int n = 0, p1 = 0, p2 = 0;
      if (b >= rank) {
        for (int k = b - 1 - (b - rank) % NO; k >= kmin; k -= NO) {
          const int slot = (k / NO) % S;
          d.wslot[n] = slot;
          d.pref[n] = p1;
          d.pref[S + 1 + n] = p2;
          p1 += d.cnt[2 * slot];
          p2 += d.cnt[2 * slot + 1];
          ++n;
        }
      }
      d.pref[n] = p1;
      d.pref[S + 1 + n] = p2;
      s_nws = n;
    }
    __syncthreads();

    // ---- near window: one (row, lane) item per warp, lanes over the
    // lane's list in this CTA's slots; the partials go to the leader ----
    if (!leader) {
      const int n1r = s_nrows[0], nit = n1r + s_nrows[1];
      for (int t = warp; t < nit; t += NWARP) {
        const int ln = t < n1r ? 0 : 1;
        const int l = s_rows[ln][ln ? t - n1r : t];
        const int i = b0 + l;
        const int qSi = qS[i], tSi = tS[i], tEi = tE[i];
        const int tb = ln ? tEi : tSi;
        const int di = ln ? tEi + qSi : tSi - qSi;
        const int* pref = d.pref + ln * (S + 1);
        const int total = pref[s_nws];
        float best = NEG;
        int arg = b0 - W, dummy = 0;
        int s = 0;
        for (int e = lane; e < total; e += 32) {
          while (e >= pref[s + 1]) ++s;
          const Slot& sl = d.ring[d.wslot[s]];
          const int pos = e - pref[s];
          const int4 en = sl.ent[ln][pos];
          const float Vj = __int_as_float(en.w);
          if (Vj < best) continue;  // V[j] + w <= V[j] < best
          if (en.x > qSi || (ln ? en.y < tb : en.y > tb)) continue;
          const float c = Vj + pair_cost(di, en.z, s_pw);
          const int j = sl.j[ln][pos];
          if (c > best || (c == best && j < arg)) {
            best = c;
            arg = j;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(FULL, best, o);
          const int oa = __shfl_xor_sync(FULL, arg, o);
          better(best, arg, dummy, ov, oa, 0);
        }
        if (lane == 0) {
          *cluster.map_shared_rank(&s_pv[rank][ln][l], 0) = best;
          *cluster.map_shared_rank(&s_pa[rank][ln][l], 0) = arg;
        }
      }
    }
    cluster.sync();  // every CTA's partials are written

    if (leader) {
      // ---- merge the partials, far term, best predecessor outside:
      // warp w takes rows 2w and 2w + 1, 16 lanes each: 8 for the lane-1
      // partials of ranks 1..C-1, 8 for the lane-2 ones ----
      if (warp < L / 2) {
        const int l = 2 * warp + (lane >> 4), ln = (lane >> 3) & 1;
        const bool has = ln ? s_l2[l] : s_l1[l];
        float v = NEG;
        int a = b0 - W, fl = 0;
        for (int r = (lane & 7) + 1; has && r < C; r += 8)
          better(v, a, fl, s_pv[r][ln][l], s_pa[r][ln][l], 0);
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          const float ov = __shfl_xor_sync(FULL, v, o);
          const int oa = __shfl_xor_sync(FULL, a, o);
          better(v, a, fl, ov, oa, 0);
        }
        // lane 1's best at (lane & 15) == 0, lane 2's at 8
        const float v2 = __shfl_xor_sync(FULL, v, 8);
        const int a2 = __shfl_xor_sync(FULL, a, 8);
        if ((lane & 15) == 0) {
          fl = 0;
          better(v, a, fl, v2, a2, 1);
          const float far1 = s_far[0][l], far2 = s_far[1][l];
          const float far_best = fmaxf(far1, far2);
          const bool far_first = far1 >= far2;
          const bool use_far = far_best > v;
          const float bprev = fmaxf(v, far_best);
          s_bprev[l] = bprev;
          s_aprev[l] = use_far ? (far_first ? FAR1 : FAR2) : a;
          s_lprev[l] = use_far ? (far_first ? 1 : 2) : (fl ? 2 : 1);
          s_W0[l] = s_va[l] ? __fadd_rn(s_sc[l], fmaxf(bprev, 0.f)) : NEG;
        }
      }
      __syncthreads();

      const float* Cm = s_clo;

      // ---- vfin[l] = max_{j <= l} (W0[j] + C[l][j]) ----
      for (int l = warp; l < L; l += NWARP) {
        float v = lane <= l ? __fadd_rn(s_W0[lane], Cm[l * L + lane]) : NEG;
        if (lane + 32 <= l)
          v = fmaxf(v, __fadd_rn(s_W0[lane + 32], Cm[l * L + lane + 32]));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
        if (lane == 0) s_vfin[l] = v;
      }
      __syncthreads();

      // ---- bp/lane recovery against vfin, the block's outputs ----
      for (int l = warp; l < L; l += NWARP) {
        const int i = b0 + l;
        const bool vi = s_va[l];
        const bool e0 = lane < l && vi && s_va[lane];
        const bool e1 = lane + 32 < l && vi && s_va[lane + 32];
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
          float v = __fadd_rn(s_sc[l], take ? best : 0.f);
          if (!vi) v = NEG;
          V[i] = v;
          s_vout[l] = v;
          bpout[i] = take ? (use_in ? b0 + ba : s_aprev[l]) : -1;
          laneout[i] = take ? (use_in ? (int)s_tl[l][ba] : s_lprev[l]) : 0;
        }
      }
      __syncthreads();

      // ---- the finished block into its owner's ring slot ----
      if (warp < 2) {
        const int ln = warp;
        const int slot = (b / NO) % S;
        Slot* rs = cluster.map_shared_rank(d.ring, 1 + b % NO) + slot;
        int* rcnt = cluster.map_shared_rank(d.cnt, 1 + b % NO);
        int base = 0;
        for (int h = 0; h < L; h += 32) {
          const int l = h + lane;
          const bool in = s_va[l] && (ln ? s_l2[l] : s_l1[l]);
          const unsigned m = __ballot_sync(FULL, in);
          if (in) {
            const int pos = base + __popc(m & ((1u << lane) - 1));
            const int q = s_qE[l], ts = s_tS[l], te = s_tE[l];
            rs->ent[ln][pos] = ln ? make_int4(q, ts, ts + q,
                                              __float_as_int(s_vout[l]))
                                  : make_int4(q, te, te - q,
                                              __float_as_int(s_vout[l]));
            rs->j[ln][pos] = b0 + l;
          }
          base += __popc(m);
        }
        if (lane == 0) rcnt[2 * slot + ln] = base;
      }
    }
    cluster.sync();  // the block is in V and in its owner's ring
  }
}

cudaError_t set_attributes(int C, size_t dyn) {
  cudaError_t e = cudaFuncSetAttribute(
      sdp_windowed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(sdp_windowed_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return e;
}

void make_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int B,
                 int C, size_t dyn, void* stream) {
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

int ring_slots(int W, int C) { return (W / L + C - 2) / (C - 1); }

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The cluster a launch at window W with C CTAs per problem would get:
// how many such clusters fit on the card at once
// (cudaOccupancyMaxActiveClusters) and the dynamic shared memory of a CTA.
extern "C" int lra_windowed_cluster_info(int W, int C, int* max_active,
                                         int* dyn_smem) {
  if (C < 2 || C > MAXC) return (int)cudaErrorInvalidValue;
  const size_t dyn = dyn_bytes(ring_slots(W, C));
  cudaError_t e = set_attributes(C, dyn);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  make_config(cfg, attr, 1, C, dyn, nullptr);
  *dyn_smem = (int)dyn;
  return (int)cudaOccupancyMaxActiveClusters(max_active,
                                             (void*)sdp_windowed_kernel,
                                             &cfg);
}

// pwl_host: the Pwl table (pwl.cuh); scratch: f32 [2, B, N]; R: the
// refresh cadence in blocks (ops/sdp_windowed.py:_refresh_blocks); C:
// CTAs per cluster, one cluster per problem.  A cluster that cannot be
// launched returns the launch's error.
extern "C" int lra_chain_scores_windowed(
    const void* qS, const void* qE, const void* tS, const void* tE,
    const void* score, const void* lane1, const void* lane2,
    const void* valid, const void* perm1, const void* perm2, const void* ok1,
    const void* ok2, const void* qer1, const void* qer2, const void* rank1,
    const void* rank2, const void* ins_hi, void* V, void* bp, void* lane,
    void* scratch, const void* pwl_host, int B, int N, int W, int R, int C,
    void* stream) {
  Pwl p;
  memcpy(&p, pwl_host, sizeof(Pwl));
  Frag f{(const int*)qS, (const int*)qE, (const int*)tS, (const int*)tE,
         (const float*)score, (const uint8_t*)lane1, (const uint8_t*)lane2,
         (const uint8_t*)valid};
  Sched s{(const int*)perm1, (const int*)perm2, (const uint8_t*)ok1,
          (const uint8_t*)ok2, (const int*)qer1, (const int*)qer2,
          (const int*)rank1, (const int*)rank2, (const int*)ins_hi};
  if (C < 2 || C > MAXC) return (int)cudaErrorInvalidValue;
  const int S = ring_slots(W, C);
  const size_t dyn = dyn_bytes(S);
  cudaError_t e = set_attributes(C, dyn);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  make_config(cfg, attr, B, C, dyn, stream);
  e = cudaLaunchKernelEx(&cfg, sdp_windowed_kernel, f, s, (float*)V,
                         (int*)bp, (int*)lane, (float*)scratch, p, B, N, W,
                         R, S);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
