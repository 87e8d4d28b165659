// Blocked chaining DP (SDP) for Hopper: chain_scores_blocked (K2).
//
// Replaces lra_tpu/ops/sdp_blocked.py:chain_scores_blocked (:33, a jitted
// lax.scan over blocks of L=64 q-sorted fragments) and, inlined, the PWL
// gap cost lra_tpu/ops/gapcost.py:pwl_select_jnp (pwl.cuh).  Per block
// of 64 rows, the cross-block max of V[j] + w over every earlier valid
// fragment (lane 1: forward diagonal, lane 2: back diagonal), then the
// 64 rows of the block in order against the block's own earlier rows.
// Same f32 arithmetic and tie rules as the reference:
//   * argmax takes the first index (cross-block and in-block);
//   * lane 2 only if c2 > c1 at the argmax (cross-block on V + w, in-block
//     on the weights alone, as the reference);
//   * an in-block candidate wins only if strictly better;
//   * a chain starts when the best candidate is <= 0 (take = best > 0,
//     computed whatever the row's validity: an invalid row with a lane
//     bit can get a real bp and lane);
//   * NEG = -3e38 marks "no predecessor"; IEEE f32 with no fast-math, so
//     NEG + NEG overflows to -inf and NEG + w absorbs, as in the reference;
//     the PWL piece is a separately rounded multiply and add (pwl.cuh).
//
// What it replaces on this card: the first port ran one CTA of 8 warps per
// problem with the blocks in sequence; each block re-read every earlier
// fragment from global memory for every row (six loads, three of them
// bytes, and two PWL lookups per pair, one pair in flight per lane), then
// warp 0 alone resolved the 64 rows with a 5-round shuffle argmax per row
// while 7 warps waited at the barrier.  Empty problems (the driver pads B
// to a power of two) ran every block.  On the main path's largest input
// (ONT, B=512 N=512) the serial pass was ~56 % of its time and the
// cross-block loop ~34 % (tools/kernel_compare.py --phases).
//
// Bound: operations, ~40 instructions a valid pair (chip_smoke.py's
// sdp_bound).  What holds the kernel is latency: the rows of a block are
// a chain (each row's V feeds the next rows), so a problem takes at least
// its blocks times one pass, and a bucket as long as its longest problem.
// The design keeps that chain short and moves the rest beside it.
//
// Design (ops/sdp_blocked.py:sdp_plan chooses the tier):
// - Work per problem ends at its last row with a lane bit or a valid bit
//   (n_eff).  Past it every row is invalid and laneless, and such a row's
//   answer is the constant (NEG, -1, 0): written without any pair work,
//   never a receiver, never staged.  A problem with no such row (the
//   driver's B padding) costs only that write.  An invalid row WITH a lane
//   bit is a receiver like any other (take is computed whatever valid
//   says); invalid rows are never predecessors.
// - Warp tier (N = 64: one block, no cross-block term): one problem per
//   thread block of one warp.  The warp records its block, computes its
//   triangle, then resolves it (below).
// - CTA tier (N >= 128): one problem per CTA.
// - Both grids are plain, a thread block a problem: every K2 launch on
//   chip_smoke.py's paths fits the card in one wave (B <= 512; ONT's
//   B=512 N=512 at 4 CTAs an SM), so a persistent grid's problem counter
//   would only add a memset.  A larger bucket runs in waves.
//   Set-up: warp 0 lists the problem's receiver rows per lane (rows with
//   that lane bit, in row order) and where each block starts in the
//   lists; every row's running best per lane (value, first index) starts
//   at (NEG, 0); warp 1 records block 0 and all warps compute its
//   triangle.  Then per block b, two barriers:
//     A  all threads fold block b-1 (staged) into the running bests of
//        block b's receivers;
//     B  warp 0 resolves block b and stages it, while the others fold
//        block b-1 into the receivers of every later block and record
//        block b+1 and its triangle.
//   So only the fold of one block into the next block's rows stands
//   between two passes.  Records, triangles and staged blocks are
//   double-buffered.
// - Records: a block's rows (qS, qE, tS, tE, score, lane and valid bits)
//   are read from global memory once, a step ahead, by one folding warp
//   before its fold; the triangle, the resolver and phase A read them
//   from shared memory.
// - Staging: a resolved block's valid rows go to shared memory as two
//   compacted lists in row order, lane 1 entries (qE, tE, tE - qE, V bits)
//   and lane 2 entries (qE, tS, tS + qE, V bits), with their row and the
//   running max of V up to each entry (a warp max-scan).  A fold item is
//   one receiver row and one lane; receiver lists are sorted by lane, so a
//   warp runs one lane's loop, with no global or byte load per entry.  It
//   walks the list from the last row back (a chain's V grows with its
//   rows, so the best rises early), skips the PWL of an entry with V[j] <
//   best and stops once the running max left is below best: w <= 0 and
//   rounding is monotone, so V[j] + w <= V[j] < best can neither win nor
//   tie.  Phase A gives each item up to 32 threads (every S-th entry),
//   merged by shuffles.
// - Fold order and ties: entries do not come in row order, so a
//   candidate replaces a best when larger, or equal at a smaller row (a
//   total order: any order of folds and merges gives the first index of
//   the maximum).  The two lanes combine when the row is resolved: best =
//   max(b1, b2), lane 2 iff b2 > b1 or (b2 == b1 and a2 < a1), which is
//   "lane 2 iff c2 > c1 at the first argmax of max(c1, c2)" (at one j,
//   c1 == c2 is lane 1).
// - Triangle: w(r, c) = max(tc1, tc2) for c < r, and the lane-2 flag
//   tc2 > tc1, two rows a warp step (r and 64 - r: 64 pairs, every lane
//   busy), stored column-major (column c holds rows c+1..63) with the
//   flags as one word a row.
// - In-block pass, a push, two rows a step: lane k owns rows 2k and
//   2k + 1.  Lane m settles rows 2m and 2m + 1 (row 2m + 1 takes row 2m's
//   candidate inside the lane), two shuffles broadcast both v, and every
//   lane owning a later row tries w + v, column 2m first, with a strict >
//   for the column (the first index).  The chain a step is a shuffle and
//   eight dependent adds and maxes for two rows, against a 15-shuffle
//   argmax a row before.  An invalid row pushes NEG (NEG + w <= NEG, NEG +
//   NEG = -inf), which never beats the start NEG, as the reference's
//   masked column never does.
// - PWL: pwl.cuh's bucketed stop index (one lookup for the binary
//   search's five), the tables in shared memory at file scope and the
//   ceilings in registers.
//
// ptxas (sm_90a, nvcc 12.8): the CTA tier 55 registers (launch bounds
// 1024), no spills; the warp tier 63.  chip_smoke.py logs them, and
// tools/k2_phases.py times the CTA tier's phases per problem.
// Global data written by the kernel is never read back by it (K8's
// scratch tier excepted, below).
//
// K8, chain_scores (scan_warp_kernel, scan_cta_kernel), replaces
// lra_tpu/ops/sdp.py:chain_scores (:52-97, a jitted lax.scan over the
// fragments in index order, vmapped over problems).  It is K2's
// recurrence in any fragment order (nothing above uses q order), so K8
// is this kernel's SCAN instance (ops/sdp.py:chain_scores_plain is its
// plain twin, bit for bit).  What SCAN changes, each needed for
// exactness:
// - pwl_jnp's rule: the piece is the count of the 23 inner stops <= x and
//   slope[piece], inter[piece] are taken as given, zero slopes included.
//   The set-up (scan_pwl_load) fills the table per stop index i with the
//   runtime piece min(i, 23) from the device arrays, so pwl_bucket_index
//   finds it.
// - int32 wrap as XLA's: the diagonals and |d_i - d_j| + 1 (jnp.abs of
//   INT_MIN is INT_MIN) in unsigned arithmetic.
// - The lane at the argmax on the sums: lane 2 iff V[j] + w2 > V[j] + w1,
//   which can fail past 2^24 where the two round equal although w2 > w1.
//   The cross-block bests keep each lane's sums already; at an in-block
//   winner whose lane-2 bit is set the resolver computes w1 again from the
//   two rows' records (the triangle's operands and arithmetic) and
//   compares both sums.
// - Pruning (skip V[j] < best, stop once the running max is below best)
//   holds only for w <= 0.  The set-up checks every piece's penalty at
//   both ends of its range of x >= 3 (a rounded multiply and add of a
//   fixed slope, the floor and the ceilings are monotone, so the ends
//   bound the piece) and folds every entry when one is negative.
// - Any N >= 1: the rows of the last block from N on are neither
//   receivers nor predecessors (no valid or lane bit) and are not written.
//   Past the CTA tier's shared memory (N > 9536) the running bests, the
//   receiver lists and their starts live in device scratch (tier 2,
//   scan_cta_kernel<true>); the lists hold uint16 rows, so N <= 65536.
// ops/sdp.py:scan_plan chooses the tier: one warp a problem up to N = 64,
// else the CTA tier, else tier 2.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "pwl.cuh"

namespace {

constexpr int L = 64;
constexpr int NTRI = L * (L - 1) / 2;  // in-block pairs c < r
constexpr int MAXT = 1024;
constexpr float NEG = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

struct Frag {
  const int *qS, *qE, *tS, *tE;
  const float* score;
  const uint8_t *lane1, *lane2, *valid;
  __device__ Frag at(size_t off) const {
    return {qS + off,    qE + off,    tS + off,    tE + off,
            score + off, lane1 + off, lane2 + off, valid + off};
  }
};

struct Out {
  float* V;
  int* bp;
  int* lane;
  __device__ Out at(size_t off) const {
    return {V + off, bp + off, lane + off};
  }
};

// The PWL tables of the running block, at file scope so that lookups
// address shared memory directly.
__shared__ PwlSmem s_pw;
__shared__ PwlBuckets s_pb;
__shared__ int s_prune;  // K8: every penalty >= 0, pruning holds

// Coordinate sums and differences: K8 wraps as XLA's int32 does.
template <bool SCAN>
__device__ __forceinline__ int dadd(int a, int b) {
  return SCAN ? (int)((unsigned)a + (unsigned)b) : a + b;
}
template <bool SCAN>
__device__ __forceinline__ int dsub(int a, int b) {
  return SCAN ? (int)((unsigned)a - (unsigned)b) : a - b;
}

// w(di, dj) = -PWL_w(|di - dj| + 1) (pwl.cuh: pair_cost's value, the stop
// index from the bucket table) with the ceilings in registers; built after
// the tables are loaded and a barrier.  SCAN: |di - dj| + 1 wraps (jnp.abs
// of INT_MIN is INT_MIN, a free gap).
template <bool SCAN>
struct Cost {
  float c1, c2;
  __device__ Cost() : c1(s_pw.c1), c2(s_pw.c2) {}
  __device__ __forceinline__ float operator()(int di, int dj) const {
    int x;
    if constexpr (SCAN) {
      const unsigned d = (unsigned)di - (unsigned)dj;
      x = (int)(((int)d < 0 ? 0u - d : d) + 1u);
    } else {
      x = abs(di - dj) + 1;
    }
    return -pwl_piece(x, s_pw.piece[pwl_bucket_index(x, s_pb)], c1, c2);
  }
};

// K8's arguments beside the fragments and outputs: pwl_jnp's pieces on
// the device, the ceilings (f32), N, and tier 2's scratch (scan_scratch
// bytes a problem).
struct Scan {
  const float *slope, *inter;
  float c1, c2;
  int N;
  uint8_t* scratch;
};

// K8's set-up, by warp 0 of the block (a barrier must follow): the table
// per stop index i holds pwl_jnp's piece min(i, 23) (the count of the 23
// inner stops <= x; x >= 100000 is stop index 24 and piece 23), the
// ceilings, and s_prune: each piece's penalty at both ends of its range
// of x >= 3 ([3, 4], [STOPS[k], STOPS[k+1] - 1], [50000, INT_MAX]) is >= 0.
// On a piece the penalty is a monotone function of x, so its ends bound it.
__device__ __forceinline__ void scan_pwl_load(const Scan& sc) {
  const int t = threadIdx.x;
  if (t < 32) {
    const int p = min(t, NPIECE - 1);
    const float2 pc = make_float2(sc.slope[p], sc.inter[p]);
    s_pw.stops[t] = t < NSTOP ? c_stops[t] : INT_MAX;
    s_pw.piece[t] = t < NSTOP ? pc : make_float2(0.f, 0.f);
    bool ok = true;
    if (t < NPIECE) {
      const int lo = t == 0 ? 3 : c_stops[t];
      const int hi = t == NPIECE - 1 ? INT_MAX : c_stops[t + 1] - 1;
      ok = pwl_piece(lo, pc, sc.c1, sc.c2) >= 0.f &&
           pwl_piece(hi, pc, sc.c1, sc.c2) >= 0.f;
    }
    const unsigned all = __ballot_sync(FULL, ok);
    if (t == 0) {
      s_pw.c1 = sc.c1;
      s_pw.c2 = sc.c2;
      s_prune = all == FULL;
    }
  }
}

// One block's rows and triangle: rc/rx, each row's (qS, qE, tS, tE) and
// (score bits, lane1 | lane2 << 1 | valid << 2), read from global memory
// once, off the chain; w[tri_off(c) + r - c - 1] = max(tc1, tc2) of row r
// against its predecessor column c < r; bit c of l2[r]: tc2 > tc1.
struct Tri {
  int4 rc[L];
  int2 rx[L];
  float w[NTRI];
  unsigned long long l2[L];
};

__host__ __device__ constexpr int tri_off(int c) {
  return c * (L - 1) - c * (c - 1) / 2;
}

// A resolved block's valid rows per lane, in row order: lane 1 (qE, tE,
// tE - qE, V bits), lane 2 (qE, tS, tS + qE, V bits), the row index j and
// pm, the largest V of the list up to each entry.
struct Staged {
  int4 ent[2][L];
  int j[2][L];
  float pm[2][L];
  int cnt[4];
};

__device__ __forceinline__ void write_empty(const Out& o, int i0, int i1,
                                            int step) {
  for (int i = i0; i < i1; i += step) {
    o.V[i] = NEG;
    o.bp[i] = -1;
    o.lane[i] = 0;
  }
}

// The block at b0's rows into t's record, by one warp (rows lane and
// lane + 32).  SCAN: rows from N on are recorded without valid or lane
// bits.
template <bool SCAN>
__device__ void record(const Frag& g, int b0, Tri& t, int lane, int N) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int l = lane + 32 * s, i = b0 + l;
    if (SCAN && i >= N) {
      t.rc[l] = make_int4(0, 0, 0, 0);
      t.rx[l] = make_int2(0, 0);
      continue;
    }
    t.rc[l] = make_int4(g.qS[i], g.qE[i], g.tS[i], g.tE[i]);
    t.rx[l] = make_int2(__float_as_int(g.score[i]),
                        g.lane1[i] | (g.lane2[i] << 1) | (g.valid[i] << 2));
  }
}

// The weights of t's recorded rows r < nr against their columns c < r,
// by warp w of nw.  Step k of 32 takes rows r = k + 1 and 64 - r (row 32
// alone at k = 31), r + (64 - r) = 64 columns: lane-slot e = lane + 32s
// is (row r, column e) for e < r, else (row 64 - r, column e - r), so no
// lane computes a pair outside the triangle.  Row and column data come
// from the record.  A row's lane bits are the same on every lane that
// takes it, so a lane's costs are computed in a branch uniform over the
// warp (either row has that lane) and masked per lane.
template <bool SCAN>
__device__ void triangle(Tri& t, int nr, const Cost<SCAN>& cost, int w,
                         int nw, int lane) {
  for (int k = w; k < L / 2; k += nw) {
    const int ra = k + 1, rb = L - ra;
    if (ra >= nr) break;  // rows from nr on are never read
    const bool two = ra < L / 2;  // row rb is another row
    const int4 xa = t.rc[ra], xb = t.rc[rb];
    const int fa = t.rx[ra].y, fb = two ? t.rx[rb].y : 0;
    bool act[2], isa[2];
    int col[2];
    float tc1[2] = {NEG, NEG}, tc2[2] = {NEG, NEG};
    int4 xc[2];
    int fc[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = lane + 32 * s;
      isa[s] = e < ra;
      act[s] = isa[s] || two;
      col[s] = isa[s] ? e : e - ra;
      xc[s] = t.rc[act[s] ? col[s] : 0];
      fc[s] = t.rx[act[s] ? col[s] : 0].y;
    }
    if ((fa | fb) & 1) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int4 xr = isa[s] ? xa : xb;  // (qS, qE, tS, tE)
        const int fr = isa[s] ? fa : fb;
        const float c = cost(dsub<SCAN>(xr.z, xr.x),
                             dsub<SCAN>(xc[s].w, xc[s].y));
        if (act[s] && (fr & fc[s] & 1) && xc[s].y <= xr.x && xc[s].w <= xr.z)
          tc1[s] = c;
      }
    }
    if ((fa | fb) & 2) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int4 xr = isa[s] ? xa : xb;
        const int fr = isa[s] ? fa : fb;
        const float c = cost(dadd<SCAN>(xr.w, xr.x),
                             dadd<SCAN>(xc[s].z, xc[s].y));
        if (act[s] && (fr & fc[s] & 2) && xc[s].y <= xr.x && xc[s].z >= xr.w)
          tc2[s] = c;
      }
    }
    unsigned bits[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (act[s]) {
        const int r = isa[s] ? ra : rb, c = col[s];
        t.w[tri_off(c) + r - c - 1] = fmaxf(tc1[s], tc2[s]);
      }
      bits[s] = __ballot_sync(FULL, act[s] && tc2[s] > tc1[s]);
    }
    if (lane == 0) {
      t.l2[ra] = two ? bits[0] & ((1u << ra) - 1) : bits[0];
      if (two)
        t.l2[rb] =
            (bits[0] >> ra) | ((unsigned long long)bits[1] << (32 - ra));
    }
  }
}

// The running bests per lane of rows < n, by row: value and first index.
struct Running {
  float* v[2];
  int* a[2];
};

// Fold staged block st into the running bests of receiver positions
// [a0, e0) of rcv[0] and [a1, e1) of rcv[1] (lane-1 items first), by
// threads t of T (T a multiple of 32; every thread of the group calls it).
// S threads an item, S a power of two up to 32, as many as the group
// holds; thread s of an item takes every S-th entry from the last row
// back (a chain's V grows with its rows, so the best rises early): it
// skips the PWL of an entry with V[j] < best and stops once the largest
// V left, pm, is below best (w <= 0: no such entry can win or tie).
// Entries come last row first, so a candidate replaces the best when
// larger, or equal at a smaller row: the first index.  NEAR: every
// receiver lies in the block recorded in near (at b0).  SCAN: the skip
// and the stop only where the set-up found every penalty >= 0.
template <bool NEAR, bool SCAN>
__device__ void fold(const Frag& g, const Staged& st, const Tri& near,
                     int b0, const uint16_t* const* rcv, int a0, int e0,
                     int a1, int e1, const Running& rb,
                     const Cost<SCAN>& cost, int t, int T) {
  const int n0 = e0 - a0, n = n0 + e1 - a1;
  if (n <= 0) return;
  const bool prune = !SCAN || s_prune;
  int S = 1;
  while (S < 32 && 2 * S * n <= T) S <<= 1;
  const int G = T / S, sub = t & (S - 1), slot = t / S;
  for (int base = 0; base < n; base += G) {
    const int k = base + slot;
    const bool act = k < n;
    const int lk = k < n0 ? 0 : 1;
    int row = 0, arg = 0;
    float best = NEG;
    if (act) {
      row = lk ? rcv[1][a1 + k - n0] : rcv[0][a0 + k];
      best = rb.v[lk][row];
      arg = rb.a[lk][row];
      int qS, tS, tE;
      if (NEAR) {
        const int4 x = near.rc[row - b0];
        qS = x.x;
        tS = x.z;
        tE = x.w;
      } else {
        qS = g.qS[row];
        tS = g.tS[row];
        tE = g.tE[row];
      }
      const int tb = lk ? tE : tS;
      const int d = lk ? dadd<SCAN>(tE, qS) : dsub<SCAN>(tS, qS);
      const int4* ent = st.ent[lk];
      const float* pm = st.pm[lk];
      for (int e = st.cnt[lk] - 1 - sub; e >= 0; e -= S) {
        if (prune && pm[e] < best) break;
        const int4 x = ent[e];
        const float vj = __int_as_float(x.w);
        const bool tok = lk ? x.y >= tb : x.y <= tb;
        if ((!prune || vj >= best) && x.x <= qS && tok) {
          const float c = vj + cost(d, x.z);
          if (c >= best) {
            const int j = st.j[lk][e];
            if (c > best || j < arg) {
              best = c;
              arg = j;
            }
          }
        }
      }
    }
    for (int o = 1; o < S; o <<= 1) {
      const float ov = __shfl_xor_sync(FULL, best, o);
      const int oa = __shfl_xor_sync(FULL, arg, o);
      if (ov > best || (ov == best && oa < arg)) {
        best = ov;
        arg = oa;
      }
    }
    if (act && sub == 0) {
      rb.v[lk][row] = best;
      rb.a[lk][row] = arg;
    }
  }
}

// Resolve the block at b0 by one warp, lane k owning rows b0 + 2k and
// b0 + 2k + 1: the rows from t's record, the cross-block bests from rb
// (none when null), the in-block pass over t's weights, the outputs to o,
// and the block's valid rows staged into st (when not null).
// Rows from nr on are past the problem's last valid or lane bit: (NEG, -1,
// 0), no pass.  SCAN: rows from nw on (past N) are not written, and an
// in-block winner's lane comes from the two sums at its column.
template <bool SCAN>
__device__ void resolve(const Out& o, int b0, int nr, int nw, const Tri& t,
                        const Running* rb, Staged* st, int lane) {
  // per row: score (NEG when invalid), cross-block best, first index and
  // lane, in-block best and first column
  float sc[2], bv[2], inb[2];
  int ba[2], bl[2], ina[2], fl[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int l = 2 * lane + s;
    const int2 x = t.rx[l];
    fl[s] = x.y;
    sc[s] = x.y & 4 ? __int_as_float(x.x) : NEG;
    inb[s] = NEG;
    ina[s] = 0;
    bv[s] = NEG;
    ba[s] = 0;
    bl[s] = 1;
    if (rb) {
      const int i = b0 + l;
      const float b1 = rb->v[0][i], b2 = rb->v[1][i];
      const int a1 = rb->a[0][i], a2 = rb->a[1][i];
      const bool two = b2 > b1 || (b2 == b1 && a2 < a1);
      bv[s] = two ? b2 : b1;
      ba[s] = two ? a2 : a1;
      bl[s] = two ? 2 : 1;
    }
  }
  // The pass, two rows a step: lane m settles rows 2m and 2m + 1 (its
  // in-block bests are final: pushes reach later rows only; row 2m + 1
  // takes row 2m's candidate in the lane, no shuffle), two shuffles
  // broadcast both v, and every later row tries w + v, column 2m first.
  // v = sc + max(best, 0) as max(inb, max(bv, 0)); a running value is a
  // max (only the sign of a zero could differ from a strict replace, and
  // no output sees it: zeros compare equal, and take needs best > 0), its
  // column a strict >.  An invalid row's v is NEG + best = NEG (|best| is
  // far below half an ulp of NEG), whose pushes never beat the start NEG.
  // Rows from nr on run on in steps of 16: their values are never read.
  const float bz0 = fmaxf(bv[0], 0.f), bz1 = fmaxf(bv[1], 0.f);
  const float wself = t.w[tri_off(2 * lane)];  // w(2k + 1, 2k)
#pragma unroll
  for (int m = 0; m < L / 2; ++m) {
    const int l = 2 * m;
    if ((m & 7) == 0 && l >= nr) break;
    const float va = sc[0] + fmaxf(inb[0], bz0);
    const float cb = wself + va;
    const float ib = fmaxf(inb[1], cb);
    const float vb = sc[1] + fmaxf(ib, bz1);
    if (lane == m) {
      if (cb > inb[1]) ina[1] = l;
      inb[1] = ib;
    }
    // this step's weights of the lane's rows, NEG where the row is not
    // after the column
    float w[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = 2 * lane + s - (l + c) - 1;
        w[s][c] = t.w[tri_off(l + c) + max(k, 0)];
        if (k < 0) w[s][c] = NEG;
      }
    const float x0 = __shfl_sync(FULL, va, m);
    const float x1 = __shfl_sync(FULL, vb, m);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float c0 = w[s][0] + x0;
      if (c0 > inb[s]) ina[s] = l;
      inb[s] = fmaxf(inb[s], c0);
      const float c1 = w[s][1] + x1;
      if (c1 > inb[s]) ina[s] = l + 1;
      inb[s] = fmaxf(inb[s], c1);
    }
  }
  // outputs from each row's final state
  float v[2];
  if constexpr (SCAN) {
    bool use_in[2], take[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int l = 2 * lane + s;
      use_in[s] = inb[s] > bv[s];
      const float best = fmaxf(inb[s], bv[s]);
      take[s] = best > 0.f && l < nr;
      v[s] = fl[s] & 4 ? sc[s] + (take[s] ? best : 0.f) : NEG;
    }
    const Cost<SCAN> cost;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int l = 2 * lane + s, i = b0 + l, c = ina[s];
      // the winning column's V (row c: lane c / 2, its row c % 2)
      const float x0 = __shfl_sync(FULL, v[0], c >> 1);
      const float x1 = __shfl_sync(FULL, v[1], c >> 1);
      const float vc = c & 1 ? x1 : x0;
      // its weights: w = max(w1, w2) from the triangle and w1 as the
      // triangle computed it, from the two rows' records
      const int4 xr = t.rc[l], xc = t.rc[c];
      const float w1 =
          (t.rx[l].y & t.rx[c].y & 1) && xc.y <= xr.x && xc.w <= xr.z
              ? cost(dsub<SCAN>(xr.z, xr.x), dsub<SCAN>(xc.w, xc.y))
              : NEG;
      const float w = t.w[tri_off(c) + max(l - c - 1, 0)];
      const bool two = (t.l2[l] >> c & 1) && vc + w > vc + w1;
      if (l < nw) {
        o.V[i] = v[s];
        o.bp[i] = take[s] ? (use_in[s] ? b0 + c : ba[s]) : -1;
        o.lane[i] = take[s] ? (use_in[s] ? (two ? 2 : 1) : bl[s]) : 0;
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int l = 2 * lane + s, i = b0 + l;
      const bool use_in = inb[s] > bv[s];
      const float best = fmaxf(inb[s], bv[s]);
      const bool take = best > 0.f && l < nr;
      v[s] = fl[s] & 4 ? sc[s] + (take ? best : 0.f) : NEG;
      const int il = t.l2[l] >> ina[s] & 1 ? 2 : 1;
      o.V[i] = v[s];
      o.bp[i] = take ? (use_in ? b0 + ina[s] : ba[s]) : -1;
      o.lane[i] = take ? (use_in ? il : bl[s]) : 0;
    }
  }
  if (!st) return;
  // stage the valid rows of each lane in row order (row 2k + s: lane k,
  // then s), with the running max of V over each list (a max-scan over
  // the lanes)
  const unsigned lt = (1u << lane) - 1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool h0 = (fl[0] & 4) && (fl[0] >> k & 1);
    const bool h1 = (fl[1] & 4) && (fl[1] >> k & 1);
    const float m0 = h0 ? v[0] : -INFINITY;
    float m = fmaxf(m0, h1 ? v[1] : -INFINITY);
#pragma unroll
    for (int o2 = 1; o2 < 32; o2 <<= 1) {
      const float y = __shfl_up_sync(FULL, m, o2);
      if (lane >= o2) m = fmaxf(m, y);
    }
    float before = __shfl_up_sync(FULL, m, 1);  // lanes < k
    if (lane == 0) before = -INFINITY;
    const unsigned b0s = __ballot_sync(FULL, h0);
    const unsigned b1s = __ballot_sync(FULL, h1);
    const int pos = __popc(b0s & lt) + __popc(b1s & lt);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!(s ? h1 : h0)) continue;
      const int l = 2 * lane + s, at = pos + (s ? h0 : 0);
      const int4 x = t.rc[l];  // (qS, qE, tS, tE)
      const int vb = __float_as_int(v[s]);
      st->ent[k][at] = k ? make_int4(x.y, x.z, dadd<SCAN>(x.z, x.y), vb)
                         : make_int4(x.y, x.w, dsub<SCAN>(x.w, x.y), vb);
      st->j[k][at] = b0 + l;
      st->pm[k][at] = s ? m : fmaxf(before, m0);
    }
    if (lane == 0) st->cnt[k] = __popc(b0s) + __popc(b1s);
  }
}

// Warp tier (N = L; K8: N <= L): one problem per block of one warp, its
// Tri in dynamic shared memory; the PWL tables loaded and a barrier
// passed.
template <bool SCAN>
__device__ __forceinline__ void warp_body(const Frag& f, const Out& o,
                                          int N) {
  extern __shared__ int4 dyn[];
  const Cost<SCAN> cost;
  const int lane = threadIdx.x;
  Tri& t = *reinterpret_cast<Tri*>(dyn);
  const size_t off = (size_t)blockIdx.x * N;
  const Frag g = f.at(off);
  const Out q = o.at(off);
  // n_eff: past the last row with a valid or lane bit, the answer is the
  // constant (NEG, -1, 0)
  const unsigned a0 = __ballot_sync(
      FULL, SCAN && lane >= N ? 0
                              : g.valid[lane] | g.lane1[lane] | g.lane2[lane]);
  const unsigned a1 = __ballot_sync(
      FULL, SCAN && lane + 32 >= N ? 0
                                   : g.valid[lane + 32] | g.lane1[lane + 32] |
                                         g.lane2[lane + 32]);
  const int nr = a1 ? 64 - __clz(a1) : 32 - __clz(a0);
  if (nr == 0) {
    write_empty(q, lane, N, 32);
    return;
  }
  record<SCAN>(g, 0, t, lane, N);
  __syncwarp();
  triangle<SCAN>(t, nr, cost, 0, 1, lane);
  __syncwarp();
  resolve<SCAN>(q, 0, nr, N, t, nullptr, nullptr, lane);
}

__global__ void __launch_bounds__(32)
sdp_blocked_warp_kernel(Frag f, Out o, Pwl ph) {
  pwl_load(s_pw, ph);
  pwl_buckets_load(s_pb, threadIdx.x, blockDim.x);
  __syncthreads();
  warp_body<false>(f, o, L);
}

__global__ void __launch_bounds__(32) scan_warp_kernel(Frag f, Out o,
                                                       Scan sc) {
  scan_pwl_load(sc);
  pwl_buckets_load(s_pb, threadIdx.x, blockDim.x);
  __syncthreads();
  warp_body<true>(f, o, sc.N);
}

// The CTA tier's running bests (value and index per lane and row), the
// receiver lists (uint16 per lane and row), their block starts [2][Np/L +
// 1] and the rows' lane bits, for Np rows (Np: N in whole blocks).
__host__ __device__ inline size_t lists_bytes(int Np) {
  return (size_t)Np * 21 + (size_t)(Np / L + 1) * 8;
}

// K8's tier 2: a problem's lists in device scratch, 16-byte aligned
__host__ __device__ inline size_t scan_scratch(int Np) {
  return (lists_bytes(Np) + 15) / 16 * 16;
}

// CTA tier (N >= 2L; K8: N > L): one problem per block.  Dynamic shared
// memory: Tri[2], Staged[2] and the lists (cta_smem; K8's tier 2,
// SCRATCH: the lists in device scratch).
template <bool SCAN, bool SCRATCH>
__device__ __forceinline__ void cta_body(const Frag& f, const Out& o,
                                         const Pwl& ph, const Scan& scan,
                                         int N) {
  extern __shared__ int4 dyn[];
  __shared__ int s_last;
  const int Np = SCAN ? (N + L - 1) / L * L : N;
  Tri* tri = reinterpret_cast<Tri*>(dyn);
  Staged* st = reinterpret_cast<Staged*>(tri + 2);
  float* rbv = SCRATCH ? reinterpret_cast<float*>(
                             scan.scratch + blockIdx.x * scan_scratch(Np))
                       : reinterpret_cast<float*>(st + 2);
  int* rba = reinterpret_cast<int*>(rbv + 2 * Np);
  uint16_t* rc = reinterpret_cast<uint16_t*>(rba + 2 * Np);
  int* rstart = reinterpret_cast<int*>(rc + 2 * Np);
  uint8_t* fl = reinterpret_cast<uint8_t*>(rstart + 2 * (Np / L + 1));
  const Running rb = {{rbv, rbv + Np}, {rba, rba + Np}};
  const uint16_t* const rcv[2] = {rc, rc + Np};
  const int NB1 = Np / L + 1;
  const int tid = threadIdx.x, NT = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5;
  if constexpr (SCAN)
    scan_pwl_load(scan);
  else
    pwl_load(s_pw, ph);
  pwl_buckets_load(s_pb, tid, NT);
  if (tid == 0) s_last = -1;
  __syncthreads();
  const size_t off = (size_t)blockIdx.x * N;
  const Frag g = f.at(off);
  const Out q = o.at(off);
  const Cost<SCAN> cost;
  // n_eff: past the last row with a valid or lane bit, the answer is
  // the constant (NEG, -1, 0); the lane bits kept for the lists
  int last = -1;
  for (int i = tid; i < N; i += NT) {
    const int x = g.lane1[i] | (g.lane2[i] << 1);
    fl[i] = x;
    if (x | g.valid[i]) last = i;
  }
  if (SCAN)  // the last block's rows past N: no lane bit
    for (int i = N + tid; i < Np; i += NT) fl[i] = 0;
  // block 0's record, its loads beside the scan's (harmless when the
  // problem turns out empty)
  if (warp == 1) record<SCAN>(g, 0, tri[0], lane, N);
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1)
    last = max(last, __shfl_xor_sync(FULL, last, o2));
  if (lane == 0 && last >= 0) atomicMax(&s_last, last);
  __syncthreads();
  const int neff = s_last + 1, nb = (neff + L - 1) / L;
  write_empty(q, nb * L + tid, N, NT);
  if (nb == 0) return;
  if (warp == 0) {
    // receiver lists per lane in row order, and each block's start
    const unsigned lt = (1u << lane) - 1;
    int c0 = 0, c1 = 0;
    for (int base = 0; base < nb * L; base += 32) {
      if ((base & (L - 1)) == 0 && lane == 0) {
        rstart[base / L] = c0;
        rstart[NB1 + base / L] = c1;
      }
      const int i = base + lane;
      const bool h1 = fl[i] & 1, h2 = fl[i] & 2;
      const unsigned m1 = __ballot_sync(FULL, h1);
      const unsigned m2 = __ballot_sync(FULL, h2);
      if (h1) rc[c0 + __popc(m1 & lt)] = (uint16_t)i;
      if (h2) rc[Np + c1 + __popc(m2 & lt)] = (uint16_t)i;
      c0 += __popc(m1);
      c1 += __popc(m2);
    }
    if (lane == 0) {
      rstart[nb] = c0;
      rstart[NB1 + nb] = c1;
    }
  }
  for (int i = tid; i < nb * L; i += NT) {
    rbv[i] = NEG;
    rbv[Np + i] = NEG;
    rba[i] = 0;
    rba[Np + i] = 0;
  }
  triangle<SCAN>(tri[0], min(neff, L), cost, warp, NT >> 5, lane);
  __syncthreads();
  for (int b = 0; b < nb; ++b) {
    const int b0 = b * L;
    const Staged& prev = st[(b + 1) & 1];  // block b - 1
    // A: block b-1 into block b's receivers
    if (b > 0)
      fold<true, SCAN>(g, prev, tri[b & 1], b0, rcv, rstart[b],
                       rstart[b + 1], rstart[NB1 + b], rstart[NB1 + b + 1],
                       rb, cost, tid, NT);
    __syncthreads();
    // B: resolve block b; beside it, block b-1 into every later block's
    // receivers and block b+1's rows and triangle
    if (warp == 0) {
      resolve<SCAN>(q, b0, min(neff - b0, L), N - b0, tri[b & 1], &rb,
                    &st[b & 1], lane);
    } else {
      // block b+1's record first (its loads overlap the fold), the
      // folders' named barrier 1, then its triangle
      const bool next = b + 1 < nb;
      if (next && warp == 1)
        record<SCAN>(g, b0 + L, tri[(b + 1) & 1], lane, N);
      if (b > 0)
        fold<false, SCAN>(g, prev, tri[b & 1], b0, rcv, rstart[b + 1],
                          rstart[nb], rstart[NB1 + b + 1], rstart[NB1 + nb],
                          rb, cost, tid - 32, NT - 32);
      if (next) {
        asm volatile("bar.sync 1, %0;" ::"r"(NT - 32) : "memory");
        triangle<SCAN>(tri[(b + 1) & 1], min(neff - b0 - L, L), cost,
                       warp - 1, (NT >> 5) - 1, lane);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(MAXT)
sdp_blocked_cta_kernel(Frag f, Out o, Pwl ph, int N) {
  cta_body<false, false>(f, o, ph, Scan{}, N);
}

template <bool SCRATCH>
__global__ void __launch_bounds__(MAXT)
scan_cta_kernel(Frag f, Out o, Scan sc) {
  cta_body<true, SCRATCH>(f, o, Pwl{}, sc, sc.N);
}

// the CTA tier's dynamic shared memory for Np rows (ops/sdp_blocked.py's
// sdp_plan and ops/sdp.py's scan_plan compute the same)
template <bool SCRATCH>
__host__ __device__ inline size_t cta_smem(int Np) {
  return 2 * sizeof(Tri) + 2 * sizeof(Staged) +
         (SCRATCH ? 0 : lists_bytes(Np));
}

constexpr int SMEM_MAX = 232448;

// Let a kernel take `bytes` of dynamic shared memory (0: all that its
// static tables leave of SMEM_MAX), once per device (done: a bit per
// device; a launch's own need is checked by its entry point, and a
// launch past the limit fails).
cudaError_t allow_smem(const void* kern, int bytes,
                       std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done.load() >> dev & 1) return cudaSuccess;
  if (bytes == 0) {
    cudaFuncAttributes a;
    if ((e = cudaFuncGetAttributes(&a, kern)) != cudaSuccess) return e;
    bytes = SMEM_MAX - (int)a.sharedSizeBytes;
  }
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done.fetch_or(1ull << dev);
  return e;
}
constexpr int SCAN_MAX_N = 65536;  // uint16 rows in the lists

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// qS, qE, tS, tE: int32 [B, N]; score: f32; lane1, lane2, valid: uint8;
// V: f32, bp, lane: int32 [B, N]; pwl_host: slope[25], inter[25],
// ceiling1, ceiling2 (f32, host memory); tier (0 warp, 1 CTA), threads and
// smem from ops/sdp_blocked.py:sdp_plan.  One thread block a problem.
extern "C" int lra_chain_scores_blocked(
    const void* qS, const void* qE, const void* tS, const void* tE,
    const void* score, const void* lane1, const void* lane2,
    const void* valid, void* V, void* bp, void* lane, const void* pwl_host,
    int B, int N, int tier, int threads, int smem, void* stream) {
  if (B == 0) return 0;
  if (N < L || N % L || N > 8192 || threads < 32 || threads % 32 ||
      threads > MAXT)
    return (int)cudaErrorInvalidValue;
  Pwl p;
  memcpy(&p, pwl_host, sizeof(Pwl));
  const Frag f = {(const int*)qS,       (const int*)qE,
                  (const int*)tS,       (const int*)tE,
                  (const float*)score,  (const uint8_t*)lane1,
                  (const uint8_t*)lane2, (const uint8_t*)valid};
  const Out o = {(float*)V, (int*)bp, (int*)lane};
  const cudaStream_t s = (cudaStream_t)stream;
  if (tier == 0) {
    if (N != L || threads != 32 || (size_t)smem < sizeof(Tri))
      return (int)cudaErrorInvalidValue;
    sdp_blocked_warp_kernel<<<B, threads, smem, s>>>(f, o, p);
  } else if (tier == 1) {
    const size_t most = cta_smem<false>(8192);
    if (threads < 64 || (size_t)smem < cta_smem<false>(N) ||
        (size_t)smem > most)
      return (int)cudaErrorInvalidValue;
    static std::atomic<unsigned long long> done{0};
    const cudaError_t e =
        allow_smem((const void*)sdp_blocked_cta_kernel, (int)most, done);
    if (e != cudaSuccess) return (int)e;
    sdp_blocked_cta_kernel<<<B, threads, smem, s>>>(f, o, p, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8: qS, qE, tS, tE: int32 [B, N]; score: f32; lane1, lane2, valid:
// uint8; slope, inter: f32 [24] on the device; V: f32, bp, lane: int32
// [B, N]; scratch: tier 2's, B * scan_scratch(Np) bytes (else unused);
// c1, c2: the ceilings (f32).  tier (0 warp, 1 CTA, 2 CTA with the lists
// in scratch), threads and smem from ops/sdp.py:scan_plan.  One thread
// block a problem.
extern "C" int lra_chain_scores_scan(
    const void* qS, const void* qE, const void* tS, const void* tE,
    const void* score, const void* lane1, const void* lane2,
    const void* valid, const void* slope, const void* inter, void* V,
    void* bp, void* lane, void* scratch, float c1, float c2, int B, int N,
    int tier, int threads, int smem, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (N < 0 || N > SCAN_MAX_N || threads < 32 || threads % 32 ||
      threads > MAXT || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int Np = (N + L - 1) / L * L;
  const Frag f = {(const int*)qS,       (const int*)qE,
                  (const int*)tS,       (const int*)tE,
                  (const float*)score,  (const uint8_t*)lane1,
                  (const uint8_t*)lane2, (const uint8_t*)valid};
  const Out o = {(float*)V, (int*)bp, (int*)lane};
  const Scan sc = {(const float*)slope, (const float*)inter, c1, c2, N,
                   (uint8_t*)scratch};
  const cudaStream_t s = (cudaStream_t)stream;
  if (tier == 0) {
    if (N > L || threads != 32 || (size_t)smem < sizeof(Tri))
      return (int)cudaErrorInvalidValue;
    scan_warp_kernel<<<B, threads, smem, s>>>(f, o, sc);
  } else if (tier == 1) {
    if (N <= L || threads < 64 || (size_t)smem < cta_smem<false>(Np))
      return (int)cudaErrorInvalidValue;
    static std::atomic<unsigned long long> done{0};
    const cudaError_t e =
        allow_smem((const void*)scan_cta_kernel<false>, 0, done);
    if (e != cudaSuccess) return (int)e;
    scan_cta_kernel<false><<<B, threads, smem, s>>>(f, o, sc);
  } else if (tier == 2) {
    if (N <= L || threads < 64 || scratch == nullptr ||
        (size_t)smem < cta_smem<true>(Np))
      return (int)cudaErrorInvalidValue;
    static std::atomic<unsigned long long> done{0};
    const cudaError_t e =
        allow_smem((const void*)scan_cta_kernel<true>, 0, done);
    if (e != cudaSuccess) return (int)e;
    scan_cta_kernel<true><<<B, threads, smem, s>>>(f, o, sc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
