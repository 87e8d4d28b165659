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
// product that could be contracted into an inexact FMA.  Rows past
// tBoundary (prefix) or tlen (suffix) hold no valid cell in the reference
// either: they are not computed, and the traceback reads them as -1.
//
// Bound: latency.  Every K6 launch on chip_smoke.py's paths has K = 16 or
// 32 (bands of 33-68 cells); the costly ones are buckets of 8-64 problems
// of up to ~500 rows (D = 256-512), one warp's chain of rows each: a row
// is a few hundred dependent instructions (the closure's 6-7 shuffle
// steps, the masks, the arrows) at well under one instruction a cycle.
// The work is (rows x band) cells of a few f32 operations.
//
// Design (ops/one_gap.py:one_gap_plan chooses the tier and the layout):
// - Warp tier, K = 16 or 32.  A band row lives in one warp, lane l owning
//   the CPT (2, or 3 at K = 32) contiguous cells d = l * CPT + c; the row
//   stays in registers.  A doubling step of the closure takes cell e - sh
//   from lane - dl, cell sc, both fixed at compile time: one shuffle a
//   cell, none inside the lane; no barrier.  Pad cells past the band are
//   invalid (NEGF, arrow -1), as the reference's NEGF shift-in gives.
//   Each cell's masks are row ranges computed once a problem; a row is
//   branch-free.  The substitution reads the head/tail windows, staged in
//   shared memory as bytes once per problem.
// - lowerMax (value, last cell) is a warp reduction (two __reduce_max_sync
//   on the exact integer values, the float taken from the winning lane).
//   upperMax is a register window: at row j cell d holds up[j + d], so it
//   moves one cell a row (one shuffle) and the entry that leaves at cell 0
//   is final; it goes to the gap tables with its row.  A row's arrows,
//   reduction and window run beside the next row's closure.  The tables
//   (lmax/lidx by column, up/upi by padded row) live in shared memory
//   while they fit, else in device scratch.
// - WPP = 3 (buckets that leave the card idle): the prefix on warp 0, the
//   suffix DP beside it on warp 1, the suffix's arrows on warp 2.  Suffix
//   row s reads lmax[tLow + 1 + s] (query longer) or up[] up to padded
//   index s + lagB (target longer), each final once the prefix has
//   finished the row of that index; the prefix warp publishes its last
//   finished row in shared memory (a release store) and the suffix warp
//   waits on it (acquire loads).  The suffix DP puts each row's values in
//   a ring of RING rows; the arrows warp recomputes the row's terms from
//   them (the same operands, the same bits) and writes its arrows.  WPP =
//   1 (full buckets: 4 problems a block): one warp runs prefix, suffix and
//   walk.  The kernel is instantiated per placement of tables and planes,
//   so that shared-memory accesses compile to shared-memory instructions.
// - Arrow planes: int8, pitch 2K+4, in shared memory while a problem's
//   fit, else in device scratch.  Lane 0 walks; from shared memory each
//   step is one shared load (a run of DIAG up to 4 rows a turn), from
//   device memory the walk reads chunks of R rows staged by 16-byte
//   cp.async, the next lower chunk in flight.  The ops gather in shared
//   memory and go out in 4-byte stores.
// - CTA tier, K >= 64 (no launch on chip_smoke.py's paths): one CTA per
//   problem, CPT 1, 2 or 4 lanes a thread (up to K = 1024 with 544
//   threads), the closure in a shared ping-pong (one barrier a step),
//   lowerMax a block reduction, upperMax a row-ordered global update,
//   planes and tables in device scratch, thread 0 walks.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEGF = -1.0e9f;
constexpr int DONE = 0, LEFT = 1, DOWN = 2, DIAG = 3, GAPLEFT = 5,
              GAPDOWN = 6;
constexpr int PADC = 9;  // the reference's pad code outside the windows
constexpr unsigned FULL = 0xffffffffu;
constexpr int RING = 8;  // suffix rows the DP warp may run ahead of its
                         // arrows warp (WPP = 3)

__host__ __device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__host__ __device__ __forceinline__ int a16(int x) { return (x + 15) & ~15; }

// ceil(log2(max(2, width))): the reference's closure step count
__host__ __device__ constexpr int log_steps(int width) {
  int s = 0;
  while ((1 << s) < (width > 2 ? width : 2)) ++s;
  return s;
}

// (value, lane) max with the larger lane winning ties
__device__ __forceinline__ void better_last(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi > i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// ------------------------------------------------------- the layout ---
// One problem's shared memory in the warp tier (byte offsets, 16-aligned)
// and its device scratch; ops/one_gap.py:_og_group_bytes and
// _og_scratch_bytes compute the same sizes.
struct Layout {
  int prog, qh, th, qt, tt, ops, ring, lmax, lidx, up, upi, parr, sarr,
      stage;
  int group;       // shared bytes a problem
  int plane_g;     // device bytes a problem's planes take (0: in shared)
  int table_g;     // device bytes a problem's tables take (0: in shared)
};

__host__ __device__ inline Layout og_layout(int K, int D, int L,
                                            int tables_smem,
                                            int planes_smem, int R) {
  const int HP = D + K, HS = D + K + 4, TP1 = D + K, TS1 = D + K + 3;
  const int UP = D + 3 * K + 4, PW = 2 * K + 4;
  Layout o{};
  int off = 0;
  o.prog = off;
  off += 16;
  o.qh = off;
  off += a16(HP);
  o.th = off;
  off += a16(HP);
  o.qt = off;
  off += a16(HS);
  o.tt = off;
  off += a16(HS);
  o.ops = off;
  off += a16(L);
  o.ring = off;  // RING suffix rows of 32 * CPT floats (K = 16: CPT 2)
  off += RING * 32 * (K == 16 ? 2 : 3) * 4;
  const int tb[4] = {4 * TP1, 4 * TP1, 4 * UP, 4 * UP};
  int* tofs[4] = {&o.lmax, &o.lidx, &o.up, &o.upi};
  int toff = 0;
  for (int k = 0; k < 4; ++k) {
    if (tables_smem) {
      *tofs[k] = off;
      off += a16(tb[k]);
    } else {
      *tofs[k] = toff;
      toff += a16(tb[k]);
    }
  }
  o.table_g = tables_smem ? 0 : toff;
  if (planes_smem) {
    o.parr = off;
    off += a16(TP1 * PW);
    o.sarr = off;
    off += a16(TS1 * PW);
    o.plane_g = 0;
  } else {
    o.parr = 0;
    o.sarr = a16(TP1 * PW);
    o.plane_g = o.sarr + a16(TS1 * PW);
    o.stage = off;
    off += 2 * a16(R * PW + 32);
  }
  o.group = off;
  return o;
}

// --------------------------------------------------------- warp tier ---

// row[e] = max(row[e], row[e - sh] + indel*sh), sh = 1, 2, 4, ... (NS
// steps) over the warp's cells, NEGF shifted in below cell 0.  Cell
// e = lane * CPT + c takes e - sh from lane - dl, cell sc, both fixed at
// compile time for each (c, sh): one shuffle a cell, none where dl = 0.
template <int CPT, int NS>
__device__ __forceinline__ void closure_warp(float (&x)[CPT], int lane,
                                             float indel) {
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    const int sh = 1 << st;
    const float add = indel * (float)sh;  // exact: small integers
    float src[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int t = c - sh;
      const int dl = t >= 0 ? 0 : (CPT - 1 - t) / CPT;
      const int sc = t + dl * CPT;
      if (dl == 0) {
        src[c] = x[sc];
      } else {
        const float v = __shfl_up_sync(FULL, x[sc], dl);
        src[c] = lane >= dl ? v : NEGF;
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) x[c] = fmaxf(x[c], __fadd_rn(src[c], add));
  }
}

// the row's value at the cell right of each of this lane's cells
template <int CPT>
__device__ __forceinline__ void right_of(const float (&r)[CPT],
                                         float (&n)[CPT], int lane) {
  const float v = __shfl_down_sync(FULL, r[0], 1);
#pragma unroll
  for (int c = 0; c < CPT - 1; ++c) n[c] = r[c + 1];
  n[CPT - 1] = lane == 31 ? NEGF : v;
}

// the row's value at the cell left of each of this lane's cells
template <int CPT>
__device__ __forceinline__ void left_of(const float (&r)[CPT],
                                        float (&n)[CPT], int lane) {
  const float v = __shfl_up_sync(FULL, r[CPT - 1], 1);
#pragma unroll
  for (int c = CPT - 1; c > 0; --c) n[c] = r[c - 1];
  n[0] = lane == 0 ? NEGF : v;
}

// this lane's CPT arrow bytes (cells below width): one 2-byte store at
// CPT 2 (the row pitch holds the lane's last cell), else byte stores
template <int CPT>
__device__ __forceinline__ void store_arrows(uint8_t* p, const int (&a)[CPT],
                                             int lane, int width) {
  if (CPT == 2) {
    if (lane * CPT < width)
      *(unsigned short*)p =
          (unsigned short)((a[0] & 0xff) | (unsigned)(a[1] & 0xff) << 8);
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (lane * CPT + c < width) p[c] = (uint8_t)a[c];
  }
}

struct Prob {
  int qlen, tlen, kband, diag;
};

// tables_smem, planes_smem: the plan's placement (the kernel's TS, PS);
// each warp function recomputes the layout from them.  (Passing it the
// kernel's compile-time layout instead made the K = 32 rows about a
// quarter slower on the card: tools/kernel_compare.py k6.)
struct WarpArgs {
  const int *qh, *th, *qt, *tt, *qlen, *tlen, *kband;
  uint8_t* scratch;
  int8_t* ops;
  int* jump;
  float* score;
  int B, D, L, WPP, PPB, tables_smem, planes_smem, R;
  float m, mm, indel;
};

// A progress word in shared memory (the prefix warp's rows with their
// table entries stored, the suffix rows in the ring, the suffix rows with
// their arrows): published with release semantics, read with acquire
// semantics, so that what it covers is visible to the reader.
__device__ __forceinline__ void publish_rows(int* prog, int rows) {
  asm volatile("st.release.cta.shared.s32 [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(prog)),
               "r"(rows)
               : "memory");
}

// Wait until a progress word reaches `need`; `have` keeps the last value
// read.
__device__ __forceinline__ void wait_rows(int* prog, int need, int& have) {
  if (need <= have) return;
  const unsigned at = (unsigned)__cvta_generic_to_shared(prog);
  do {
    asm volatile("ld.acquire.cta.shared.s32 %0, [%1];\n"
                 : "=r"(have)
                 : "r"(at)
                 : "memory");
  } while (have < need);
  __syncwarp();
}

template <int K, int CPT>
__device__ __forceinline__ void prefix_warp(const WarpArgs& a, uint8_t* g,
                                            const Prob& p, int lane,
                                            float* lmax, int* lidx, float* up,
                                            int* upi, uint8_t* parr, int jP) {
  constexpr int LP = 2 * K + 1, PW = 2 * K + 4, NS = log_steps(LP);
  const int D = a.D, HP = D + K;
  const Layout lay = og_layout(K, D, a.L, a.tables_smem, a.planes_smem, a.R);
  const float m = a.m, mm = a.mm, indel = a.indel;
  const int8_t* qs = (const int8_t*)(g + lay.qh);
  const int8_t* ts = (const int8_t*)(g + lay.th);
  int* prog = (int*)(g + lay.prog);
  const bool publish = a.WPP > 1;
  const int qlen = p.qlen, tlen = p.tlen, kband = p.kband, diag = p.diag;
  const int qB1 = min(diag + kband - 1, qlen);

  // Each cell's conditions as row ranges (cell d, offs = d - K, i = j +
  // offs; every row j <= jP has j <= tBoundary - 1): valid for j in
  // [1 - offs, qB1 - offs] (1 <= i <= qB1, in the kband band); lowerMax
  // candidate also up to min(qlen - kband - 1 - offs, diag); upperMax
  // candidate up to min(diag - offs, tlen - 1); the i = 0 rail cell at
  // j = -offs; the rail injected into the i = 1 cell at j = 1 - offs <=
  // kband + 1.  Pad cells (d >= LP) are outside the band: never valid.
  int vlo[CPT], vhi[CPT], lmhi[CPT], umhi[CPT], i0j[CPT], railj[CPT];
  float prev[CPT], W[CPT];
  int Wi[CPT];
  {
    int ar[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = lane * CPT + c, offs = d - K;
      const bool inb = abs(offs) <= kband;
      vlo[c] = 1 - offs;
      vhi[c] = inb ? qB1 - offs : INT_MIN;
      lmhi[c] = min(vhi[c], min(qlen - kband - 1 - offs, diag));
      umhi[c] = min(vhi[c], min(diag - offs, tlen - 1));
      i0j[c] = inb && offs < 0 ? -offs : -1;
      railj[c] = 1 - offs <= vhi[c] && 1 - offs <= kband + 1 ? 1 - offs : -1;
      // row j = 0: P[i, 0] = indel * i for 0 <= i <= kband
      float v = (offs >= 0 && inb) ? indel * (float)offs : NEGF;
      if (offs > qB1) v = NEGF;
      prev[c] = v;
      ar[c] = (inb && offs <= qB1) ? (offs > 0 ? LEFT : (offs == 0 ? DONE : -1))
                                   : -1;
      // the window at row 1: cell d holds up[1 + d] (its initial value)
      W[c] = (1 + d == K && qlen <= tlen) ? 0.f : NEGF;
      Wi[c] = 0;
    }
    store_arrows<CPT>(parr + lane * CPT, ar, lane, LP);
  }

  // Row j's recurrence (begin: the base values from row j - 1 in prev;
  // end: the closure), and row r's work off it (finish: arrows, the
  // lowerMax reduction, the upperMax window, updated and moved one cell,
  // entry r leaving it final, and the table entries of row r), which runs
  // beside row r + 1's closure.  Branch-free: conditions are selects.
  float x[CPT], sDel[CPT], sDelP[CPT], railP[CPT];
  int code[CPT];  // a row's arrow where it is fixed: DOWN (i = 0), -1
                  // (not valid), or -2 (the DP's arrow)
  auto begin_row = [&](int j) {
    const int tj = ts[min(j - 1, HP - 1)];
    const float railv = indel * (float)(j + 1);
    float nxt[CPT];
    right_of<CPT>(prev, nxt, lane);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      // the q code of cell i (index i - 1); clamped reads feed only cells
      // that are not valid
      const int qc = qs[clampi(j + lane * CPT + c - K - 1, 0, HP - 1)];
      const float sMat = prev[c] + (qc == tj ? m : mm);
      sDel[c] = nxt[c] + indel;
      const float rail = j == railj[c] ? railv : NEGF;
      const bool valid = (j >= vlo[c]) & (j <= vhi[c]);
      x[c] = valid ? fmaxf(fmaxf(sMat, sDel[c]), rail) : NEGF;
    }
  };
  auto end_row = [&](int j) {
    closure_warp<CPT, NS>(x, lane, indel);
    const float i0v = indel * (float)j, railv = indel * (float)(j + 1);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const bool valid = (j >= vlo[c]) & (j <= vhi[c]);
      const bool i0 = j == i0j[c];
      prev[c] = i0 ? i0v : (valid ? x[c] : NEGF);
      code[c] = i0 ? DOWN : (valid ? -2 : -1);
      sDelP[c] = sDel[c];
      railP[c] = j == railj[c] ? railv : NEGF;
    }
  };
  auto finish_row = [&](int r) {
    float left[CPT];
    left_of<CPT>(prev, left, lane);
    int ar[CPT];
    float bv = -INFINITY;
    int bi = -1;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = lane * CPT + c;
      const float v = prev[c];
      const bool is_ins = (v == left[c] + indel) | (v == railP[c]);
      ar[c] = code[c] != -2 ? code[c]
                            : (is_ins ? LEFT : (v == sDelP[c] ? DOWN : DIAG));
      // lowerMax[r]: main cells with i < qlen - kband, last lane wins
      const bool valid = code[c] == -2;
      const float lm = valid & (r <= lmhi[c]) ? v : NEGF;
      const bool take = (d < LP) & (lm >= bv);
      bv = take ? lm : bv;
      bi = take ? d : bi;
      // upperMax[i], padded index i + K = r + d: strict >, earliest r
      const float cand = valid & (r <= umhi[c]) ? v : NEGF;
      const bool upd = cand > W[c];
      W[c] = upd ? cand : W[c];
      Wi[c] = upd ? r : Wi[c];
    }
    store_arrows<CPT>(parr + (size_t)r * PW + lane * CPT, ar, lane, LP);
    // the warp's (value, last cell): the values are exact integers, so
    // their int order is the float order
    const int vi = bi >= 0 ? __float2int_rz(bv) : INT_MIN;
    const int vmax = __reduce_max_sync(FULL, vi);
    const int imax = __reduce_max_sync(FULL, vi == vmax ? bi : -1);
    const float lv = __shfl_sync(FULL, bv, imax / CPT);
    const float w0 = __shfl_down_sync(FULL, W[0], 1);
    const int wi0 = __shfl_down_sync(FULL, Wi[0], 1);
    if (lane == 0) {
      up[r] = W[0];
      upi[r] = Wi[0];
      lmax[r] = lv;
      lidx[r] = r + imax - K;
    }
#pragma unroll
    for (int c = 0; c < CPT - 1; ++c) {
      W[c] = W[c + 1];
      Wi[c] = Wi[c + 1];
    }
    W[CPT - 1] = lane == 31 ? NEGF : w0;
    Wi[CPT - 1] = lane == 31 ? 0 : wi0;
  };
  if (jP >= 1) {
    begin_row(1);
    end_row(1);
  }
  for (int j = 2; j <= jP; ++j) {
    begin_row(j);
    finish_row(j - 1);  // beside row j's closure
    end_row(j);
    if (publish && lane == 0) publish_rows(prog, j - 1);
  }
  if (jP >= 1) finish_row(jP);
  // the window's entries past row jP are final too
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = lane * CPT + c;
    if (d < LP) {
      up[jP + 1 + d] = W[c];
      upi[jP + 1 + d] = Wi[c];
    }
  }
  __syncwarp();
  if (lane == 0) publish_rows(prog, INT_MAX);
}

// The suffix band of one problem: lanes e = i - j - (qlen - tlen) + K + 2;
// row s is column j = tLow + 1 + s (plane row s + 1; plane row 0 is the
// seed column tLow); the reference's pre-shift gathers are read in
// place.  Each cell's conditions as row ranges (i = ci + s; every row
// has j <= tlen): valid for s in [qLow + 1 - ci, qlen - ci] in the kband
// band; the delete term (query longer) up to diag - tLow - 1, the
// insertion term (target longer) up to diag - ci; the border-b seed
// (query longer) or the border-b' seed (target longer, where i = i_b) on
// [slo, shi]; the border-a seed (i = 0, target longer) at row bs.  Pad
// cells (e >= LS) are outside the band and seed nothing.
template <int K, int CPT>
struct Suffix {
  static constexpr int LS = 2 * K + 4;
  bool isA;
  int dqt, qStart, tLow, qLow, tzoff, qzoff, uoff2, ubidx, lag;
  int vlo[CPT], vhi[CPT], dhi[CPT], ihi[CPT], slo[CPT], shi[CPT], bs[CPT];

  __device__ __forceinline__ Suffix(const Prob& p, int D, int lane) {
    const int qlen = p.qlen, tlen = p.tlen, kband = p.kband, diag = p.diag;
    const int HS = D + K + 4;
    isA = qlen > tlen;
    dqt = qlen - tlen;
    qStart = qlen - diag;
    const int tStart = tlen - diag;
    tLow = max(0, tlen - diag - kband - 2);
    qLow = max(0, qlen - diag - kband - 1);
    const int eA_idx = qLow - 1 - dqt + K + 2;  // case A border-b lane
    const int eB_idx = K + kband + 3;           // case B border-b' lane
    const int tB_hi = min(tStart + kband + 1, tlen);
    tzoff = tLow - tlen + HS;
    qzoff = tLow - tlen - K - 2 + HS;  // q tail index of s + e
    uoff2 = tLow + 1 + dqt - 2;
    ubidx = tLow + 1 - tStart + kband + 1 + K;
    // the prefix rows suffix row s needs finished: s + lag.  Query
    // longer: lmax[tLow + 1 + s] (the delete term and the border-b seed).
    // Target longer: the insertion term of a band cell reads up[i + K],
    // i + K <= uoff2 + s + K + 2 + kband, and the border-b' seed
    // up[ubidx + s], the next entry (ubidx = uoff2 + K + 3 + kband); row
    // 0's up[K] is below both.  The seed's value reaches no output (the
    // cell below it takes the same entry as its insertion term, above the
    // seed plus indel), so the insertion term is the tight one; waiting
    // for the seed's entry keeps every value as the reference's.
    lag = isA ? tLow + 1 : ubidx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = lane * CPT + c, eo = e - (K + 2);
      const int ci = tLow + 1 + dqt + eo;
      const bool inb = abs(eo) <= kband;
      vlo[c] = qLow + 1 - ci;
      vhi[c] = inb ? qlen - ci : INT_MIN;
      dhi[c] = isA ? min(vhi[c], diag - tLow - 1) : INT_MIN;
      ihi[c] = isA ? INT_MIN : min(vhi[c], diag - ci);
      slo[c] = 0;
      shi[c] = -1;
      if (e < LS && isA && e == eA_idx) {
        slo[c] = -ci;
        shi[c] = min(diag - tLow - 1, qlen - ci);
      }
      if (e < LS && !isA && e == eB_idx) {
        slo[c] = 1 - ci;  // i = i_b here
        shi[c] = min(diag - ci, qlen - ci);
      }
      bs[c] = e < LS && !isA && -ci <= tB_hi - tLow - 1 ? -ci : -1;
    }
  }

  // row s's q-code matches (the substitution) and the delete term
  __device__ __forceinline__ int tcode(const int8_t* ts, int s) const {
    return ts[max(tzoff + s, 0)];  // tzoff + s <= HS - 1 (s < tlen - tLow)
  }
  __device__ __forceinline__ float lms(const float* lmax, int s,
                                       int TP1) const {
    const float v = lmax[clampi(tLow + 1 + s, 0, TP1 - 1)];
    return isA & (tLow + 1 + s < TP1) ? v : NEGF;
  }
  // a cell's arrow where it is fixed: GAPLEFT or GAPDOWN (a seed), -1
  // (not valid), or -2 (the DP's arrow); seeded: the border seed's kind
  __device__ __forceinline__ int code(int s, int c, bool& sk,
                                      bool& bB) const {
    const bool valid = (s >= vlo[c]) & (s <= vhi[c]);
    sk = (s >= slo[c]) & (s <= shi[c]);
    bB = s == bs[c];
    const bool seed = (sk | bB) & !valid;
    return seed ? (sk & isA ? GAPLEFT : GAPDOWN) : (valid ? -2 : -1);
  }
};

// The suffix DP of one problem on one warp.  Row s's recurrence (begin:
// the base values from row s - 1 in prev, once the prefix has finished
// the rows it reads; end: the closure).  ARROWS: the arrows of row r run
// in this warp, beside row r + 1's closure; else each row's values go to
// a ring of RING rows in shared memory, read by the arrows warp
// (suffix_arrows), which has finished row r - RING + 1 before row r
// overwrites its slot.  Branch-free: conditions are selects, table reads
// clamped and unconditional.
template <int K, int CPT, bool ARROWS>
__device__ __forceinline__ void suffix_warp(const WarpArgs& a, uint8_t* g,
                                            const Prob& p, int lane,
                                            const float* lmax,
                                            const float* up, uint8_t* sarr,
                                            int sRows, float* score) {
  constexpr int LS = 2 * K + 4, PW = 2 * K + 4, NS = log_steps(LS);
  const int D = a.D, HS = D + K + 4, TP1 = D + K;
  const Layout lay = og_layout(K, D, a.L, a.tables_smem, a.planes_smem, a.R);
  const int UP = D + 3 * K + 4;
  const float m = a.m, mm = a.mm, indel = a.indel;
  const int8_t* qs = (const int8_t*)(g + lay.qt);
  const int8_t* ts = (const int8_t*)(g + lay.tt);
  int* prog = (int*)(g + lay.prog);
  float* ring = (float*)(g + lay.ring);
  const int tlen = p.tlen, kband = p.kband;
  const Suffix<K, CPT> f(p, D, lane);
  int have = 0, room = 0;

  wait_rows(prog, f.lag, have);
  const float upK = f.isA ? NEGF : up[K];
  float prev[CPT];
  {  // row 0 (column tLow): border seeds
    const float lm_tlow = f.isA ? lmax[clampi(f.tLow, 0, TP1 - 1)] : NEGF;
    int ar[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = lane * CPT + c;
      const int i0 = f.tLow + f.dqt + e - (K + 2);
      const bool bA = e < LS && f.isA && i0 >= f.qLow &&
                      i0 <= f.qStart + kband;
      const bool bB = e < LS && !f.isA && i0 == 0;
      prev[c] = bA ? lm_tlow : (bB ? upK : NEGF);
      ar[c] = bA ? GAPLEFT : (bB ? GAPDOWN : -1);
      if (!ARROWS) ring[lane * CPT + c] = prev[c];
    }
    store_arrows<CPT>(sarr + lane * CPT, ar, lane, LS);
  }

  float x[CPT], sMat[CPT], sDel[CPT], delC[CPT], seedv[CPT];
  float sMatP[CPT], sDelP[CPT], delCP[CPT];
  int code[CPT], codeP[CPT];
  auto begin_row = [&](int s) {
    wait_rows(prog, s + f.lag, have);
    const int tcode = f.tcode(ts, s);
    const float lms = f.lms(lmax, s, TP1);
    const float up_s = up[clampi(f.ubidx + s, 0, UP - 1)];
    const float ubs = !f.isA & (f.ubidx + s < UP) ? up_s : NEGF;
    float nxt[CPT];
    right_of<CPT>(prev, nxt, lane);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = lane * CPT + c;
      // the q code of cell i; clamped reads feed only cells that are not
      // valid
      const int qc = qs[clampi(f.qzoff + s + e, 0, HS - 1)];
      sMat[c] = prev[c] + (qc == tcode ? m : mm);
      sDel[c] = nxt[c] + indel;
      const bool lo = s >= f.vlo[c];
      delC[c] = lo & (s <= f.dhi[c]) ? lms : NEGF;
      // the insertion term: up[i + K], 1 <= i <= diag
      const float ins = up[clampi(f.uoff2 + s + e, 0, UP - 1)];
      const float insC = lo & (s <= f.ihi[c]) ? ins : NEGF;
      const float base =
          fmaxf(fmaxf(sMat[c], sDel[c]), fmaxf(delC[c], insC));
      // border seeds of this column, injected before the closure
      bool sk, bB;
      code[c] = f.code(s, c, sk, bB);
      seedv[c] = sk ? (f.isA ? lms : ubs) : upK;
      x[c] = code[c] >= 0 ? seedv[c] : (code[c] == -2 ? base : NEGF);
    }
  };
  auto end_row = [&]() {
    closure_warp<CPT, NS>(x, lane, indel);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      // seed cells keep the pure seed (assigned, never maxed)
      prev[c] = code[c] >= 0 ? seedv[c] : (code[c] == -2 ? x[c] : NEGF);
      sMatP[c] = sMat[c];
      sDelP[c] = sDel[c];
      delCP[c] = delC[c];
      codeP[c] = code[c];
    }
  };
  float acc = NEGF;
  auto finish_row = [&](int r) {
    float left[CPT];
    left_of<CPT>(prev, left, lane);
    int ar[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = lane * CPT + c;
      const float v = prev[c];
      const int ac =
          v == left[c] + indel
              ? LEFT
              : (v == sDelP[c] ? DOWN
                               : (v == sMatP[c] ? DIAG
                                                : (v == delCP[c] ? GAPLEFT
                                                                 : GAPDOWN)));
      ar[c] = codeP[c] == -2 ? ac : codeP[c];
      acc = e == K + 2 && f.tLow + 1 + r == tlen ? v : acc;
    }
    store_arrows<CPT>(sarr + (size_t)(r + 1) * PW + lane * CPT, ar, lane,
                      LS);
  };
  // row s's values into ring slot (s + 1) % RING, once the arrows warp
  // has finished the row that held it
  int* rprog = prog + 1;   // rows the DP warp has put in the ring
  int* aprog = prog + 2;   // rows the arrows warp has finished
  auto push_row = [&](int s) {
    wait_rows(aprog, s + 2 - RING, room);
    float* slot = ring + ((s + 1) % RING) * 32 * CPT + lane * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) slot[c] = prev[c];
    __syncwarp();
    if (lane == 0) publish_rows(rprog, s + 1);
  };
  if (sRows >= 1) {
    begin_row(0);
    end_row();
    if (!ARROWS) push_row(0);
  }
  for (int s = 1; s < sRows; ++s) {
    begin_row(s);
    if (ARROWS) finish_row(s - 1);  // beside row s's closure
    end_row();
    if (!ARROWS) push_row(s);
  }
  if (ARROWS) {
    if (sRows >= 1) finish_row(sRows - 1);
    if (lane == (K + 2) / CPT) *score = acc;
  }
}

// The arrows of the suffix rows that suffix_warp<..., false> puts in the
// ring: row s's terms again from row s - 1's values (the same operands,
// so the same bits), then its arrows, as finish_row.
template <int K, int CPT>
__device__ __forceinline__ void suffix_arrows(const WarpArgs& a, uint8_t* g,
                                                const Prob& p, int lane,
                                              const float* lmax,
                                              uint8_t* sarr, int sRows,
                                              float* score) {
  constexpr int LS = 2 * K + 4, PW = 2 * K + 4;
  const int D = a.D, HS = D + K + 4, TP1 = D + K;
  const Layout lay = og_layout(K, D, a.L, a.tables_smem, a.planes_smem, a.R);
  const float m = a.m, mm = a.mm, indel = a.indel;
  const int8_t* qs = (const int8_t*)(g + lay.qt);
  const int8_t* ts = (const int8_t*)(g + lay.tt);
  int* prog = (int*)(g + lay.prog);
  const float* ring = (const float*)(g + lay.ring);
  const Suffix<K, CPT> f(p, D, lane);
  int have = 0;
  float acc = NEGF;
  for (int s = 0; s < sRows; ++s) {
    wait_rows(prog + 1, s + 1, have);
    const float* r0 = ring + (s % RING) * 32 * CPT + lane * CPT;
    const float* r1 = ring + ((s + 1) % RING) * 32 * CPT + lane * CPT;
    float pv[CPT], v[CPT], nxt[CPT], left[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      pv[c] = r0[c];
      v[c] = r1[c];
    }
    right_of<CPT>(pv, nxt, lane);
    left_of<CPT>(v, left, lane);
    const int tcode = f.tcode(ts, s);
    const float lms = f.lms(lmax, s, TP1);
    int ar[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int e = lane * CPT + c;
      const int qc = qs[clampi(f.qzoff + s + e, 0, HS - 1)];
      const float sMat = pv[c] + (qc == tcode ? m : mm);
      const float sDel = nxt[c] + indel;
      const float delC = (s >= f.vlo[c]) & (s <= f.dhi[c]) ? lms : NEGF;
      bool sk, bB;
      const int cd = f.code(s, c, sk, bB);
      const int ac =
          v[c] == left[c] + indel
              ? LEFT
              : (v[c] == sDel ? DOWN
                              : (v[c] == sMat ? DIAG
                                              : (v[c] == delC ? GAPLEFT
                                                              : GAPDOWN)));
      ar[c] = cd == -2 ? ac : cd;
      acc = e == K + 2 && f.tLow + 1 + s == p.tlen ? v[c] : acc;
    }
    store_arrows<CPT>(sarr + (size_t)(s + 1) * PW + lane * CPT, ar, lane,
                      LS);
    __syncwarp();
    if (lane == 0) publish_rows(prog + 2, s + 1);
  }
  if (lane == (K + 2) / CPT) *score = acc;
}

// One step of the traceback from (i, j) given the arrow a there; returns
// false at the end (a stop code or off the matrix).
struct Walker {
  int i, j, phase, jump, step;
};

__device__ __forceinline__ bool walk_step(Walker& w, int a, const int* lidx,
                                          const int* upi, int K, int TP1,
                                          int UP, int8_t* ops_s) {
  if (!(w.i >= 0 && w.j >= 0 && a >= 0 && a != DONE)) return false;
  ops_s[w.step++] = (int8_t)a;
  if (a == GAPLEFT) {
    const int li = lidx[clampi(w.j, 0, TP1 - 1)];
    w.jump = w.i - li;
    w.i = li;
    w.phase = 1;
  } else if (a == GAPDOWN) {
    const int lj = upi[clampi(w.i + K, 0, UP - 1)];
    w.jump = w.j - lj;
    w.j = lj;
    w.phase = 1;
  } else {
    if (a == DIAG || a == LEFT) --w.i;
    if (a == DIAG || a == DOWN) --w.j;
  }
  return true;
}

// The plane row and band cell the walk reads at (i, j) in its phase, or
// row -1 where the reference reads -1 (a row not computed).
__device__ __forceinline__ void walk_cell(const Walker& w, int K, int tLow,
                                          int dqt, int TP1, int TS1, int jP,
                                          int sRows, int& row, int& cell) {
  if (w.phase == 0) {
    row = clampi(w.j - tLow, 0, TS1 - 1);
    cell = clampi(w.i - w.j - dqt + K + 2, 0, 2 * K + 3);
    if (row > sRows) row = -1;
  } else {
    row = clampi(w.j, 0, TP1 - 1);
    cell = clampi(w.i - w.j + K, 0, 2 * K);
    if (row > jP) row = -1;
  }
}

// Rows [lo, hi] of a device plane (pitch PW) into buf by 16-byte cp.async
// copies of the aligned span that holds them; returns the span's start.
__device__ __forceinline__ int stage_span(uint8_t* buf, const uint8_t* pl,
                                          int lo, int hi, int PW, int lane) {
  const int a0 = (lo * PW) & ~15, a1 = a16((hi + 1) * PW);
  for (int v = lane; v < (a1 - a0) / 16; v += 32)
    cp_async16(buf + 16 * v, pl + a0 + 16 * v);
  asm volatile("cp.async.commit_group;\n" ::);
  return a0;
}

// The traceback by one warp (lane 0 steps): suffix walk, the gap jump,
// the prefix walk; ops end-first into ops_s (-1 filled), jump to *jump.
template <int K, bool PS>
__device__ __forceinline__ void walk_warp(const WarpArgs& a, uint8_t* g, const Prob& p,
                          int lane, const int* lidx, const int* upi,
                          const uint8_t* parr, const uint8_t* sarr, int jP,
                          int sRows, int8_t* ops_s, int* jump) {
  constexpr int PW = 2 * K + 4;
  const int D = a.D, TP1 = D + K, TS1 = D + K + 3, UP = D + 3 * K + 4;
  const int L = a.L;
  const Layout lay = og_layout(K, D, L, a.tables_smem, a.planes_smem, a.R);
  const int dqt = p.qlen - p.tlen;
  const int tLow = max(0, p.tlen - p.diag - p.kband - 2);
  Walker w{p.qlen, p.tlen, 0, 0, 0};
  if (PS) {
    if (lane == 0) {
      while (w.step < L) {
        int row, cell;
        walk_cell(w, K, tLow, dqt, TP1, TS1, jP, sRows, row, cell);
        const int8_t* pl = (const int8_t*)(w.phase == 0 ? sarr : parr);
        const int at = row * PW + cell;
        // with the cell's arrow, the same cell's in the 3 rows below: a
        // run of DIAG keeps the cell and takes those rows (where the row
        // is not clamped and i, j and the ops row have room)
        const int urow = w.phase == 0 ? w.j - tLow : w.j;
        const int room =
            row >= 0 && urow == row ? min(min(row, w.i), L - 1 - w.step) : 0;
        const int ar = row >= 0 ? pl[at] : -1;
        const int a1 = pl[room >= 1 ? at - PW : 0];
        const int a2 = pl[room >= 2 ? at - 2 * PW : 0];
        const int a3 = pl[room >= 3 ? at - 3 * PW : 0];
        if (ar == DIAG && w.i >= 0 && w.j >= 0) {
          const int n =
              1 + (room >= 1 && a1 == DIAG) *
                      (1 + (room >= 2 && a2 == DIAG) *
                               (1 + (room >= 3 && a3 == DIAG)));
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < n) ops_s[w.step + k] = DIAG;
          w.step += n;
          w.i -= n;
          w.j -= n;
          continue;
        }
        if (!walk_step(w, ar, lidx, upi, K, TP1, UP, ops_s)) break;
      }
      *jump = w.jump;
    }
    return;
  }
  // device planes: chunks of R rows, the next lower one in flight
  const int R = a.R, BUF = a16(R * PW + 32);
  uint8_t* buf = g + lay.stage;
  int cph = -1, lo = 0, hi = -1, base = 0, cur = 0;  // the staged chunk
  int nph = -1, nlo = 0, nhi = -1, nbase = 0;          // the one in flight
  bool active = true;
  while (active) {
    int row, cell;
    walk_cell(w, K, tLow, dqt, TP1, TS1, jP, sRows, row, cell);
    row = __shfl_sync(FULL, row, 0);
    const int ph = __shfl_sync(FULL, w.phase, 0);
    if (row >= 0 && !(ph == cph && row >= lo && row <= hi)) {
      if (ph == nph && row >= nlo && row <= nhi) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        cur ^= 1;
        cph = nph, lo = nlo, hi = nhi, base = nbase;
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncwarp();
        const uint8_t* pl = ph == 0 ? sarr : parr;
        cph = ph, hi = row, lo = max(0, row - R + 1);
        base = stage_span(buf + cur * BUF, pl, lo, hi, PW, lane);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();
      nph = -1;
      if (lo > 0) {  // the next lower chunk of the same plane
        const uint8_t* pl = cph == 0 ? sarr : parr;
        nph = cph, nhi = lo - 1, nlo = max(0, lo - R);
        nbase = stage_span(buf + (cur ^ 1) * BUF, pl, nlo, nhi, PW, lane);
      }
    }
    if (lane == 0) {
      const uint8_t* cb = buf + cur * BUF;
      while (w.step < L) {
        int r, c;
        walk_cell(w, K, tLow, dqt, TP1, TS1, jP, sRows, r, c);
        int ar = -1;
        if (r >= 0) {
          if (w.phase != cph || r < lo || r > hi) break;  // leaves the chunk
          ar = (int)(int8_t)cb[r * PW + c - base];
        }
        if (!walk_step(w, ar, lidx, upi, K, TP1, UP, ops_s)) {
          w.step = L + 1;  // done
          break;
        }
      }
    }
    active = __shfl_sync(FULL, w.step < L, 0);
    w.i = __shfl_sync(FULL, w.i, 0);
    w.j = __shfl_sync(FULL, w.j, 0);
    w.phase = __shfl_sync(FULL, w.phase, 0);
    __syncwarp();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (lane == 0) *jump = w.jump;
}

// TS, PS: the tables, the planes in shared memory (the plan's tables_smem,
// planes_smem), fixed per instance so that their accesses compile to
// shared-memory instructions.
template <int K, int CPT, bool TS, bool PS>
__global__ void __launch_bounds__(128)
one_gap_warp_kernel(const WarpArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / a.WPP, role = warp - slot * a.WPP;
  const int b = blockIdx.x * a.PPB + slot;
  if (b >= a.B) return;  // whole problems: WPP > 1 only with PPB = 1
  const int D = a.D, L = a.L;
  const int HP = D + K, HS = D + K + 4, TP1 = D + K, TSs = D + K + 2;
  const int UP = D + 3 * K + 4;
  const Layout lay = og_layout(K, D, L, TS, PS, a.R);
  uint8_t* g = smem + (size_t)slot * lay.group;
  const int gthreads = 32 * a.WPP, gtid = role * 32 + lane;
  Prob p;
  p.qlen = a.qlen[b];
  p.tlen = a.tlen[b];
  p.kband = a.kband[b];
  p.diag = min(p.qlen, p.tlen);
  const int tB1 = min(p.diag + p.kband - 1, p.tlen);
  const int jP = max(0, min(TP1 - 1, tB1));
  const int tLow = max(0, p.tlen - p.diag - p.kband - 2);
  const int sRows = max(0, min(TSs, p.tlen - tLow));

  uint8_t* tab = TS ? g : a.scratch + (size_t)b * lay.table_g;
  float* lmax = (float*)(tab + lay.lmax);
  int* lidx = (int*)(tab + lay.lidx);
  float* up = (float*)(tab + lay.up);
  int* upi = (int*)(tab + lay.upi);
  uint8_t* pl = PS ? g
                   : a.scratch + (size_t)a.B * lay.table_g +
                         (size_t)b * lay.plane_g;
  uint8_t* parr = pl + lay.parr;
  uint8_t* sarr = pl + lay.sarr;
  int8_t* ops_s = (int8_t*)(g + lay.ops);

  // stage the windows as bytes (16-byte loads: HP and HS are multiples
  // of 4, so every row is 16-byte aligned; 8 loads in flight a thread);
  // the tables' initial values; ops -1
  {
    const int n4p = HP / 4, n4s = HS / 4, n4 = 2 * n4p + 2 * n4s;
    const int4* src[4] = {(const int4*)(a.qh + (size_t)b * HP),
                          (const int4*)(a.th + (size_t)b * HP),
                          (const int4*)(a.qt + (size_t)b * HS),
                          (const int4*)(a.tt + (size_t)b * HS)};
    const int dst[4] = {lay.qh, lay.th, lay.qt, lay.tt};
    for (int x0 = gtid; x0 < n4; x0 += 8 * gthreads) {
      int4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int x = x0 + u * gthreads;
        const int k = x < n4p ? 0 : (x < 2 * n4p ? 1 : (x < 2 * n4p + n4s
                                                         ? 2 : 3));
        const int o = x - (k < 2 ? k * n4p : 2 * n4p + (k - 2) * n4s);
        if (x < n4) v[u] = __ldg(src[k] + o);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int x = x0 + u * gthreads;
        const int k = x < n4p ? 0 : (x < 2 * n4p ? 1 : (x < 2 * n4p + n4s
                                                         ? 2 : 3));
        const int o = x - (k < 2 ? k * n4p : 2 * n4p + (k - 2) * n4s);
        if (x < n4)
          *(unsigned*)(g + dst[k] + 4 * o) =
              (v[u].x & 0xff) | (v[u].y & 0xff) << 8 |
              (v[u].z & 0xff) << 16 | (unsigned)(v[u].w & 0xff) << 24;
      }
    }
    if ((L & 3) == 0) {
      for (int x = gtid; x < L / 4; x += gthreads) ((int*)ops_s)[x] = -1;
    } else {
      for (int x = gtid; x < L; x += gthreads) ops_s[x] = -1;
    }
    for (int x = gtid; x < UP; x += gthreads) {
      up[x] = (x == K && p.qlen <= p.tlen) ? 0.f : NEGF;
      upi[x] = 0;
    }
    for (int x = jP + 1 + gtid; x < TP1; x += gthreads) {
      lmax[x] = NEGF;
      lidx[x] = x + K;
    }
    if (gtid == 0) {
      lmax[0] = p.qlen >= p.tlen ? 0.f : NEGF;
      lidx[0] = 0;
      // the progress words: prefix rows, suffix rows in the ring, suffix
      // rows with their arrows
      ((int*)(g + lay.prog))[0] = 0;
      ((int*)(g + lay.prog))[1] = 0;
      ((int*)(g + lay.prog))[2] = 0;
    }
  }
  if (a.WPP > 1) __syncthreads(); else __syncwarp();

  // roles: WPP = 1, one warp for all; 3, the prefix, the suffix DP and
  // its arrows
  if (role == 0)
    prefix_warp<K, CPT>(a, g, p, lane, lmax, lidx, up, upi, parr, jP);
  if (a.WPP == 1)
    suffix_warp<K, CPT, true>(a, g, p, lane, lmax, up, sarr, sRows,
                              a.score + b);
  if (a.WPP == 3 && role == 1)
    suffix_warp<K, CPT, false>(a, g, p, lane, lmax, up, sarr, sRows,
                               a.score + b);
  if (a.WPP == 3 && role == 2)
    suffix_arrows<K, CPT>(a, g, p, lane, lmax, sarr, sRows, a.score + b);
  // the planes and tables complete and visible to the walking warp (its
  // cp.async copies read device planes from L2)
  if (PS) __threadfence_block(); else __threadfence();
  if (a.WPP > 1) __syncthreads(); else __syncwarp();
  if (role != 0) return;
  walk_warp<K, PS>(a, g, p, lane, lidx, upi, parr, sarr, jP, sRows, ops_s,
               a.jump + b);
  __syncwarp();
  // the ops row out in 4-byte stores
  int8_t* o = a.ops + (size_t)b * L;
  if ((L & 3) == 0) {
    for (int x = lane; x < L / 4; x += 32)
      ((int*)o)[x] = ((const int*)ops_s)[x];
  } else {
    for (int x = lane; x < L; x += 32) o[x] = ops_s[x];
  }
}

// ---------------------------------------------------------- CTA tier ---

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
  extern __shared__ float smem_f[];
  const int LP = 2 * K + 1, LS = 2 * K + 4;
  float* s_prev = smem_f;       // previous row, LS + 1 (NEGF sentinel)
  float* s_x = smem_f + LS + 1; // closure ping
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
      const float ov = __shfl_xor_sync(FULL, bv, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
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

// the CTA tier's device scratch: parr, sarr, lmax, lidx, up, upi (each
// 16-aligned), and its total bytes; ops/one_gap.py:_og_scratch_bytes
// computes the same total
__host__ __device__ inline void cta_scratch(int B, int K, int D,
                                            size_t (&off)[7]) {
  const size_t TP1 = D + K, TS1 = D + K + 3, UP = D + 3 * K + 4;
  const size_t n[6] = {B * TP1 * (2 * K + 1), B * TS1 * (2 * K + 4),
                       4 * B * TP1, 4 * B * TP1, 4 * B * UP, 4 * B * UP};
  off[0] = 0;
  for (int k = 0; k < 6; ++k) off[k + 1] = off[k] + ((n[k] + 15) & ~15ull);
}

// Raise a kernel's dynamic shared memory limit once per device.
template <typename F>
cudaError_t allow_smem(F kern, std::atomic<unsigned long long>& done,
                       int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done.load() >> dev & 1) return cudaSuccess;
  e = cudaFuncSetAttribute((const void*)kern,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           232448);
  if (e == cudaSuccess) done.fetch_or(1ull << dev);
  return e;
}

template <int K, int CPT, bool TS, bool PS>
int launch_warp(const WarpArgs& a, int grid, int threads, int smem,
                cudaStream_t st) {
  static std::atomic<unsigned long long> raised{0};
  auto kern = one_gap_warp_kernel<K, CPT, TS, PS>;
  const cudaError_t e = allow_smem(kern, raised, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* lra_errstr(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// qh, th: int32 [B, D+K]; qt, tt: int32 [B, D+K+4]; qlen, tlen, kband:
// int32 [B]; scratch: device bytes for the planes and tables the plan
// keeps out of shared memory (scratch_bytes of them).  Out: ops int8
// [B, L], jump int32 [B], score f32 [B].  tier (0 warp, 1 CTA), CPT,
// WPP, PPB, threads, smem, tables_smem, planes_smem, R and scratch_bytes
// from ops/one_gap.py:one_gap_plan.
extern "C" int lra_one_gap_traced(
    const void* qh, const void* th, const void* qt, const void* tt,
    const void* qlen, const void* tlen, const void* kband, void* scratch,
    void* ops, void* jump, void* score, int B, int K, int D, int m, int mm,
    int indel, int L, int tier, int CPT, int WPP, int PPB, int threads,
    int smem, int tables_smem, int planes_smem, int R, int scratch_bytes,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B == 0) return 0;
  if (tier == 0) {
    const Layout lay = og_layout(K, D, L, tables_smem, planes_smem, R);
    const size_t need = (size_t)B * (lay.table_g + lay.plane_g);
    if (!((K == 16 && CPT == 2) || (K == 32 && CPT == 3)) ||
        !(WPP == 1 || WPP == 3) || PPB < 1 || (WPP > 1 && PPB > 1) ||
        threads != 32 * WPP * PPB || smem < PPB * lay.group ||
        (planes_smem && !tables_smem) ||
        smem > 232448 || (size_t)scratch_bytes < need ||
        (!planes_smem && R < 1))
      return (int)cudaErrorInvalidValue;
    WarpArgs a{(const int*)qh, (const int*)th, (const int*)qt,
               (const int*)tt, (const int*)qlen, (const int*)tlen,
               (const int*)kband, (uint8_t*)scratch, (int8_t*)ops,
               (int*)jump, (float*)score, B, D, L, WPP, PPB, tables_smem,
               planes_smem, R, (float)m, (float)mm, (float)indel};
    const int grid = (B + PPB - 1) / PPB;
#define LRA_K6_WARP(KK, C)                                                  \
  return tables_smem ? (planes_smem                                         \
                            ? launch_warp<KK, C, true, true>(a, grid,       \
                                                             threads, smem, \
                                                             st)            \
                            : launch_warp<KK, C, true, false>(a, grid,      \
                                                              threads,      \
                                                              smem, st))    \
                     : launch_warp<KK, C, false, false>(a, grid, threads,   \
                                                        smem, st)
    if (K == 16) LRA_K6_WARP(16, 2);
    LRA_K6_WARP(32, 3);
#undef LRA_K6_WARP
  }
  const int LS = 2 * K + 4;
  size_t off[7];
  cta_scratch(B, K, D, off);
  if (tier != 1 || !(CPT == 1 || CPT == 2 || CPT == 4) ||
      threads != ((LS + CPT - 1) / CPT + 31) / 32 * 32 || threads > 1024 ||
      smem != (3 * LS + 1) * (int)sizeof(float) ||
      (size_t)scratch_bytes < off[6])
    return (int)cudaErrorInvalidValue;
  uint8_t* sc = (uint8_t*)scratch;
#define LRA_K6_CTA(C)                                                        \
  one_gap_kernel<C><<<B, threads, smem, st>>>(                               \
      (const int*)qh, (const int*)th, (const int*)qt, (const int*)tt,        \
      (const int*)qlen, (const int*)tlen, (const int*)kband, K, D, (float)m, \
      (float)mm, (float)indel, L, (int8_t*)(sc + off[0]),                    \
      (int8_t*)(sc + off[1]), (float*)(sc + off[2]), (int*)(sc + off[3]),    \
      (float*)(sc + off[4]), (int*)(sc + off[5]), (int8_t*)ops, (int*)jump,  \
      (float*)score)
  if (CPT == 1) LRA_K6_CTA(1);
  else if (CPT == 2) LRA_K6_CTA(2);
  else LRA_K6_CTA(4);
#undef LRA_K6_CTA
  return (int)cudaGetLastError();
}
