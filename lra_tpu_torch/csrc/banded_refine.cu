// Indel-refine DP with lane-aware device traceback, 2-bit packed ops:
// banded_refine_traced_packed (K5).
//
// Replaces lra_tpu/ops/affine_kernel.py:_refine_arrows (:371, the
// forward rows) and :_traceback_refine_device (:487, the walk), jitted
// together as banded_refine_traced_packed (:546).  The reference's
// IndelRefine matrix: linear single-step gaps (cost indel) plus affine
// del/ins lanes with open 2*indel+1 and extend 0.  Per row j, band cell d
// (cell i = j + d - K):
//   D    = max(S[j-1][d+1] + open, D[j-1][d+1])       (del lane)
//   base = max(S[j-1][d] + sub, S[j-1][d+1] + indel, D)
//   S    = max(leftclosure(base)[d], prefixmax(base)[d-1] + open)
// with the i=0 column a rail for j >= 1.  Each plane byte holds the tie
// flags the main arrow is read from (tie order match > ins > del >
// delClose > insClose), the del-open and ins-open flags and a valid bit
// (plane_flags).  Output: the packed op plane of
// banded_global_traced_packed.
//
// Bound: operations.  chip_smoke.py's dp_bound counts 18 per band cell
// of the rows the data needs.  The kernel's row at CPT 9 is about 470
// warp instructions for 288 cells (cuobjdump -sass): half of them
// compares, maxima and selects on the half-rate ALU pipe, half adds and
// FMAs, so a full card is bound by instruction issue; the plane's int8
// writes and the walk's reads (288 B each per row at K=128) are the
// memory floor.  A bucket of few problems is bound by the latency of its
// longest problem's rows and walk.
//
// Design (ops/affine_kernel.py:refine_plan chooses the tier):
// - A problem's band row lives in WP warps; lane l of warp w owns the CPT
//   contiguous cells d = (32w + l) * CPT + c.  Tiers: CPT 2 (K < 32),
//   5 (K < 80), 9 with WP 1 (K < 144) and 9 with WP = ceil(band / 288)
//   beyond (2 at K=256, 4 at K=512, up to 8 at K=1023).  A block holds
//   PPC = 8 / WP problems when the bucket gives every SM a block of 8
//   warps, else one, so that a small bucket spreads over all SMs.
//   Persistent grid: one block per SM slot, each group of WP warps
//   taking the next problem from an atomic counter.
// - Row j-1's S[d+1] and D[d+1] come by __shfl_down_sync; the linear
//   closure and the plain prefix max are a thread-local pass and a
//   5-step warp scan, both arrays interleaved; row j's left neighbour of
//   a lane's first cell comes by __shfl_up_sync.  At WP = 1 a row needs
//   no barrier at all.
// - At WP > 1, one named barrier (bar.sync 1 + group, 32 * WP) per row:
//   before it each warp publishes, in a slot indexed by row parity, its
//   two scan aggregates, the plain prefix max over its cells but the last,
//   whether its last cell is valid, and its first cell's x0, D and
//   validity.  After it a warp rebuilds from them its first cell's left
//   neighbour S (warp w-1's last cell, max(L0, I) masked) and its last
//   cell's right neighbour S and D for the next row (warp w+1's first
//   cell), each by the same operations on the same operands as the warp
//   that owns the cell.
// - The plane is a global scratch [B, T+1, P] with pitch P = 32 * CPT *
//   WP bytes, laid out lane-major inside each warp's 32 * CPT bytes:
//   cell c of lane l at byte 32c + l, so each of a warp's CPT byte stores
//   per row fills one whole 32-byte sector.
// - After its rows, warp 0 of the group walks back (walk_back): chunks of
//   R plane rows go to shared memory with 16-byte cp.async copies, the
//   next chunk in flight while lane 0 walks the current one with the
//   reference's lane-aware state machine, step for step; packed bytes go
//   out as lane 0 completes them, zeros after the end by the whole warp.
//   R is 16 in a bucket that fills the card (other warps' rows hide the
//   loads) and up to 64 rows (32 KB) with one problem per block, where
//   the walk of the longest problem bounds the launch and has to run a
//   chunk ahead of the plane's reads from device memory.
//
// Exactness (the plain twin is bit-exact against lra_tpu; this kernel
// against the twin):
// - Every value is a small integer or NEGF = -1e30 in f32: sums are exact
//   and maxima order-free, so any scan order gives the same bits; no
//   fast-math.
// - The linear closure is indel*d + prefixmax_e<=d(base[e] - indel*e),
//   equal to the twin's log-step doubling (both are max_e base[e] +
//   indel*(d - e)); NEGF + |indel * band| rounds back to NEGF.
// - The plain prefix max feeds I = prefixmax(base)[d-1] + open with NEGF
//   before cell 0 (the twin's NEGF shift-in: I at d = 0 is NEGF + open =
//   NEGF, so the ins-open flag there compares NEGF with NEGF).
// - Pad cells d >= band are invalid: their base, S and D are NEGF.  They
//   trail the band, so they enter no valid cell's prefix; and the right
//   neighbour of cell band-1 is a pad whose S and D are NEGF, as the
//   twin's NEGF shift-in gives.  The lane after the last (lane 31 of the
//   last warp) reads NEGF: 32 * CPT * WP is even and band odd, so that
//   cell is always a pad.
// - One tie order, in one place (the walk's decode of the plane flags):
//   match > ins > del > delClose > insClose; D's open before extend; I's
//   open compared against the left neighbour's S + open.  The forward
//   rows store each comparison, not the arrow, which moves the arrow's
//   selects off the half-rate ALU pipe onto the path the walk takes.
//
// ptxas (sm_90a, chip_smoke.py logs it): 128 registers at CPT 9 (the
// __launch_bounds__(256, 2) cap; a 4-byte spill outside the row loop)
// and at CPT 9 with WP > 1, 92 at CPT 5, 56 at CPT 2; dynamic shared
// memory only, PPC * (2 * R * P + 16) bytes, plus 64 * WP per problem at
// WP > 1 (at most 74,256 B).

#include "banded_common.cuh"

namespace {

using namespace lra;

constexpr int REF_DELC = 4, REF_INSC = 5;
// plane byte bits (plane_flags)
constexpr int MATCH_BIT = 1, INS_BIT = 2, DEL_BIT = 4, DELC_BIT = 8;
constexpr int DEL_OPEN_BIT = 16, INS_OPEN_BIT = 32, VALID_BIT = 64;
constexpr int DONE_BIT = 128;

__device__ __forceinline__ int lds_u8(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return (int)v;
}

// The main arrow of a plane byte (plane_flags): the first of its match,
// ins, del and delClose flags, insClose if none; nibble f of the table is
// the arrow of the flag bits f (DIAG 3 for odd f, LEFT 1, DOWN 2,
// delClose 4, insClose 5 at f = 0).
__device__ __forceinline__ int arrow_of(int p) {
  constexpr unsigned long long TAB = 0x3132313431323135ull;
  return (int)((TAB >> ((p & 15) << 2)) & 7);
}

// A valid cell whose main arrow is DIAG (its match flag set), not DONE.
__device__ __forceinline__ bool is_match(int p) {
  return (p & (VALID_BIT | MATCH_BIT | DONE_BIT)) == (VALID_BIT | MATCH_BIT);
}

// Byte of band cell d in a plane row: warp segment, then lane-major.
template <int CPT, bool MULTI>
__device__ __forceinline__ int plane_byte(int d) {
  constexpr int SEG = 32 * CPT;
  const int w = MULTI ? d / SEG : 0, r = d - w * SEG;
  const int l = r / CPT, c = r - l * CPT;
  return w * SEG + c * 32 + l;
}

// The lane-aware traceback (lra_tpu _traceback_refine_device) by one
// warp: lane 0 walks from (qlen, tlen) over chunks of R plane rows in
// shared memory (buf: 2 * R * P bytes) while the warp stages the next
// chunk; ops packed 2 bits each into o[0, L/4), zero after the end.  The
// walk only moves to rows j' <= j, so the chunk under its row is all it
// needs, and it enters each chunk at the chunk's top row.
//
// One step, as the reference's state machine: in lane DEL or INS, or in
// MAIN on a delClose / insClose arrow, the step is DOWN / LEFT and the
// lane stays open unless the cell's open flag closes it; in MAIN a
// DIAG / LEFT / DOWN arrow is the step; a rail (a cell without the valid
// bit, or outside the band or the matrix) or DONE ends the walk.  The
// walker keeps the band cell d and its byte, computes the bytes of d - 1
// and d + 1 while the shared-memory load is in flight, and decodes a
// step without branches (arrow_of; delClose 4 and insClose 5 map to
// DOWN 2 and LEFT 1 as 6 - x; the lanes DEL 1 and INS 2 as x - 3).  A
// run of matches takes up to 4 DIAG steps a turn: the cell's bytes in
// the next 3 rows are loaded with its own.
template <int CPT, bool MULTI>
__device__ __forceinline__ void walk_back(const int8_t* pl, uint8_t* buf,
                                          uint8_t* o, int ql, int tl, int T,
                                          int K, int band, int P, int R,
                                          int L, int lane) {
  constexpr int MAIN = 0, DEL = 1, INS = 2;
  int j = tl, d = ql - tl + K, ln = MAIN, s = 0;
  int off = plane_byte<CPT, MULTI>(d);
  unsigned byte = 0;
  bool active = true;
  int lo = max(0, min(tl, T) - R + 1);
  int cur = 0;
  stage_rows(buf, pl, lo, min(tl, T) - lo + 1, P, lane);
  for (;;) {
    const int nlo = max(0, lo - R);
    if (lo > 0)
      stage_rows(buf + (cur ^ 1) * R * P, pl, nlo, lo - nlo, P, lane);
    if (lo > 0) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      const unsigned rows =
          (unsigned)__cvta_generic_to_shared(buf + cur * R * P);
      while (s < L) {
        const bool ok = j >= 0 && j + d >= K && (unsigned)d < (unsigned)band;
        const int row = min(j, T);
        if (ok && row < lo) break;  // the walk enters the next chunk
        // an unconditional load (of byte 0 off the band), then the mask;
        // with it the cell's bytes in the 3 rows below (clamped to the
        // chunk), for a run of matches down the diagonal
        const unsigned at = rows + (ok ? (row - lo) * P + off : 0);
        const int below = ok ? min(row - lo, 3) : 0;
        int p = lds_u8(at);
        const int p1 = lds_u8(at - (below >= 1 ? P : 0));
        const int p2 = lds_u8(at - (below >= 2 ? 2 * P : 0));
        const int p3 = lds_u8(at - (below >= 3 ? 3 * P : 0));
        if (!ok) p = 0;
        if (ln == MAIN && j <= T && is_match(p)) {
          // MAIN lane on match arrows: DIAG steps down the diagonal, d
          // and its byte unchanged, as long as the rows below are in
          // the chunk and match too
          const int room = min(below, L - s - 1);
          const int n = 1 + (room >= 1 && is_match(p1)) *
                            (1 + (room >= 2 && is_match(p2)) *
                                 (1 + (room >= 3 && is_match(p3))));
          j -= n;
          for (int k = 0; k < n; ++k, ++s) {
            byte |= (unsigned)DIAG << (2 * (s & 3));
            if ((s & 3) == 3) {
              o[s >> 2] = (uint8_t)byte;
              byte = 0;
            }
          }
          continue;
        }
        const int offL = plane_byte<CPT, MULTI>(d - 1);
        const int offR = plane_byte<CPT, MULTI>(d + 1);
        if (!(p & VALID_BIT) || (ln == MAIN && (p & DONE_BIT))) {
          active = false;
          break;
        }
        // x: the arrow in MAIN, delClose in DEL, insClose in INS
        const int x = ln == MAIN ? arrow_of(p) : ln + 3;
        const int a = x < REF_DELC ? x : 6 - x;  // delClose 4 DOWN, 5 LEFT
        const bool closes = p & (x == REF_DELC ? DEL_OPEN_BIT : INS_OPEN_BIT);
        ln = x < REF_DELC || closes ? MAIN : x - 3;
        j -= a != LEFT;
        d += (a == DOWN) - (a == LEFT);
        off = a == DOWN ? offR : (a == LEFT ? offL : off);
        byte |= (unsigned)a << (2 * (s & 3));
        if ((s & 3) == 3) {
          o[s >> 2] = (uint8_t)byte;
          byte = 0;
        }
        ++s;
      }
    }
    const bool more = __shfl_sync(FULL, active && s < L, 0);
    if (!more || lo == 0) break;
    __syncwarp();  // lane 0 is done with buf[cur] before it is restaged
    lo = nlo;
    cur ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // the byte the walk ended in, then zeros to L/4
  if (lane == 0 && (s & 3)) o[s >> 2] = (uint8_t)byte;
  const int zs = __shfl_sync(FULL, (s + 3) >> 2, 0);
  for (int k = zs + lane; k < L / 4; k += 32) o[k] = 0;
  __syncwarp();
}

// What a warp of a WP > 1 group publishes each row (slot of row parity).
struct Xch {
  float agg0, agg1;  // max over the warp's cells of x0, of base
  float pmx;         // max of base over the warp's cells but the last
  float x0f, dnf;    // first cell: x0, D before masking
  int vlast, vf;     // last cell valid, first cell valid
  int pad;           // 32 bytes: the next group's buffer stays aligned
};

// The plane byte of a cell, as the walk decodes it: bit 0 S == S[j-1][d]
// + sub (match), bit 1 S == Sl + indel (ins), bit 2 S == S[j-1][d+1] +
// indel (del), bit 3 S == D (delClose); the main arrow is the first of
// them in that order, insClose if none (the reference's tie order);
// bit 4 D's open won (del-open), bit 5 I == Sl + open (ins-open), bit 6
// the cell is valid; bit 7 marks DONE (row 0 only).  Sl: the row's S one
// cell left.  The byte is built in f32 on the FMA pipe: 2^23 plus each
// flag times its bit is exact, and its low byte is the flags.
__device__ __forceinline__ int8_t plane_flags(float Sv, float Sl, float I,
                                              float sMat, float delLin,
                                              float Dn, float dop,
                                              bool valid, float indel,
                                              float open) {
  float acc = valid ? 8388672.f : 8388608.f;  // 2^23 (+ 64: valid)
  acc += (float)(Sv == sMat);
  acc = fmaf((float)(Sv == Sl + indel), 2.f, acc);
  acc = fmaf((float)(Sv == delLin), 4.f, acc);
  acc = fmaf((float)(Sv == Dn), 8.f, acc);
  acc = fmaf(dop, 16.f, acc);
  acc = fmaf((float)(I == Sl + open), 32.f, acc);
  return (int8_t)(__float_as_uint(acc) & 0xffu);
}

template <int CPT, bool MULTI>
__global__ void __launch_bounds__(256, 2)
banded_refine_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ t,
                     const int* __restrict__ qlen,
                     const int* __restrict__ tlen,
                     const int* __restrict__ kband,
                     int8_t* __restrict__ planes, uint8_t* __restrict__ out,
                     int* __restrict__ counter, int B, int Q, int T, int K,
                     float m, float mm, float indel, int WP, int PPC, int P,
                     int R, int walk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp / WP;
  const int wig = warp - g * WP;
  const int gbytes = 2 * R * P + (MULTI ? 2 * WP * (int)sizeof(Xch) : 0) + 16;
  uint8_t* buf = smem + g * gbytes;
  Xch* xch = (Xch*)(buf + 2 * R * P);
  int* slot = (int*)(buf + gbytes - 16);
  const int band = 2 * K + 1;
  const int L = Q + T;
  const float open = 2.f * indel + 1.f;
  const int d0 = (wig * 32 + lane) * CPT;
  float indd[CPT];  // indel * d, exact
#pragma unroll
  for (int c = 0; c < CPT; ++c) indd[c] = indel * (float)(d0 + c);

  for (;;) {
    int b;
    if (MULTI) {
      if (wig == 0 && lane == 0) *slot = atomicAdd(counter, 1);
      group_sync(g + 1, 32 * WP);
      b = *slot;
      group_sync(g + 1, 32 * WP);
    } else {
      b = __shfl_sync(FULL, lane == 0 ? atomicAdd(counter, 1) : 0, 0);
    }
    if (b >= B) break;

    const int8_t* qb = q + (size_t)b * Q;
    const int8_t* tb = t + (size_t)b * T;
    const int ql = qlen[b], tl = tlen[b], kb = kband[b];
    int8_t* pl = planes + (size_t)b * (T + 1) * P;
    int8_t* pcell = pl + wig * 32 * CPT + lane;  // cell c at + 32c

    // row 0: S[i, 0] = indel * i for 0 <= i <= min(kband, qlen); D = NEGF
    float S[CPT], D[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int offs = d0 + c - K;
      const bool ok = offs >= -kb && offs <= kb && offs <= ql;
      S[c] = (offs >= 0 && ok) ? indel * (float)offs : NEGF;
      D[c] = NEGF;
      pcell[32 * c] = !ok || offs < 0 ? (int8_t)0
                      : (int8_t)(offs > 0 ? VALID_BIT | INS_BIT
                                          : VALID_BIT | DONE_BIT);
    }
    // row j-1's S and D right of the warp's last cell (lane 31 reads them)
    float Srn = NEGF, Drn = NEGF;
    if (MULTI && wig + 1 < WP) {
      const int offs = (wig + 1) * 32 * CPT - K;
      const bool ok = offs >= -kb && offs <= kb && offs <= ql;
      Srn = (offs >= 0 && ok) ? indel * (float)offs : NEGF;
    }
    // q codes of the lane's cells at row 1: q[d - K]
    int qc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int qi = d0 + c - K;
      qc[c] = (qi >= 0 && qi < Q) ? (int)__ldg(qb + qi) : QPAD;
    }

    const int jmax = min(tl, T);
    int tj_next = jmax >= 1 ? (int)__ldg(tb) : 0;
    for (int j = 1; j <= jmax; ++j) {
      const int tj = tj_next;
      if (j < jmax) tj_next = __ldg(tb + j);
      const int qin = j + d0 + CPT - 1 - K;  // last cell's q at row j + 1
      const int qn = (qin >= 0 && qin < Q) ? (int)__ldg(qb + qin) : QPAD;
      // valid cells of row j: lo <= d <= hi (i >= 1, i <= qlen, |offs| <= kb)
      const int lo_rel = max(K - kb, K + 1 - j) - d0;
      const int hi_rel = min(K + kb, ql - j + K) - d0;

      float s_n = __shfl_down_sync(FULL, S[0], 1);
      float d_n = __shfl_down_sync(FULL, D[0], 1);
      if (lane == 31) {
        s_n = Srn;
        d_n = Drn;
      }
      float sMat[CPT], delLin[CPT], Dn[CPT], inc0[CPT], exc1[CPT];
      unsigned vmask = 0;
      float run0 = -INFINITY, run1 = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float s1 = c + 1 < CPT ? S[c + 1] : s_n;
        const float d1 = c + 1 < CPT ? D[c + 1] : d_n;
        const float sub = qc[c] == tj ? m : mm;
        sMat[c] = S[c] + sub;
        const float t1 = s1 + open;
        Dn[c] = fmaxf(t1, d1);
        delLin[c] = s1 + indel;
        float base = fmaxf(fmaxf(sMat[c], delLin[c]), Dn[c]);
        const bool v = c >= lo_rel && c <= hi_rel;
        vmask |= (v ? 1u : 0u) << c;
        if (!v) base = NEGF;
        run0 = fmaxf(run0, base - indd[c]);  // linear closure
        inc0[c] = run0;
        exc1[c] = run1;                      // plain prefix max
        run1 = fmaxf(run1, base);
      }
      // warp-inclusive scans of the lane totals, both arrays interleaved
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        run0 = fmaxf(run0, __shfl_up_sync(FULL, run0, o));
        run1 = fmaxf(run1, __shfl_up_sync(FULL, run1, o));
      }
      float ex0 = __shfl_up_sync(FULL, run0, 1);
      float ex1 = __shfl_up_sync(FULL, run1, 1);
      if (lane == 0) {
        ex0 = -INFINITY;
        ex1 = NEGF;  // prefixmax(base)[-1]: the twin's NEGF shift-in
      }
      float sl_first = NEGF;
      if (MULTI) {
        Xch* X = xch + (j & 1) * WP;
        if (lane == 31) {
          X[wig].agg0 = run0;
          X[wig].agg1 = run1;
          X[wig].pmx = fmaxf(ex1, exc1[CPT - 1]);
          X[wig].vlast = (vmask >> (CPT - 1)) & 1;
        }
        if (lane == 0) {
          X[wig].x0f = inc0[0];
          X[wig].dnf = Dn[0];
          X[wig].vf = vmask & 1;
        }
        group_sync(g + 1, 32 * WP);
        float pre0 = -INFINITY, pre1 = NEGF, pre1m = NEGF;
        for (int w = 0; w < wig; ++w) {
          pre1m = pre1;
          pre0 = fmaxf(pre0, X[w].agg0);
          pre1 = fmaxf(pre1, X[w].agg1);
        }
        ex0 = fmaxf(ex0, pre0);
        ex1 = fmaxf(ex1, pre1);
        if (wig > 0) {  // S of warp wig-1's last cell, as that warp has it
          const Xch& Y = X[wig - 1];
          const float L0 = pre0 + indel * (float)(wig * 32 * CPT - 1);
          sl_first = Y.vlast ? fmaxf(L0, fmaxf(pre1m, Y.pmx) + open) : NEGF;
        }
        if (wig + 1 < WP) {  // warp wig+1's first cell, for row j + 1
          const Xch& Y = X[wig + 1];
          const float p0 = fmaxf(pre0, X[wig].agg0);
          const float p1 = fmaxf(pre1, X[wig].agg1);
          const float L0 = fmaxf(Y.x0f, p0) +
                           indel * (float)((wig + 1) * 32 * CPT);
          Srn = Y.vf ? fmaxf(L0, p1 + open) : NEGF;
          Drn = Y.vf ? Y.dnf : NEGF;
        }
      }
      // S and D of row j; the plane bytes of cells 1.. as S fills in (cell
      // c's left neighbour is the new S[c-1], its right one in row j-1 the
      // old S[c+1]), then cell 0's after the shuffle
      int8_t* prow = pcell + (size_t)j * P;
      float I0 = NEGF, dop0 = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const bool v = (vmask >> c) & 1;
        const float L0 = fmaxf(inc0[c], ex0) + indd[c];
        const float I = fmaxf(exc1[c], ex1) + open;
        const float s1 = c + 1 < CPT ? S[c + 1] : s_n;
        const float dop = (float)(Dn[c] == s1 + open);  // D's open won
        S[c] = v ? fmaxf(L0, I) : NEGF;
        D[c] = v ? Dn[c] : NEGF;
        if (c == 0) {
          I0 = I;
          dop0 = dop;
        } else {
          prow[32 * c] = plane_flags(S[c], S[c - 1], I, sMat[c], delLin[c],
                                     Dn[c], dop, v, indel, open);
        }
      }
      float sl = __shfl_up_sync(FULL, S[CPT - 1], 1);
      if (lane == 0) sl = sl_first;
      prow[0] = plane_flags(S[0], sl, I0, sMat[0], delLin[0], Dn[0], dop0,
                            vmask & 1, indel, open);
#pragma unroll
      for (int c = 0; c + 1 < CPT; ++c) qc[c] = qc[c + 1];
      qc[CPT - 1] = qn;
    }
    // the plane's global writes before the walking warp's cp.async reads
    if (MULTI) group_sync(g + 1, 32 * WP);
    else __syncwarp();
    if (walk && wig == 0)
      walk_back<CPT, MULTI>(pl, buf, out + (size_t)b * (L / 4), ql, tl, T,
                            K, band, P, R, L, lane);
  }
}

template <int CPT, bool MULTI>
int launch(const void* q, const void* t, const void* qlen, const void* tlen,
           const void* kband, void* planes, void* out, void* counter, int B,
           int Q, int T, int K, int m, int mm, int indel, int WP, int PPC,
           int P, int R, int smem, int walk, cudaStream_t stream) {
  auto kern = banded_refine_kernel<CPT, MULTI>;
  const int threads = 32 * WP * PPC;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // persistent grid: the blocks that fit on the card at once, at most one
  // per PPC problems
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = min((B + PPC - 1) / PPC, per_sm * sms);
  e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)t, (const int*)qlen, (const int*)tlen,
      (const int*)kband, (int8_t*)planes, (uint8_t*)out, (int*)counter, B, Q,
      T, K, (float)m, (float)mm, (float)indel, WP, PPC, P, R, walk);
  return (int)cudaGetLastError();
}

}  // namespace

// q, t: int8 [B, Q], [B, T]; qlen, tlen, kband: int32 [B]; planes: int8
// scratch [B, T+1, P]; out: uint8 [B, (Q+T)/4]; counter: one int32 of
// scratch.  CPT, WP, PPC, P, R and smem from
// ops/affine_kernel.py:refine_plan; walk = 0 skips the traceback (a
// timing of the forward rows alone; out is then not written).
extern "C" int lra_banded_refine_traced_packed(
    const void* q, const void* t, const void* qlen, const void* tlen,
    const void* kband, void* planes, void* out, void* counter, int B, int Q,
    int T, int K, int m, int mm, int indel, int CPT, int WP, int PPC, int P,
    int R, int smem, int walk, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B == 0) return 0;
  if (2 * K + 1 > 32 * CPT * WP || P != 32 * CPT * WP || PPC < 1 ||
      WP * PPC > 8)
    return (int)cudaErrorInvalidValue;
#define LRA_K5_LAUNCH(C, MULTI)                                              \
  return launch<C, MULTI>(q, t, qlen, tlen, kband, planes, out, counter, B, \
                          Q, T, K, m, mm, indel, WP, PPC, P, R, smem, walk, \
                          st)
  if (WP == 1 && CPT == 2) LRA_K5_LAUNCH(2, false);
  if (WP == 1 && CPT == 5) LRA_K5_LAUNCH(5, false);
  if (WP == 1 && CPT == 9) LRA_K5_LAUNCH(9, false);
  if (WP > 1 && CPT == 9) LRA_K5_LAUNCH(9, true);
#undef LRA_K5_LAUNCH
  return (int)cudaErrorInvalidValue;
}
