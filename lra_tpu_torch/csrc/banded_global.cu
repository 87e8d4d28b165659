// Banded global alignment with device traceback, 2-bit packed ops:
// banded_global_traced_packed (K4); and the same forward rows with a
// row-synchronous traceback: banded_pallas_rowsync (P1, rowsync_kernel,
// below).
//
// Replaces lra_tpu/ops/affine_kernel.py:banded_global_traced_packed
// (:206), _banded_arrows (the forward rows) and _traceback_ops_device
// (the walk) jitted together.  The linear-gap banded DP: per row j, band
// cell d (cell i = j + d - K):
//   base = max(S[j-1][d] + sub, S[j-1][d+1] + indel), indel * j at i = 0
//   S    = max_{e <= d} base[e] + indel * (d - e)      (LEFT chains)
// with the arrow's tie order LEFT > DOWN > DIAG compared on S, DOWN on
// the i = 0 rail, and row 0 LEFT for 0 < offs <= kband (DONE at offs 0,
// qlen not checked).  Output: per problem the ops walking back from
// (qlen, tlen), one per step, packed 4 to a byte (LEFT/DOWN/DIAG =
// 1/2/3, 0 after the end).
//
// Bound: every K4 launch on chip_smoke.py's paths is K=30 (band 61), most
// of them buckets of thousands of problems of 1-33 rows (the main path's:
// B=65536 S=16, 7.4 rows a problem on average).  Such a bucket is bound by
// instruction issue: chip_smoke.py's dp_bound counts 10 operations per
// band cell, and the kernel spends ~120 warp instructions a row at CPT 2
// (the cells, a 5-step shuffle scan, 4 ballots, a 16-byte store), ~70 a
// walk turn and ~150 a problem.  A bucket of few long problems is bound
// by the latency of one warp's rows and walk.  The 2-bit plane is the
// memory floor: 16 B a row at K=30, and none at all in device memory
// while a problem's rows fit in shared memory.
//
// Design (ops/affine_kernel.py:global_plan chooses the tier):
// - A problem's band row lives in WP warps; lane l of warp w owns the CPT
//   contiguous cells d = (32w + l) * CPT + c.  Tiers: CPT 2 (K < 32),
//   5 (K < 80), 9 with WP 1 (K < 144) and 9 with WP = ceil(band / 288)
//   beyond (2 at K=256, 4 at K=512, up to 8 at K=1023).  A block holds
//   PPC = 8 / WP problems when the bucket gives every SM a block of 8
//   warps, else one, so that a small bucket spreads over all SMs.
//   Persistent grid: one block per SM slot, each group of WP warps
//   taking the next problem from an atomic counter, one problem ahead:
//   the index comes back during the current problem's rows and the next
//   problem's lengths and first codes load during its walk.
// - Row j-1's S[d+1] comes by __shfl_down_sync, the left neighbour of a
//   lane's first cell in row j by __shfl_up_sync, and the q codes move
//   one cell left a row by the same shuffle (lane 31 loads its last
//   cell's code).  The closure is indel * d + prefixmax_{e <= d}(base[e]
//   - indel * e): a thread-local pass and a 5-step warp scan.  At WP = 1
//   a row has no barrier at all.
// - At WP > 1, one named barrier (bar.sync 1 + group, 32 * WP) per row:
//   before it each warp publishes, in a slot indexed by row parity, its
//   scan aggregate, its first cell's term and the validity of its first
//   and last cells.  After it a warp rebuilds its first cell's left
//   neighbour S (warp w-1's last cell) and, for the next row, its last
//   cell's right neighbour S (warp w+1's first cell), each by the same
//   operations on the same operands as the warp that owns the cell.
// - The arrow plane holds 2-bit codes (0 stop: DONE or off the valid
//   cells; 1 LEFT, 2 DOWN, 3 DIAG; the walk treats DONE and invalid
//   alike).  Each warp writes a row as 2 * CPT __ballot_sync words, word
//   2c holding bit 0 and word 2c + 1 bit 1 of cell c of every lane (bit
//   l: lane l), padded to 16-byte stores: SEG = 16 * ceil(CPT / 2) bytes
//   a warp, pitch P = SEG * WP (16 B a row at K=30, 80 at K=128; the old
//   int8 plane was 2K+1 bytes).  When all T+1 rows fit in the group's two
//   chunk buffers (T < 2R: the pipeline's K=30 buckets up to S=64) the
//   plane lives there; else in a global scratch [B, T+1, P].
// - After its rows, warp 0 of the group walks back (walk_back): from
//   shared memory, or over chunks of R rows of the global plane staged
//   with 16-byte cp.async copies, the next chunk in flight while lane 0
//   walks the current one.  The reference's step rule (d = i - j + K,
//   row min(j, T), stop off the band); a cell's code is one 8-byte load
//   of its word pair, and a run of DIAG takes up to 4 rows a turn.  The
//   ops gather in a 64-bit register and go out 4 bytes per 16 steps;
//   zeros after the end by the whole warp.
//
// Exactness (the plain twin is bit-exact against lra_tpu; this kernel
// against the twin):
// - Every value is a small integer or NEGF = -1e30 in f32: sums are exact
//   and maxima order-free, so any scan order gives the same bits; no
//   fast-math.  The closure above equals the twin's log-step doubling
//   (both are max_e base[e] + indel * (d - e)); NEGF + |indel * band|
//   rounds back to NEGF.
// - Pad cells d >= band are invalid: their S is NEGF and their code 0.
//   They trail the band, so they enter no valid cell's prefix, and the
//   right neighbour of cell band-1 in row j-1 is a pad (or lane 31 of the
//   last warp's NEGF), as the twin's NEGF shift-in gives.  Cell 0's left
//   neighbour is NEGF, as in the twin.
// - Rows are computed for j <= min(tlen, T); the walk starts at row
//   min(tlen, T) and only moves down, so it reads written rows only.
//
// P1 replaces the repository's one Pallas kernel,
// lra_tpu/ops/affine_pallas.py:_kernel (pl.pallas_call :188, reached from
// banded_pallas_rowsync :225): the same forward rows (band <= 63), then a
// traceback that visits each row once and writes one byte a row, P[b, j]
// = rl << 2 | code (the LEFT run ending at the cell, then 1 DIAG, 2 DOWN,
// 3 stop), into a uint8 [B, SP] plane, SP = ceil((S+1)/128) * 128, zero
// where no row was visited.  rowsync_kernel is this kernel's <CPT 2, WP
// 1> instance with walk_rowsync in place of walk_back, on its own plan
// (ops/affine_pallas.py:rowsync_plan): a problem's whole plane (16 B a
// row) and its staged row of P stay in shared memory while PPC problems
// fit the 227 KB of a block (R = ceil((S+1)/2), so that S + 1 <= 2R),
// PPC lowered before the plan falls back to a device plane walked over
// staged chunks (S > 13669).  Every P1 launch on chip_smoke.py's paths is
// CCS use_pallas's, K=30: B=2048 at S=16 and 32 down to B=8 at S=512.
// The forward rows bound the large buckets as they bound K4's
// (instruction issue, ~120 warp instructions a row); the walk bounds the
// small ones by its latency, one dependent chain a turn: a turn takes a
// run of up to 32 DIAG rows at once (lane k reads the cell's code in row
// j - k, a ballot, a count of trailing ones), and only a row that ends a
// LEFT run, or moves DOWN, takes the 64-bit mask and the count of leading
// zeros.
//
// ptxas (sm_90a, chip_smoke.py logs it): 68 registers at CPT 2, 89 at
// CPT 5, 123 at CPT 9, 127 at CPT 9 with WP > 1 (the __launch_bounds__
// (256, 2) cap), no spills; dynamic shared memory only, PPC * (2 * R * P
// + 16) bytes plus 32 * WP per problem at WP > 1.  rowsync_kernel: 117
// registers, no spills; PPC * (2 * R * 16 + SP + 16) bytes.
//
// K9, banded_global_kernel (arrows_kernel, below), replaces
// lra_tpu/ops/affine_kernel.py:banded_global_kernel (:142, the lax.scan
// of _banded_arrows, :34-139, its rows transposed to [B, T+1, 2K+1]): the
// same forward rows with no walk, every cell's arrow out as int8 (-1 off
// the valid cells; row 0 DONE at d = K, LEFT right of it, -1 left of it
// and outside kband) and score[b] = rows[tlen, b, qlen - tlen + K] read as
// JAX's gather reads it (a negative index wraps once by the axis' size,
// then it is clamped).  It is banded_rows' ARROWS instance: a cell's
// arrow is the 2-bit code K4 derives from the same registers (S, the left
// neighbour's S + indel, sDel), or -1 where the cell is invalid; kband is
// clamped to [-1, K] and qlen to [-1, T + K] first, which leaves every
// band cell's validity as it was and keeps the pad cells d >= band
// invalid.  Rows above min(tlen, T) hold only -1 and run no DP.  Bound:
// the bytes of the arrow plane, B * (T+1) * (2K+1) (68 MB at the mesh
// phase's B=65536 S=16 K=30), beside K4's row instructions.  A group
// stages its problem's plane in shared memory (SP bytes, at the offset of
// its place in the output modulo 16) and writes it with 16-byte stores
// between a byte head and tail, the rows above min(tlen, T) filled with
// -1 on the way; a plane that does not fit (ops/affine_kernel.py:
// arrows_plan) goes out row by row.  Bands past 2047 cells (K > 1023)
// run arrows_cta_kernel: a CTA a problem, a thread a cell, the closure by
// log-doubling steps between block barriers (K9's first design).

#include <mutex>

#include "banded_common.cuh"

namespace {

using namespace lra;

// bytes of one warp's ballot words in a plane row (2 * CPT words, padded
// to whole 16-byte stores)
template <int CPT>
__host__ __device__ constexpr int seg_bytes() {
  return 16 * ((CPT + 1) / 2);
}

__device__ __forceinline__ unsigned long long lds_u64(unsigned addr) {
  unsigned long long v;
  asm volatile("ld.shared.u64 %0, [%1];\n" : "=l"(v) : "r"(addr));
  return v;
}

// 4 bytes of packed ops at p: one store where p is 4-byte aligned
__device__ __forceinline__ void store4(uint8_t* p, unsigned w, bool aligned) {
  if (aligned) {
    *(unsigned*)p = w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = (uint8_t)(w >> (8 * k));
  }
}

// Where band cell d's code lies in a plane row: (byte offset of its word
// pair) << 5 | lane bit.
template <int CPT, bool MULTI>
__device__ __forceinline__ int cell_loc(int d) {
  constexpr int SEGC = 32 * CPT;
  const int w = MULTI ? d / SEGC : 0, r = d - w * SEGC;
  const int l = r / CPT, c = r - l * CPT;
  return ((w * seg_bytes<CPT>() + 8 * c) << 5) | l;
}

// The code at lane bit l of a word pair (bit 0 in the low word).
__device__ __forceinline__ int code_at(unsigned long long v, int l) {
  return (int)((v >> l) & 1ull) | (int)((v >> (l + 31)) & 2ull);
}

// One warp's codes of a plane row (bit 0 and bit 1 of cell c of this
// lane: lo[c], hi[c]) as ballot words, stored by lanes 0 .. SEG/16 - 1,
// 16 bytes each.
template <int CPT>
__device__ __forceinline__ void store_row(uint8_t* dst,
                                          const bool (&lo)[CPT],
                                          const bool (&hi)[CPT], int lane) {
  constexpr int NW = seg_bytes<CPT>() / 4;
  unsigned w[NW];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    w[2 * c] = __ballot_sync(FULL, lo[c]);
    w[2 * c + 1] = __ballot_sync(FULL, hi[c]);
  }
#pragma unroll
  for (int k = 2 * CPT; k < NW; ++k) w[k] = 0;
#pragma unroll
  for (int v = 0; v < NW / 4; ++v)
    if (lane == v)
      *(uint4*)(dst + 16 * v) =
          make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
}

// The traceback (lra_tpu _traceback_ops_device) by one warp: lane 0 walks
// from (qlen, tlen) over chunks of R plane rows in shared memory (buf: 2 *
// R * P bytes) while the warp stages the next chunk; ops packed 2 bits
// each into o[0, L/4), zero after the end.  The walk only moves to rows
// j' <= j, so the chunk under its row is all it needs, and it enters each
// chunk at the chunk's top row.  One step, as the reference: the cell (i,
// j) off the band or the matrix, or a code 0, ends the walk; else the
// code is the op, LEFT i - 1, DOWN j - 1, DIAG both.  The walker keeps the
// band cell d and its place in the row, computes the places of d - 1 and
// d + 1 while the shared-memory load is in flight, and with its own word
// pair loads the pairs of the same cell in the 3 rows below (clamped to
// the chunk), so that a run of DIAG takes up to 4 steps a turn.
template <int CPT, bool MULTI>
__device__ __forceinline__ void walk_back(const uint8_t* pl, uint8_t* buf,
                                          uint8_t* o, int ql, int tl, int T,
                                          int K, int band, int P, int R,
                                          int L, int lane, bool in_smem) {
  int j = tl, d = ql - tl + K, s = 0;
  int loc = cell_loc<CPT, MULTI>(d);
  // the ops of steps from 16 * (s / 16) on, 2 bits each, not yet stored
  unsigned long long acc = 0;
  const bool aligned = ((size_t)o & 3) == 0;
  bool active = true;
  const int top = min(tl, T);
  int lo = in_smem ? 0 : max(0, top - R + 1);
  int cur = 0;
  if (!in_smem) stage_rows(buf, pl, lo, top - lo + 1, P, lane);
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
        // an unconditional load (of the chunk's first pair off the band),
        // then the mask; with it the cell's pairs in the 3 rows below
        const int l = loc & 31;
        const unsigned at = rows + (ok ? (row - lo) * P + (loc >> 5) : 0);
        const int below = ok ? min(row - lo, 3) : 0;
        const unsigned long long v0 = lds_u64(at);
        const unsigned long long v1 = lds_u64(at - (below >= 1 ? P : 0));
        const unsigned long long v2 = lds_u64(at - (below >= 2 ? 2 * P : 0));
        const unsigned long long v3 = lds_u64(at - (below >= 3 ? 3 * P : 0));
        const int locL = cell_loc<CPT, MULTI>(d - 1);
        const int locR = cell_loc<CPT, MULTI>(d + 1);
        const int a = ok ? code_at(v0, l) : 0;
        if (a == 0) {
          active = false;
          break;
        }
        // DIAG steps down the diagonal (d and its place unchanged) while
        // the rows below are in the chunk and hold DIAG too; at j > T the
        // row is clamped and a step stays on row T.  No branch: the loads
        // of the rows below are issued with the cell's own.
        const int room = a == DIAG && j <= T ? min(below, L - s - 1) : 0;
        const int n = 1 + (room >= 1 && code_at(v1, l) == DIAG) *
                              (1 + (room >= 2 && code_at(v2, l) == DIAG) *
                                       (1 + (room >= 3 &&
                                             code_at(v3, l) == DIAG)));
        j -= a == LEFT ? 0 : n;
        d += (a == DOWN) - (a == LEFT);
        loc = a == DOWN ? locR : (a == LEFT ? locL : loc);
        // the n ops (n DIAG, or the one op a) into the accumulator; 16
        // complete steps go out as their 4 bytes
        const unsigned ops = a == DIAG ? (1u << (2 * n)) - 1 : a;
        acc |= (unsigned long long)ops << (2 * (s & 15));
        if ((s & 15) + n >= 16) {
          store4(o + 4 * (s >> 4), (unsigned)acc, aligned);
          acc >>= 32;
        }
        s += n;
      }
    }
    const bool more = __shfl_sync(FULL, active && s < L, 0);
    if (!more || lo == 0) break;
    __syncwarp();  // lane 0 is done with buf[cur] before it is restaged
    lo = nlo;
    cur ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // the bytes of the last, incomplete 16 steps, then zeros to L/4
  if (lane == 0)
    for (int k = 0; k < ((s & 15) + 3) >> 2; ++k)
      o[4 * (s >> 4) + k] = (uint8_t)(acc >> (8 * k));
  const int zs = __shfl_sync(FULL, (s + 3) >> 2, 0);
  for (int k = zs + lane; k < L / 4; k += 32) o[k] = 0;
  __syncwarp();
}

// The 32 bits of x at the even bits of a 64-bit word (bit l to bit 2l).
__device__ __forceinline__ unsigned long long spread_bits(unsigned x) {
  unsigned long long v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  return (v | (v << 1)) & 0x5555555555555555ull;
}

__device__ __forceinline__ uint4 lds_u128(unsigned addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// P1's row-synchronous traceback (lra_tpu/ops/affine_pallas.py:_kernel's
// tb_row) by one warp at CPT 2, every lane on the same (i, j): from j =
// min(tl, T) down to the stop, over the plane's 16-byte rows in shared
// memory (the whole plane, or chunks of R rows staged as in walk_back;
// word 2c / 2c+1 holds bit 0 / 1 of cell 2l + c in bit l).  With d = i -
// j + K (off the band: stop, nothing written), lane k reads the code of
// cell d in row j - k (rows in the chunk); a ballot gives the run of DIAG
// rows from j down, and a turn takes it whole: each such row's byte is 1
// (rl 0, DIAG), i and j move down together and d stays.  Otherwise row
// j alone: its LEFT cells (code 1: bit 0 without bit 1) make one 64-bit
// mask, the even cells' word spread to the even bits and the odd cells'
// to the odd ones (pads and invalid cells hold code 0 and are not LEFT);
// rl is the LEFT run ending at d, from a count of leading zeros (d + 1
// when it reaches cell 0), and the code of cell max(d - rl, 0) gives the
// byte rl << 2 | (1 DIAG, 2 DOWN, 3 otherwise: stop); i -= rl + (DIAG).
// The bytes go to a staged row of P in shared memory (stage: SP bytes,
// zeroed first), which the warp copies to o[0, SP) at the end in 16-byte
// stores, so that every byte of P is written.
__device__ __forceinline__ void walk_rowsync(const uint8_t* pl, uint8_t* buf,
                                             uint8_t* stage, uint8_t* o,
                                             int ql, int tl, int T, int K,
                                             int band, int R, int SP,
                                             int lane, bool in_smem) {
  constexpr int P = 16;
  const int top = min(tl, T);
  int j = top, iv = ql;
  bool active = true;
  for (int v = lane; v < SP / 16; v += 32)
    *(uint4*)(stage + 16 * v) = make_uint4(0, 0, 0, 0);
  int lo = in_smem ? 0 : max(0, top - R + 1);
  int cur = 0;
  if (!in_smem) stage_rows(buf, pl, lo, top - lo + 1, P, lane);
  for (;;) {
    const int nlo = max(0, lo - R);
    if (lo > 0)
      stage_rows(buf + (cur ^ 1) * R * P, pl, nlo, lo - nlo, P, lane);
    if (lo > 0) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    const unsigned rows =
        (unsigned)__cvta_generic_to_shared(buf + cur * R * P);
    while (j >= lo) {
      const int dk = iv - j + K;
      if ((unsigned)dk >= (unsigned)band) {
        active = false;
        break;
      }
      const unsigned at = rows + (j - lo) * P;
      const int below = min(j - lo, 31), l = dk >> 1;
      const bool diag =
          code_at(lds_u64(at - min(lane, below) * P + 8 * (dk & 1)), l) ==
          DIAG;
      const unsigned run = __ballot_sync(FULL, diag) & ((2u << below) - 1);
      const int n = __clz(__brev(~run));  // DIAG rows from j down
      if (n > 0) {
        if (lane < n) stage[j - lane] = 1;
        iv -= n;
        j -= n;
        continue;
      }
      const uint4 w = lds_u128(at);
      const unsigned long long M =
          spread_bits(w.x & ~w.y) | (spread_bits(w.z & ~w.w) << 1);
      const unsigned long long z = ~M & (~0ull >> (63 - dk));
      const int rl = z == 0 ? dk + 1 : dk - (63 - __clzll((long long)z));
      const int d2 = max(dk - rl, 0), l2 = d2 >> 1;
      const unsigned b0 = d2 & 1 ? w.z : w.x, b1 = d2 & 1 ? w.w : w.y;
      const int a2 = (int)((b0 >> l2) & 1u) | (int)(((b1 >> l2) & 1u) << 1);
      const int code = a2 == DIAG ? 1 : (a2 == DOWN ? 2 : 3);
      if (lane == 0) stage[j] = (uint8_t)((rl << 2) | code);
      --j;
      if (code == 3) {
        active = false;
        break;
      }
      iv -= rl + (code == 1);
    }
    if (!active || lo == 0) break;
    __syncwarp();  // the warp is done with buf[cur] before it is restaged
    lo = nlo;
    cur ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  for (int v = lane; v < SP / 16; v += 32)
    *(uint4*)(o + 16 * v) = *(const uint4*)(stage + 16 * v);
  __syncwarp();
}

// What a warp of a WP > 1 group publishes each row (slot of row parity).
struct Xch {
  float agg;    // max over the warp's cells of base - indel * d
  float g0;     // the same term of its first cell
  int vlast;    // its last cell is valid
  int vfirst;   // its first cell is valid
};

// JAX's gather index: a negative index wraps once, then clamps
__device__ __forceinline__ int gather_index(int x, int size) {
  if (x < 0) x += size;
  return x < 0 ? 0 : (x > size - 1 ? size - 1 : x);
}

// 0xff in the bytes of a word from byte `keep` on (all at keep <= 0, none
// at keep >= 4)
__device__ __forceinline__ unsigned ff_from(int keep) {
  return keep <= 0 ? 0xffffffffu : keep >= 4 ? 0u : 0xffffffffu << (8 * keep);
}

// n bytes of an arrow plane to dst by threads t of nt: bytes [0, lim)
// from src (src - dst a multiple of 16; null when lim is 0), bytes [lim,
// n) -1; 16-byte stores between a byte head and tail.
__device__ __forceinline__ void copy_plane(int8_t* dst, const uint8_t* src,
                                           int n, int lim, int t, int nt) {
  const int head = min(n, (int)((16 - ((size_t)dst & 15)) & 15));
  for (int k = t; k < head; k += nt) dst[k] = k < lim ? (int8_t)src[k] : -1;
  const int nv = (n - head) >> 4;
  for (int v = t; v < nv; v += nt) {
    const int o = head + 16 * v, keep = lim - o;
    uint4 x = keep > 0 ? *(const uint4*)(src + o) : make_uint4(0, 0, 0, 0);
    if (keep < 16) {
      x.x |= ff_from(keep);
      x.y |= ff_from(keep - 4);
      x.z |= ff_from(keep - 8);
      x.w |= ff_from(keep - 12);
    }
    *(uint4*)(dst + o) = x;
  }
  for (int k = head + 16 * nv + t; k < n; k += nt)
    dst[k] = k < lim ? (int8_t)src[k] : -1;
}

// The kernels' parameters: one bucket of problems and its launch plan.
#define BANDED_PARAMS                                                      \
  const int8_t *__restrict__ q, const int8_t *__restrict__ t,              \
      const int *__restrict__ qlen, const int *__restrict__ tlen,          \
      const int *__restrict__ kband, uint8_t *__restrict__ planes,         \
      uint8_t *__restrict__ out, int *__restrict__ counter, int B, int Q,  \
      int T, int K, float m, float mm, float indel, int WP, int P, int R, \
      int walk, int SP, float *__restrict__ score
#define BANDED_ARGS                                                        \
  q, t, qlen, tlen, kband, planes, out, counter, B, Q, T, K, m, mm, indel, \
      WP, P, R, walk, SP, score

// What banded_rows does with a problem's rows: K4's op walk, P1's row
// walk, or K9's int8 arrow plane and score.
enum Mode { WALK_OPS, WALK_ROWS, ARROWS };

// The forward rows of a bucket's problems and, after each problem's rows,
// its walk: K4's op walk (walk_back; out: [B, (Q+T)/4] packed ops) or
// P1's row walk (walk_rowsync; out: [B, SP] row codes).  planes: [B,
// T+1, P] scratch, unless a problem's plane fits in shared memory.  K9
// (ARROWS): out is the arrow plane [B, T+1, 2K+1] (int8), score [B];
// each group stages its problem's plane in SP bytes of shared memory, or
// writes its rows to out directly when SP is 0; R = 0, no walk.
template <int CPT, bool MULTI, int MODE>
__device__ __forceinline__ void banded_rows(BANDED_PARAMS) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int SEGC = 32 * CPT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp / WP;
  const int wig = warp - g * WP;
  const int gbytes = 2 * R * P + (MULTI ? 2 * WP * (int)sizeof(Xch) : 0) +
                     (MODE != WALK_OPS ? SP : 0) + 16;
  uint8_t* buf = smem + g * gbytes;
  Xch* xch = (Xch*)(buf + 2 * R * P);
  int* slot = (int*)(buf + gbytes - 16);  // two problem indices, by parity
  // K9's staged plane, after the exchange slots
  uint8_t* stage = buf + 2 * R * P + (MULTI ? 2 * WP * (int)sizeof(Xch) : 0);
  const int band = 2 * K + 1;
  const int L = Q + T;
  const int d0 = (wig * 32 + lane) * CPT;
  // the plane of a problem lives in shared memory when all its rows fit
  // in the group's two chunk buffers (no global plane, no staging)
  const bool in_smem = T + 1 <= 2 * R;
  float indd[CPT];  // indel * d, exact
#pragma unroll
  for (int c = 0; c < CPT; ++c) indd[c] = indel * (float)(d0 + c);

  // The next problem, one ahead: the group takes its index from the
  // counter when it starts a problem and loads its lengths, row-1 q codes
  // (q[d - K]) and first t code before the walk, so that neither round
  // trip stands between two problems.
  int nql = 0, ntl = 0, nkb = 0, nt0 = 0, nqc[CPT];
  auto prefetch = [&](int nb) {
    if (nb >= B) return;
    nql = __ldg(qlen + nb);
    ntl = __ldg(tlen + nb);
    nkb = __ldg(kband + nb);
    nt0 = T > 0 ? (int)__ldg(t + (size_t)nb * T) : 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int qi = d0 + c - K;
      nqc[c] = (unsigned)qi < (unsigned)Q ? (int)__ldg(q + (size_t)nb * Q + qi)
                                          : QPAD;
    }
  };
  int b;
  if (MULTI) {
    if (wig == 0 && lane == 0) slot[0] = atomicAdd(counter, 1);
    group_sync(g + 1, 32 * WP);
    b = slot[0];
  } else {
    b = __shfl_sync(FULL, lane == 0 ? atomicAdd(counter, 1) : 0, 0);
  }
  prefetch(b);

  for (int it = 1; b < B; ++it) {
    const int8_t* qb = q + (size_t)b * Q;
    const int8_t* tb = t + (size_t)b * T;
    // K9 takes any qlen and kband: clamped, every band cell keeps its
    // validity and the pad cells stay invalid
    const int ql = MODE == ARROWS ? min(max(nql, -1), T + K) : nql;
    const int tl = ntl;
    const int kb = MODE == ARROWS ? min(max(nkb, -1), K) : nkb;
    // K9: the score's cell (row jf; dfc, its index among the lane's
    // cells), the plane's place in out and where its rows go
    const int jf = gather_index(tl, T + 1);
    const int dfc =
        gather_index((int)((unsigned)nql - (unsigned)tl + (unsigned)K),
                     band) - d0;
    float sc = NEGF;
    int8_t* dst = (int8_t*)out + (size_t)b * (T + 1) * band;
    int8_t* arow = SP ? (int8_t*)stage + ((size_t)dst & 15) : dst;
    int qc[CPT];  // q codes of the lane's cells at row j
#pragma unroll
    for (int c = 0; c < CPT; ++c) qc[c] = nqc[c];
    int tj_next = nt0;
    // the next problem's index, in flight during this problem's rows
    const int ticket = wig == 0 && lane == 0 ? atomicAdd(counter, 1) : 0;
    uint8_t* pl = in_smem ? buf : planes + (size_t)b * (T + 1) * P;
    uint8_t* prow = pl + wig * seg_bytes<CPT>();  // this warp's row j words

    // row 0: S = indel * offs for 0 <= offs <= kband; LEFT for offs > 0
    float S[CPT];
    bool lo[CPT], hi[CPT];  // the code bits of the lane's cells
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int offs = d0 + c - K;
      const bool inb = offs >= -kb && offs <= kb;
      S[c] = (offs >= 0 && inb) ? indel * (float)offs : NEGF;
      lo[c] = inb && offs > 0;
      hi[c] = false;
      if constexpr (MODE == ARROWS) {
        if (d0 + c < band)
          arow[d0 + c] = (int8_t)(!inb ? -1 : offs > 0 ? LEFT
                                              : offs == 0 ? DONE : -1);
        if (jf == 0 && c == dfc) sc = S[c];
      }
    }
    if constexpr (MODE != ARROWS) store_row<CPT>(prow, lo, hi, lane);
    // row j-1's S right of the warp's last cell (lane 31 reads it)
    float Srn = NEGF;
    if (MULTI && wig + 1 < WP) {
      const int offs = (wig + 1) * SEGC - K;
      Srn = (offs >= 0 && offs <= kb) ? indel * (float)offs : NEGF;
    }

    const int jmax = min(tl, T);
    float ij = 0.f;  // indel * j, exact
    for (int j = 1; j <= jmax; ++j) {
      const int tj = tj_next;
      if (j < jmax) tj_next = __ldg(tb + j);
      ij += indel;
      prow += P;
      // lane 31: its last cell's q code at row j + 1
      int qn = QPAD;
      const int qin = j + d0 + CPT - 1 - K;
      if (lane == 31 && (unsigned)qin < (unsigned)Q) qn = __ldg(qb + qin);
      // valid cells of row j: lo <= d <= hi (i >= 0, i <= qlen, |offs| <=
      // kband); cell i = 0 at d = K - j
      const int lo_rel = max(K - kb, K - j) - d0;
      const int hi_rel = min(K + kb, ql - j + K) - d0;
      const int i0_rel = K - j - d0;

      float s_n = __shfl_down_sync(FULL, S[0], 1);
      if (lane == 31) s_n = Srn;
      float sDel[CPT], inc[CPT];
      unsigned vmask = 0;
      float run = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float s1 = c + 1 < CPT ? S[c + 1] : s_n;
        const float sub = qc[c] == tj ? m : mm;
        sDel[c] = s1 + indel;
        float base = fmaxf(S[c] + sub, sDel[c]);
        if (c == i0_rel) base = ij;
        const bool v = c >= lo_rel && c <= hi_rel;
        vmask |= (v ? 1u : 0u) << c;
        if (!v) base = NEGF;
        run = fmaxf(run, base - indd[c]);
        inc[c] = run;
      }
      // warp-inclusive scan of the lane totals (a lane below o reads its
      // own total back, which max leaves unchanged)
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        run = fmaxf(run, __shfl_up_sync(FULL, run, o));
      float ex = __shfl_up_sync(FULL, run, 1);
      if (lane == 0) ex = -INFINITY;
      float sl_first = NEGF;
      if (MULTI) {
        Xch* X = xch + (j & 1) * WP;
        if (lane == 31) {
          X[wig].agg = run;
          X[wig].vlast = (vmask >> (CPT - 1)) & 1;
        }
        if (lane == 0) {
          X[wig].g0 = inc[0];
          X[wig].vfirst = vmask & 1;
        }
        group_sync(g + 1, 32 * WP);
        float pre = -INFINITY;
        for (int w = 0; w < wig; ++w) pre = fmaxf(pre, X[w].agg);
        ex = fmaxf(ex, pre);
        if (wig > 0)  // S of warp wig-1's last cell, as that warp has it
          sl_first = X[wig - 1].vlast
                         ? pre + indel * (float)(wig * SEGC - 1)
                         : NEGF;
        if (wig + 1 < WP) {  // warp wig+1's first cell, for row j + 1
          const Xch& Y = X[wig + 1];
          Srn = Y.vfirst ? fmaxf(Y.g0, fmaxf(pre, X[wig].agg)) +
                               indel * (float)((wig + 1) * SEGC)
                         : NEGF;
        }
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        S[c] = (vmask >> c) & 1 ? fmaxf(inc[c], ex) + indd[c] : NEGF;
      float sl = __shfl_up_sync(FULL, S[CPT - 1], 1);
      if (lane == 0) sl = sl_first;
      // codes: LEFT if S == S_left + indel, else DOWN if S == sDel, else
      // DIAG; DOWN at i = 0; 0 off the valid cells.  Bit 0 is set for
      // LEFT and DIAG, bit 1 for DOWN and DIAG.
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float left = c > 0 ? S[c - 1] : sl;
        const bool eqL = S[c] == left + indel, eqD = S[c] == sDel[c];
        const bool i0 = c == i0_rel, v = (vmask >> c) & 1;
        lo[c] = v && !i0 && (eqL || !eqD);
        hi[c] = v && (i0 || !eqL);
      }
      if constexpr (MODE == ARROWS) {
        // K9: the code as int8 (never 0 on a valid cell), -1 off them
        int8_t* r = arow + (size_t)j * band;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (d0 + c < band)
            r[d0 + c] = (vmask >> c) & 1 ? (int8_t)(lo[c] | hi[c] << 1) : -1;
          if (j == jf && c == dfc) sc = S[c];
        }
      } else {
        store_row<CPT>(prow, lo, hi, lane);
      }
      const int qs = __shfl_down_sync(FULL, qc[0], 1);
#pragma unroll
      for (int c = 0; c + 1 < CPT; ++c) qc[c] = qc[c + 1];
      qc[CPT - 1] = lane == 31 ? qn : qs;
    }
    // the plane's writes before the walking warp's reads; the next
    // problem's index (slot of parity it: the other one may still be read)
    int nb;
    if (MULTI) {
      if (wig == 0 && lane == 0) slot[it & 1] = ticket;
      group_sync(g + 1, 32 * WP);
      nb = slot[it & 1];
    } else {
      __syncwarp();
      nb = __shfl_sync(FULL, ticket, 0);
    }
    prefetch(nb);
    if constexpr (MODE == ARROWS) {
      // K9: the staged plane out (rows above jmax -1), or those rows
      // alone; the group's threads in turn
      const int plane = (T + 1) * band, lim = (max(jmax, 0) + 1) * band;
      const int gt = wig * 32 + lane, gn = 32 * WP;
      if (SP)
        copy_plane(dst, (const uint8_t*)arow, plane, lim, gt, gn);
      else
        copy_plane(dst + lim, nullptr, plane - lim, 0, gt, gn);
      if ((unsigned)dfc < (unsigned)CPT) score[b] = sc;
      // the stage is read before the next problem's rows overwrite it
      if (MULTI)
        group_sync(g + 1, 32 * WP);
      else
        __syncwarp();
    } else if (walk && wig == 0) {
      if constexpr (MODE == WALK_ROWS)
        walk_rowsync(pl, buf, buf + 2 * R * P, out + (size_t)b * SP, ql, tl,
                     T, K, band, R, SP, lane, in_smem);
      else
        walk_back<CPT, MULTI>(pl, buf, out + (size_t)b * (L / 4), ql, tl,
                              T, K, band, P, R, L, lane, in_smem);
    }
    b = nb;
  }
}

template <int CPT, bool MULTI>
__global__ void __launch_bounds__(256, 2)
banded_global_kernel(BANDED_PARAMS) {
  banded_rows<CPT, MULTI, WALK_OPS>(BANDED_ARGS);
}

__global__ void __launch_bounds__(256, 2) rowsync_kernel(BANDED_PARAMS) {
  banded_rows<2, false, WALK_ROWS>(BANDED_ARGS);
}

template <int CPT, bool MULTI>
__global__ void __launch_bounds__(256, 2) arrows_kernel(BANDED_PARAMS) {
  banded_rows<CPT, MULTI, ARROWS>(BANDED_ARGS);
}

using Kernel = decltype(&rowsync_kernel);  // every instance's type

// K9's tier for bands past 2047 cells (K > 1023): one CTA a problem, 32 *
// ceil(band / 32) threads (at most 1024; a thread takes cells d = tid,
// tid + nt, ...).  The previous row, two closure buffers, sDel and the
// cells' flags live in shared memory (arrows_cta_smem); per row the base
// values, the LEFT closure by log-doubling steps (row = max(row, row[d -
// sh] + indel * sh)) and the arrows, 3 + ceil(log2(band)) block barriers.
// Each row's arrows go out as one coalesced store of band bytes.
constexpr int SMEM_MAX = 232448;

__host__ __device__ constexpr int arrows_cta_smem(int band) {
  return 16 * band + ((band + 15) / 16) * 16;
}

__global__ void __launch_bounds__(1024)
    arrows_cta_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ t,
                      const int* __restrict__ qlen,
                      const int* __restrict__ tlen,
                      const int* __restrict__ kband, float* score,
                      int8_t* arrows, int Q, int T, int K, float m, float mm,
                      float indel, int logs) {
  extern __shared__ __align__(16) unsigned char smem_cta[];
  const int band = 2 * K + 1, b = blockIdx.x, nt = blockDim.x;
  float* prev = (float*)smem_cta;
  float* bufA = prev + band;
  float* bufB = bufA + band;
  float* sdel = bufB + band;
  uint8_t* flag = (uint8_t*)(sdel + band);  // 1: valid, 2: i == 0
  const int ql = qlen[b], tl = tlen[b], kb = kband[b];
  const int8_t* qb = q + (size_t)b * Q;
  const int8_t* tb = t + (size_t)b * T;
  int8_t* ab = arrows + (size_t)b * (T + 1) * band;
  const int jf = gather_index(tl, T + 1);
  const int df =
      gather_index((int)((unsigned)ql - (unsigned)tl + (unsigned)K), band);

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
    float* dstb = bufB;
    for (int s = 0; s < logs; ++s) {
      const int sh = 1 << s;
      const float add = indel * (float)sh;
      for (int d = threadIdx.x; d < band; d += nt)
        dstb[d] = fmaxf(src[d], __fadd_rn(d >= sh ? src[d - sh] : NEGF, add));
      __syncthreads();
      float* tmp = src;
      src = dstb;
      dstb = tmp;
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

// The blocks of a kernel that fit on the card at once (threads and
// dynamic shared memory a block), after raising the kernel's shared
// memory limit on the device (never lowering it: a kept answer may be
// for a larger block); the last 32 answers are kept, so that a launch
// costs the host no query it has made before.
cudaError_t resident_blocks(Kernel kern, int dev, int threads, int smem,
                            int* blocks) {
  struct Entry {
    Kernel kern;
    int dev, threads, smem, blocks;
  };
  struct Raised {
    Kernel kern;
    int dev, smem;
  };
  static Entry seen[32];
  static Raised raised[16];
  static int n = 0, nr = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < n && k < 32; ++k)
    if (seen[k].kern == kern && seen[k].dev == dev &&
        seen[k].threads == threads && seen[k].smem == smem) {
      *blocks = seen[k].blocks;
      return cudaSuccess;
    }
  int r = 0;
  while (r < nr && !(raised[r].kern == kern && raised[r].dev == dev)) ++r;
  if (r == nr) {
    if (nr == 16) return cudaErrorInvalidDevice;
    raised[nr++] = {kern, dev, 0};
  }
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaSuccess;
  if (smem > raised[r].smem) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised[r].smem = smem;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  seen[n % 32] = {kern, dev, threads, smem, per_sm * sms};
  ++n;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// The persistent grid of kern for B problems, PPC a block of `threads`:
// the blocks that fit on the card at once, at most one per PPC problems;
// the problem counter zeroed on the stream.
cudaError_t persistent_grid(Kernel kern, int B, int threads, int PPC,
                            int smem, int* counter, cudaStream_t stream,
                            int* grid) {
  int dev = 0, fit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = resident_blocks(kern, dev, threads, smem, &fit)) != cudaSuccess)
    return e;
  *grid = min((B + PPC - 1) / PPC, fit);
  return cudaMemsetAsync(counter, 0, sizeof(int), stream);
}

}  // namespace

// q, t: int8 [B, Q], [B, T]; qlen, tlen, kband: int32 [B]; planes: uint8
// scratch [B, T+1, P]; out: uint8 [B, (Q+T)/4]; counter: one int32 of
// scratch.  CPT, WP, PPC, P, R and smem from
// ops/affine_kernel.py:global_plan; walk = 0 skips the traceback (a
// timing of the forward rows alone; out is then not written).
extern "C" int lra_banded_global_traced_packed(
    const void* q, const void* t, const void* qlen, const void* tlen,
    const void* kband, void* planes, void* out, void* counter, int B, int Q,
    int T, int K, int m, int mm, int indel, int CPT, int WP, int PPC, int P,
    int R, int smem, int walk, void* stream) {
  if (B == 0) return 0;
  if (2 * K + 1 > 32 * CPT * WP || P != 16 * ((CPT + 1) / 2) * WP ||
      PPC < 1 || WP * PPC > 8 || R < 1)
    return (int)cudaErrorInvalidValue;
  Kernel kern = nullptr;
  if (WP == 1 && CPT == 2) kern = banded_global_kernel<2, false>;
  if (WP == 1 && CPT == 5) kern = banded_global_kernel<5, false>;
  if (WP == 1 && CPT == 9) kern = banded_global_kernel<9, false>;
  if (WP > 1 && CPT == 9) kern = banded_global_kernel<9, true>;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = 32 * WP * PPC;
  int grid = 0;
  const cudaError_t e = persistent_grid(kern, B, threads, PPC, smem,
                                        (int*)counter, st, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, st>>>(
      (const int8_t*)q, (const int8_t*)t, (const int*)qlen, (const int*)tlen,
      (const int*)kband, (uint8_t*)planes, (uint8_t*)out, (int*)counter, B, Q,
      T, K, (float)m, (float)mm, (float)indel, WP, P, R, walk, 0, nullptr);
  return (int)cudaGetLastError();
}

// P1: q, t: int8 [B, S]; qlen, tlen, kband: int32 [B]; planes: uint8
// scratch [B, S+1, 16] (unused when S + 1 <= 2R: the plane stays in
// shared memory); P: uint8 [B, SP]; counter: one int32 of scratch.  PPC,
// R and smem from ops/affine_pallas.py:rowsync_plan.  Needs 2K+1 <= 63
// (run lengths in 6 bits).
extern "C" int lra_banded_pallas_rowsync(
    const void* q, const void* t, const void* qlen, const void* tlen,
    const void* kband, void* planes, void* P, void* counter, int B, int S,
    int SP, int K, int m, int mm, int indel, int PPC, int R, int smem,
    void* stream) {
  if (B == 0) return 0;
  if (2 * K + 1 > 63 || PPC < 1 || PPC > 8 || R < 1 || SP < S + 1 ||
      SP % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int grid = 0;
  const cudaError_t e = persistent_grid(rowsync_kernel, B, 32 * PPC, PPC,
                                        smem, (int*)counter, st, &grid);
  if (e != cudaSuccess) return (int)e;
  rowsync_kernel<<<grid, 32 * PPC, smem, st>>>(
      (const int8_t*)q, (const int8_t*)t, (const int*)qlen, (const int*)tlen,
      (const int*)kband, (uint8_t*)planes, (uint8_t*)P, (int*)counter, B, S,
      S, K, (float)m, (float)mm, (float)indel, 1, 16, R, 1, SP, nullptr);
  return (int)cudaGetLastError();
}

// K9: q, t: int8 [B, Q], [B, T]; qlen, tlen, kband: int32 [B].  Out:
// score f32 [B], arrows int8 [B, T+1, 2K+1]; counter: one int32 of
// scratch.  The plan from ops/affine_kernel.py:arrows_plan and
// arrows_launch: CPT > 0 runs the warp rows (CPT, WP, PPC; SP staging
// bytes a problem, 0 to write the rows to arrows directly; smem), CPT = 0
// the CTA tier (threads a problem; smem = arrows_cta_smem(band)).
extern "C" int lra_banded_arrows(const void* q, const void* t,
                                 const void* qlen, const void* tlen,
                                 const void* kband, void* score, void* arrows,
                                 void* counter, int B, int Q, int T, int K,
                                 int m, int mm, int indel, int CPT, int WP,
                                 int PPC, int SP, int threads, int smem,
                                 void* stream) {
  if (B == 0) return 0;
  const int band = 2 * K + 1;
  if (K < 0 || Q < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (CPT == 0) {
    if (threads % 32 || threads < 32 || threads > 1024 ||
        smem != arrows_cta_smem(band) || smem > SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    static std::mutex mu;
    static unsigned long long raised = 0;  // a bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    {
      std::lock_guard<std::mutex> lock(mu);
      if (!(raised >> dev & 1)) {
        e = cudaFuncSetAttribute((const void*)arrows_cta_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_MAX);
        if (e != cudaSuccess) return (int)e;
        raised |= 1ull << dev;
      }
    }
    int logs = 0;
    while ((1 << logs) < band) ++logs;
    arrows_cta_kernel<<<B, threads, smem, st>>>(
        (const int8_t*)q, (const int8_t*)t, (const int*)qlen,
        (const int*)tlen, (const int*)kband, (float*)score, (int8_t*)arrows,
        Q, T, K, (float)m, (float)mm, (float)indel, logs);
    return (int)cudaGetLastError();
  }
  const int xch = WP > 1 ? 2 * WP * (int)sizeof(Xch) : 0;
  if (band > 32 * CPT * WP || PPC < 1 || WP * PPC > 8 ||
      threads != 32 * WP * PPC || SP < 0 || SP % 16 ||
      (SP && SP < (T + 1) * band + 15) || smem != PPC * (xch + SP + 16))
    return (int)cudaErrorInvalidValue;
  Kernel kern = nullptr;
  if (WP == 1 && CPT == 2) kern = arrows_kernel<2, false>;
  if (WP == 1 && CPT == 5) kern = arrows_kernel<5, false>;
  if (WP == 1 && CPT == 9) kern = arrows_kernel<9, false>;
  if (WP > 1 && CPT == 9) kern = arrows_kernel<9, true>;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t e = persistent_grid(kern, B, threads, PPC, smem,
                                        (int*)counter, st, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, st>>>(
      (const int8_t*)q, (const int8_t*)t, (const int*)qlen, (const int*)tlen,
      (const int*)kband, nullptr, (uint8_t*)arrows, (int*)counter, B, Q, T,
      K, (float)m, (float)mm, (float)indel, WP, 0, 0, 0, SP, (float*)score);
  return (int)cudaGetLastError();
}
