// The concave PWL gap cost (K1), shared by the chaining kernels
// (sdp_blocked.cu, K2; sdp_windowed.cu, K7).
//
// Replaces lra_tpu/ops/gapcost.py:pwl_select_jnp, inlined per fragment
// pair.  The reference walks all 24 pieces in ascending order and keeps
// the last one with STOPS[i] <= x and slope != 0.  Here the host folds
// that rule into a table of effective pieces, one per stop index
// (ops/gapcost.py:pwl_effective_pieces: the largest i' <= i with a
// non-zero slope, or (0, 0) when there is none), and the device finds
// the stop index by a 5-step binary search over the 25 stops.  Then one
// piece value s*x + b, as two separately rounded f32 ops (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract it into an FMA and the floor
// could see a different value than the reference's.  The same operands
// go through the same two roundings as in the reference's chain (with no
// effective piece, 0*x + 0 = +0, its start value), so the result is
// bit-equal by construction (tests/test_torch_pwl_lookup.py checks the
// numpy emulation of this lookup against lra_tpu for x in 0..120000).
// The stops and the table live in shared memory: kernel parameters sit
// in the constant bank, where lanes that read different indices are
// served one address at a time.
//
// pwl_bucket_index (K2) finds the same stop index with one lookup, not
// the 5-step search: the stops lie at least 5 apart below 1024 and at
// least 1000 apart from 1000 on, so a bucket of 4 (x < 1024) or of 512
// (1024 <= x < 102400) holds at most one stop past its left edge; its
// entry holds the stop index at the left edge and that next stop
// (INT_MAX when there is none), and x >= 102400 lies past the last stop
// (its entry (23, 100000): an INT_MAX there could be reached by x).
// ops/gapcost.py:pwl_buckets_np builds the same table on the host
// (tests/test_torch_pwl_lookup.py checks the index for every x).

#pragma once

#include <limits.h>

namespace {

constexpr int NPIECE = 24;
constexpr int NSTOP = NPIECE + 1;

// slope[25], inter[25] (effective piece per stop index), ceiling1,
// ceiling2: the host array the wrappers pass (ops/sdp_blocked.py:
// _pwl_host_params), copied into a kernel parameter
struct Pwl {
  float slope[NSTOP];
  float inter[NSTOP];
  float c1, c2;
};

// The lookup's shared-memory copy: the stops padded to 32 with INT_MAX
// (so the search needs no bounds test) and (slope, inter) per stop index.
struct PwlSmem {
  int stops[32];
  float2 piece[32];
  float c1, c2;
};

// lra_tpu/ops/gapcost.py:STOPS, read once per CTA by pwl_load
__constant__ int c_stops[NPIECE + 1] = {
    0, 5, 10, 20, 40, 80, 100, 200, 300, 500, 1000, 2000, 3000, 4000, 5000,
    6000, 7000, 8000, 9000, 15000, 20000, 30000, 40000, 50000, 100000};

// Fill s from p; every thread of the block calls it, and a barrier must
// follow before the first pwl().
__device__ __forceinline__ void pwl_load(PwlSmem& s, const Pwl& p) {
  const int t = threadIdx.x;
  if (t < 32) {
    s.stops[t] = t < NSTOP ? c_stops[t] : INT_MAX;
    s.piece[t] = t < NSTOP ? make_float2(p.slope[t], p.inter[t])
                           : make_float2(0.f, 0.f);
  }
  if (t == 0) {
    s.c1 = p.c1;
    s.c2 = p.c2;
  }
}

// PWL_w(x) from the effective piece pc of the last stop <= x: the piece,
// then floor and two ceilings; x <= 2 is free.
__device__ __forceinline__ float pwl_piece(int x, float2 pc, float c1,
                                           float c2) {
  float pen = __fadd_rn(__fmul_rn(pc.x, __int2float_rn(x)), pc.y);
  pen = floorf(pen);
  if (pen >= c1 && pen < c2) pen = c1;
  if (pen > c2) pen = c2;
  return x <= 2 ? 0.f : pen;
}

// PWL_w(x) from stop index lo (the last stop <= x).
__device__ __forceinline__ float pwl_at(int x, int lo, const PwlSmem& s) {
  return pwl_piece(x, s.piece[lo], s.c1, s.c2);
}

// PWL_w(x) for x >= 0, the stop index by binary search.
__device__ __forceinline__ float pwl(int x, const PwlSmem& s) {
  int lo = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (s.stops[lo + step] <= x) lo += step;
  return pwl_at(x, lo, s);
}

constexpr int NBUCKET = 256 + 198 + 1;

// The bucket table of pwl_bucketed: (stop index at the left edge, the
// next stop inside the bucket or INT_MAX).
struct PwlBuckets {
  int2 e[NBUCKET];
};

// Fill b, thread t of nt; a barrier must follow before the first lookup.
__device__ __forceinline__ void pwl_buckets_load(PwlBuckets& b, int t,
                                                 int nt) {
  for (int k = t; k < NBUCKET; k += nt) {
    const int lo = k < 256 ? 4 * k : 1024 + 512 * (k - 256);
    const int hi = k < 256 ? lo + 4 : k < NBUCKET - 1 ? lo + 512 : INT_MAX;
    int idx = 0;
    for (int i = 1; i < NSTOP; ++i)
      if (c_stops[i] <= lo) idx = i;
    const int nxt = idx + 1 < NSTOP && c_stops[idx + 1] < hi
                        ? c_stops[idx + 1] : INT_MAX;
    // past the last stop: (24 - 1, 100000), as no x there reaches INT_MAX
    b.e[k] = k < NBUCKET - 1 ? make_int2(idx, nxt)
                             : make_int2(NSTOP - 2, c_stops[NSTOP - 1]);
  }
}

// The last stop <= x from the bucket table (x < 0 reads bucket 0; such
// an x is free all the same).
__device__ __forceinline__ int pwl_bucket_index(int x, const PwlBuckets& b) {
  const int k = x < 1024 ? max(x, 0) >> 2
                         : min(256 + ((x - 1024) >> 9), NBUCKET - 1);
  const int2 e = b.e[k];
  return e.x + (x >= e.y);
}

// w(di, dj) = -PWL_w(|di - dj| + 1)
__device__ __forceinline__ float pair_cost(int di, int dj, const PwlSmem& s) {
  return -pwl(abs(di - dj) + 1, s);
}

// (value, index) max with the first index winning ties, as jnp.argmax
__device__ __forceinline__ void better(float& v, int& a, int& f, float ov,
                                       int oa, int of) {
  if (ov > v || (ov == v && oa < a)) {
    v = ov;
    a = oa;
    f = of;
  }
}

}  // namespace
