// The concave PWL gap cost (K1), shared by the chaining kernels
// (sdp_blocked.cu, K2; sdp_windowed.cu, K7).
//
// Replaces lra_tpu/ops/gapcost.py:pwl_select_jnp, inlined per fragment
// pair.  The piece value s*x + b is two separately rounded f32 ops
// (__fmul_rn, __fadd_rn): nvcc would otherwise contract it into an FMA
// and the floor could see a different value than the reference's.

#pragma once

namespace {

constexpr int NPIECE = 24;

__constant__ int c_stops[NPIECE + 1] = {
    0, 5, 10, 20, 40, 80, 100, 200, 300, 500, 1000, 2000, 3000, 4000, 5000,
    6000, 7000, 8000, 9000, 15000, 20000, 30000, 40000, 50000, 100000};

// slope[24], inter[24], ceiling1, ceiling2: the host array the wrappers
// pass (ops/sdp_blocked.py:_pwl_host_params), copied into a kernel
// parameter
struct Pwl {
  float slope[NPIECE];
  float inter[NPIECE];
  float c1, c2;
};

// PWL_w(x): pieces overwrite ascending (the last piece with STOPS[i] <= x
// wins; zero-slope pieces are skipped), then floor and two ceilings.
__device__ __forceinline__ float pwl(int x, const Pwl& p) {
  const float xf = __int2float_rn(x);
  float pen = 0.f;
#pragma unroll
  for (int i = 0; i < NPIECE; ++i) {
    if (p.slope[i] != 0.f && x >= c_stops[i])
      pen = __fadd_rn(__fmul_rn(p.slope[i], xf), p.inter[i]);
  }
  pen = floorf(pen);
  if (pen >= p.c1 && pen < p.c2) pen = p.c1;
  if (pen > p.c2) pen = p.c2;
  return x <= 2 ? 0.f : pen;
}

// w(di, dj) = -PWL_w(|di - dj| + 1)
__device__ __forceinline__ float pair_cost(int di, int dj, const Pwl& p) {
  return -pwl(abs(di - dj) + 1, p);
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
