// XLA-CPU's float32 ndtr, op for op: the device twin of
// repro_torch/core/xla_ndtr.py (same sequence, same constants, same
// places for a fused multiply-add). Every multiply, add and divide is an
// explicit round-to-nearest intrinsic, so no compiler contraction can
// move a bit; the kernels are built with --fmad=false besides.
//
// XLA's CPU backend lets LLVM fuse each multiply into the add that
// consumes it (read from the machine code of jax.jit(ndtr)): every
// Horner step and Cody-Waite step is one fma. The multiplies that stay
// separate are x*x, e * (1/|x|) * P, x * P(x^2), r*r and the final * 0.5.
// The constants are the float32 values in XLA's optimised IR. exp_f32 and
// the helpers are shared with the logistic CDF (xla_math.cuh).
#pragma once

#include "xla_math.cuh"

namespace xla_ndtr {

using xla_math::add;
using xla_math::exp_f32;
using xla_math::fma_;
using xla_math::mul;
using xla_math::sub;

__device__ __forceinline__ float ndtr(float a) {
  const float half_sqrt2 = 0x1.6a09e6p-1f;
  float x = mul(a, half_sqrt2);
  float z = mul(x, x);
  float w = __frcp_rn(z);
  // erfc, 1 <= |x| < 2: P(1/z)
  float pp = fma_(w, 0x1.7d39e8p-6f, -0x1.1c10dp-3f);
  pp = fma_(w, pp, 0x1.7997ap-2f);
  pp = fma_(w, pp, -0x1.2a39fp-1f);
  pp = fma_(w, pp, 0x1.3df3c6p-1f);
  pp = fma_(w, pp, -0x1.fa518p-2f);
  pp = fma_(w, pp, 0x1.5ca8e2p-2f);
  pp = fma_(w, pp, -0x1.18b1p-2f);
  pp = fma_(w, pp, 0x1.20adccp-1f);
  // erfc, |x| >= 2: R(1/z)
  float pr = fma_(w, -0x1.4f4906p+3f, 0x1.9f4538p+3f);
  pr = fma_(w, pr, -0x1.dfb694p+2f);
  pr = fma_(w, pr, 0x1.75e3f4p+1f);
  pr = fma_(w, pr, -0x1.03e86cp+0f);
  pr = fma_(w, pr, 0x1.aff87cp-2f);
  pr = fma_(w, pr, -0x1.20d8bap-2f);
  pr = fma_(w, pr, 0x1.20dd72p-1f);
  // erfc, |x| < 1: T(z)
  float pt = fma_(z, 0x1.496a32p-14f, -0x1.a3f7p-11f);
  pt = fma_(z, pt, 0x1.5405b2p-8f);
  pt = fma_(z, pt, -0x1.b7f90ep-6f);
  pt = fma_(z, pt, 0x1.ce2cf8p-4f);
  pt = fma_(z, pt, -0x1.81273ep-2f);
  pt = fma_(z, pt, 0x1.20dd74p+0f);
  float ax = fabsf(x);
  float e = exp_f32(-z);
  float big = mul(mul(e, __frcp_rn(ax)), ax < 2.0f ? pp : pr);
  big = z > 0x1.62e43p+6f ? 0.0f : big;
  float small = fma_(-ax, pt, 1.0f);
  float erfc = ax < 1.0f ? small : big;
  // erf over the clamped argument
  const float cl = 0x1.df38dp+1f;
  float xc = x < -cl ? -cl : x;
  xc = xc > cl ? cl : xc;
  float x2 = mul(xc, xc);
  float num = fma_(x2, 0x1.e05aa2p-13f, 0x1.bebb44p-9f);
  num = fma_(x2, num, 0x1.a16dd6p-5f);
  num = fma_(x2, num, 0x1.7b4e8p-3f);
  num = fma_(x2, num, 0x1.20dd74p+0f);
  float den = fma_(x2, -0x1.fa720cp-24f, 0x1.8b11bep-16f);
  den = fma_(x2, den, 0x1.0ada5p-10f);
  den = fma_(x2, den, 0x1.cd0fa8p-7f);
  den = fma_(x2, den, 0x1.c69842p-4f);
  den = fma_(x2, den, 0x1.fd6894p-2f);
  den = fma_(x2, den, 1.0f);
  float erf = __fdiv_rn(mul(xc, num), den);
  float upper = x > 0.0f ? sub(2.0f, erfc) : erfc;
  float y = mul(ax < half_sqrt2 ? add(erf, 1.0f) : upper, 0.5f);
  // XLA's CPU runtime flushes subnormal results to zero.
  return xla_math::flush(y);
}

// F(i) = floor(ndtr((z_i - mu) * (1/sigma)) * (2^p - K)) + i, with the
// CDF pinned to 0 at i <= 0 and 1 at i >= K (core/discretize.py); edge
// z_j is load(j), j clamped to [0, K]. With SKIP_ENDS the pinned ends
// skip the ndtr (the same integers): at z_0 = -inf its IEEE reciprocals
// take their slow paths, which a group of threads all wait for; the
// branch costs the grid pop's wider group more than it saves.
template <bool SKIP_ENDS = false, typename Load>
__device__ __forceinline__ unsigned grid_start_from(const Load& load, int i,
                                                    float mu,
                                                    float inv_sigma, int k,
                                                    float scale) {
  float c;
  if constexpr (SKIP_ENDS) {
    if (i <= 0 || i >= k)
      c = i <= 0 ? 0.0f : 1.0f;
    else
      c = ndtr(mul(sub(load(i), mu), inv_sigma));
  } else {
    float z = load(i < 0 ? 0 : (i > k ? k : i));
    c = ndtr(mul(sub(z, mu), inv_sigma));
    c = i <= 0 ? 0.0f : c;
    c = i >= k ? 1.0f : c;
  }
  return (unsigned)floorf(mul(c, scale)) + (unsigned)i;
}

// The same F over the edges `edges` (K + 1 of them).
__device__ __forceinline__ unsigned grid_start(
    const float* edges, int i, float mu, float inv_sigma, int k,
    float scale) {
  return grid_start_from([edges](int j) { return edges[j]; }, i, mu,
                         inv_sigma, k, scale);
}

}  // namespace xla_ndtr
