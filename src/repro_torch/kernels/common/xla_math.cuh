// XLA-CPU's float32 exp and sigmoid, op for op: the device twin of
// exp_f32 and sigmoid_f32 in repro_torch/core/xla_ndtr.py. Every
// multiply, add and divide is an explicit round-to-nearest intrinsic
// (__fmaf_rn where XLA's machine code fuses, __fmul_rn / __fadd_rn where
// it does not, __fdiv_rn for the IEEE division), so no compiler
// contraction can move a bit; the kernels are built with --fmad=false
// besides. Shared by ndtr.cuh (the Gaussian CDF) and the logistic CDF.
#pragma once

namespace xla_math {

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// XLA's CPU runtime flushes subnormal results to zero (sign kept).
__device__ __forceinline__ float flush(float y) {
  return fabsf(y) < 0x1p-126f ? mul(y, 0.0f) : y;
}

// XLA's exp_f32: Cody-Waite reduction, degree-5 polynomial, 2^n from bits.
__device__ __forceinline__ float exp_f32(float x) {
  const float lo = -0x1.5f3334p+6f, hi = 0x1.633334p+6f;   // -87.8, 88.8
  x = x < lo ? lo : x;            // comparisons keep NaN, as XLA's do
  x = x > hi ? hi : x;
  float fx = floorf(fma_(x, 0x1.715476p+0f, 0.5f));
  fx = fx < -127.0f ? -127.0f : fx;
  fx = fx > 127.0f ? 127.0f : fx;
  float r = fma_(fx, -0x1.63p-1f, x);
  r = fma_(fx, 0x1.bd0106p-13f, r);
  float p = fma_(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  p = fma_(p, r, 0x1.11121p-7f);
  p = fma_(p, r, 0x1.555382p-5f);
  p = fma_(p, r, 0x1.555554p-3f);
  p = fma_(p, r, 0.5f);
  p = add(fma_(p, mul(r, r), r), 1.0f);
  int n = (fx == fx) ? (int)fx : 0;
  return mul(p, __int_as_float((n + 127) << 23));
}

// jax.nn.sigmoid on XLA-CPU: 1 / (1 + exp(-x)), the division correctly
// rounded, a subnormal result flushed. Near x = -88.7, exp(-x) overflows
// to inf and the result is 0, as on the CPU.
__device__ __forceinline__ float sigmoid_f32(float x) {
  return flush(__fdiv_rn(1.0f, add(1.0f, exp_f32(-x))));
}

// Logistic grid start F(i) = floor(clip(sigmoid((z_i - mu) * (1/s)), 0, 1)
// * (2^p - K)) + i, the CDF pinned to 0 at i <= 0 and 1 at i >= K
// (codecs/leaves.py logistic_starts_fn); edge z_j is load(j), j clamped to
// [0, K].
template <typename Load>
__device__ __forceinline__ unsigned logistic_start_from(
    const Load& load, int i, float mu, float inv_scale, int k,
    float scale) {
  float z = load(i < 0 ? 0 : (i > k ? k : i));
  float c = sigmoid_f32(mul(sub(z, mu), inv_scale));
  c = c < 0.0f ? 0.0f : c;        // jnp.clip; comparisons keep NaN
  c = c > 1.0f ? 1.0f : c;
  c = i <= 0 ? 0.0f : c;
  c = i >= k ? 1.0f : c;
  return (unsigned)floorf(mul(c, scale)) + (unsigned)i;
}

// The same F over the edges `edges` (K + 1 of them).
__device__ __forceinline__ unsigned logistic_start(
    const float* edges, int i, float mu, float inv_scale, int k,
    float scale) {
  return logistic_start_from([edges](int j) { return edges[j]; }, i, mu,
                             inv_scale, k, scale);
}

}  // namespace xla_math
