// The decode bisection of core/discretize.py `bisect`: the largest i in
// [0, 2^bits) with F(i) <= slot, by bits + 1 halvings with
// mid = (lo + hi + 1) / 2, F being a fixed-point CDF start (non-decreasing,
// F(0) = 0). Shared by pop_grid.cu (gaussian and logistic kinds) and
// bucketize.cu, which bisect the same F (xla_ndtr::grid_start).
#pragma once

#include <stdint.h>

template <typename F>
__device__ __forceinline__ int grid_bisect(const F& f, uint32_t slot,
                                           int bits) {
  int lo = 0, hi = 1 << bits;
  for (int b = 0; b <= bits; ++b) {
    int mid = (lo + hi + 1) >> 1;
    bool up = f(mid) <= slot;
    lo = up ? mid : lo;
    hi = up ? hi : mid;
  }
  return lo;
}
