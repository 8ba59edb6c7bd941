// The decode bisection of core/discretize.py `bisect` walked by a group of
// G = 2^g threads of one warp (16 or 32, in the grid pop and the
// bucketize) instead of one thread: the largest i in [0, 2^bits) with
// F(i) <= slot, by the same bits + 1 halvings (mid = (lo + hi + 1) / 2)
// over the same tree, then F(i) and F(i + 1). ../ans/twin.py
// grid_tree_walk is this walk in Python.
//
// Below a node whose interval has n = 2^m points, the tree's next L
// levels probe a grid: lo + j n / 2^L for j = 1 .. 2^L - 1 (the sizes
// stay even down to n / 2^L). So a round evaluates F at one grid point a
// thread and takes the group's comparisons (bit j: F(point j) <= slot)
// in one ballot. Which of the 2^L leaves the L halvings reach is then
// found in parallel too: leaf x is reached iff each point its path
// probes (at level i, x's top i bits followed by a one) has the bit that
// x's next bit says (up for 1, down for 0). Exactly one leaf meets
// that for any bits, so the walk is the bisection's own, with nothing
// assumed of F (the bisection reads the same F(mid) <= slot one level at
// a time); each thread tests one leaf and a second ballot names it.
//
// The last round takes an interval of n <= G / 2 points and evaluates F
// at all of lo .. lo + n + 1, which holds every point below it and the
// two ends F(i), F(i + 1) of the answer (moved by shuffles); its last
// halving, of an interval of one point, tests that point's upper end.
#pragma once

#include <stdint.h>

namespace group_walk {

// The comparisons `pred` of the G threads of this thread's group, the
// group's thread t at bit t. Every thread of the warp must call it.
template <int G>
__device__ __forceinline__ uint32_t ballot(bool pred) {
  const uint32_t b = __ballot_sync(0xffffffffu, pred);
  if constexpr (G == 32) {
    return b;
  } else {
    return (b >> ((threadIdx.x & 31u) & ~(uint32_t)(G - 1))) &
           ((1u << G) - 1u);
  }
}

// The path of leaf x (< 2^levels) of a walk over 2^levels grid points:
// the points it probes and those of them it needs up.
template <typename W>
struct Path {
  W probe = 0, ones = 0;
};

template <typename W>
__device__ __forceinline__ Path<W> path(int x, int levels) {
  Path<W> q;
  for (int i = levels - 1; i >= 0; --i) {
    const int point = ((x >> (i + 1)) << (i + 1)) | (1 << i);
    q.probe |= W(1) << point;
    if ((x >> i) & 1) q.ones |= W(1) << point;
  }
  return q;
}

// Whether the walk on bits `up` reaches the leaf of path q.
template <typename W>
__device__ __forceinline__ bool reaches(W up, const Path<W>& q) {
  return ((up ^ q.ones) & q.probe) == 0;
}

// The last round's answer j (0 .. n) for thread j of the group, given
// paths a = path(j, m) and b = path(j - 1, m) over the n = 2^m points
// below the last halving (`has_a`: j < n; `has_b`: 1 <= j <= n): the m
// halvings reach j and point j + 1 is down, or they reach j - 1 and
// point j is up.
__device__ __forceinline__ bool answers(uint32_t up, const Path<uint32_t>& a,
                                        bool has_a,
                                        const Path<uint32_t>& b,
                                        bool has_b, int j) {
  return (has_a && reaches(up, a) && !((up >> (j + 1)) & 1u)) ||
         (has_b && reaches(up, b) && ((up >> j) & 1u));
}

}  // namespace group_walk
