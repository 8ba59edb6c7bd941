// Posterior-decode bucketize over the max-entropy N(0,1) bucket grid: the
// CUDA port of repro/kernels/bucketize/kernel.py:37 _bucketize_kernel.
//
// Per lane, idx = max{i : F(i) <= slot} for the fixed-point Gaussian CDF
// F(i) = floor(ndtr((z_i - mu) * (1/sigma)) * (2^p - K)) + i (F(0) = 0,
// F(K) = 2^p), found by the (lat_bits+1)-step bisection of
// core/discretize.py, then (idx, F(idx), F(idx+1) - F(idx)). F is
// xla_ndtr::grid_start of ../../common/ndtr.cuh (XLA-CPU's float32 ndtr op
// for op, the clamps after the ndtr): the very code the gaussian kind of
// ../../ans/csrc/pop_grid.cu runs, so both decode the same buckets.
//
// What bounds it on an H100: one launch decodes one latent position of
// every lane (256 lanes on the HVAE's path), so the card is nearly empty
// and the time is one lane's latency. F costs about 100 flops, but its
// evaluations in a bisection are a chain, each waiting on the last, and
// the IEEE divisions inside F branch, so its latency is long: one thread
// a lane would wait on lat_bits + 3 of them (13 at lat_bits 10), and 256
// such threads would fill 2 of the 132 SMs.
//
// Design: a group of G threads walks each lane's bisection tree
// (../../common/group_walk.cuh), round for round as the grid pop's chain
// walks it (twin.grid_tree_walk): a top round over the tree's top TOP
// levels, rounds of log2 G levels, one point a thread, and a last round
// over every point of an interval of at most G / 2 + 2 points, whose
// answer's F(idx), F(idx+1) come from the group's probes by shuffles. At
// G = 32 a lane has a second warp that evaluates the top round's upper 32
// points beside the first (one thread could not overlap two evaluations:
// the IEEE divisions inside F branch) and hands its ballot over in shared
// memory. At lat_bits 10 a lane's chain is then two evaluations at G = 32
// and three at G = 16, against 13. Every round reads only the edges it
// probes, through the read-only path (the top round's do not depend on
// the slot and load with mu and sigma; prefetching the table's lines
// into L1 made the kernel slower, not faster). F skips the ndtr at the
// pinned ends i <= 0 and i >= K, whose -inf edge sent the IEEE division
// and reciprocal of every group's first probe down their slow paths.
// Blocks of 128 threads: 256 lanes run as 128 blocks at G = 32. The wider
// group evaluates more points that the walk does not take, so at many
// lanes, where the card's issue rate counts, G = 16 is faster
// (group_for).
#include <cuda_runtime.h>
#include <stdint.h>

#include "group_walk.cuh"
#include "ndtr.cuh"

namespace {

constexpr int THREADS = 128;

// The grid pop's round shapes (pop_grid.cu Shape; twin.GROUP_TOP_LEVELS):
// log2 G levels a round, TOP levels in the top round. At G = 32 a lane has
// two warps, the second evaluating the top round's upper 32 points (WPL:
// warps a lane).
template <int G>
struct Walk;
template <>
struct Walk<32> {
  static constexpr int LOG_G = 5, TOP = 6, WPL = 2;
};
template <>
struct Walk<16> {
  static constexpr int LOG_G = 4, TOP = 3, WPL = 1;
};

template <int G>
__global__ void __launch_bounds__(THREADS)
    bucketize_kernel(const int32_t* __restrict__ slot,
                     const float* __restrict__ mu,
                     const float* __restrict__ sigma,
                     const float* __restrict__ edges,
                     int32_t* __restrict__ idx_out,
                     int32_t* __restrict__ start_out,
                     int32_t* __restrict__ freq_out, int lanes, int lat_bits,
                     int precision) {
  constexpr int LOG_G = Walk<G>::LOG_G, WPL = Walk<G>::WPL;
  constexpr int LB = THREADS / (G * WPL);  // lanes a block
  __shared__ uint32_t upper[LB];  // the top round's upper 32 bits a lane
  const int k = 1 << lat_bits;
  const int t = threadIdx.x & (G - 1);
  const int li = threadIdx.x / (G * WPL);
  const bool second = WPL > 1 && (threadIdx.x / G) % WPL == 1;
  const int l = blockIdx.x * LB + li;
  const bool live = l < lanes;
  const int lc = live ? l : lanes - 1;
  // The top round: the tree's top p levels, np points sp apart. When the
  // group holds every point 0 .. K + 1 (`full_round`), the last round is
  // the only one.
  const bool full_round = k + 2 <= G;
  const int p = min(Walk<G>::TOP, lat_bits), np = 1 << p, sp = k >> p;
  const bool top64 = !full_round && p == 6;
  if (second && !top64) return;
  const uint32_t s = (uint32_t)__ldg(slot + lc);
  const float m = __ldg(mu + lc), inv = __frcp_rn(__ldg(sigma + lc));
  const float scale = (float)((1 << precision) - k);
  const auto edge = [edges](int j) { return __ldg(edges + j); };
  const auto f = [&](int i) {
    return xla_ndtr::grid_start_from<true>(edge, i, m, inv, k, scale);
  };

  using group_walk::ballot;
  using group_walk::Path;
  using group_walk::path;
  using group_walk::reaches;
  int lo = 0;
  if (top64) {
    // Points t and t + 32 of the top round, by the lane's two warps at
    // once; the second leaves its ballot in shared memory and is done.
    const uint32_t half = ballot<G>(f((t + (second ? 32 : 0)) * sp) <= s);
    const int bar = 1 + li;  // a named barrier a lane, of its 64 threads
    if (second) {
      if (t == 0) upper[li] = half;
      asm volatile("bar.arrive %0, 64;\n" ::"r"(bar) : "memory");
      return;
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(bar) : "memory");
    const uint64_t up = half | (uint64_t)upper[li] << 32;
    const uint32_t lo_hit = ballot<G>(reaches(up, path<uint64_t>(t, 6)));
    const uint32_t hi_hit =
        ballot<G>(reaches(up, path<uint64_t>(t + 32, 6)));
    lo = (lo_hit ? __ffs(lo_hit) - 1 : 32 + __ffs(hi_hit) - 1) * sp;
  } else if (!full_round) {
    const uint32_t up = ballot<G>(t < np && f(t * sp) <= s);
    lo = (__ffs(ballot<G>(t < np &&
                          reaches(up, path<uint32_t>(t < np ? t : 0, p)))) -
          1) *
         sp;
  }
  int nf = full_round ? k : sp;
  if (!full_round) {
    const Path<uint32_t> mid_leaf = path<uint32_t>(t, LOG_G);
    for (; nf > G / 2; nf >>= LOG_G) {
      const int step = nf >> LOG_G;
      const uint32_t up = ballot<G>(f(lo + t * step) <= s);
      lo += (__ffs(ballot<G>(reaches(up, mid_leaf))) - 1) * step;
    }
  }
  // The last round: every point lo .. lo + nf + 1 (the rest of the group
  // idles), nf = 2^mb.
  const int mb = __ffs(nf) - 1;
  const bool has_a = t < nf, has_b = t >= 1 && t <= nf;
  const uint32_t v = t <= nf + 1 ? f(lo + t) : 0u;
  const uint32_t up = ballot<G>(v <= s);
  const int a =
      __ffs(ballot<G>(group_walk::answers(
          up, path<uint32_t>(has_a ? t : 0, mb), has_a,
          path<uint32_t>(has_b ? t - 1 : 0, mb), has_b, t))) -
      1;
  const uint32_t start = __shfl_sync(0xffffffffu, v, a, G);
  const uint32_t nxt = __shfl_sync(0xffffffffu, v, a + 1, G);
  if (live && t == 0) {
    idx_out[l] = lo + a;
    start_out[l] = (int32_t)start;
    freq_out[l] = (int32_t)(nxt - start);
  }
}

// The group for `lanes` lanes: the widest (the fewest rounds) while the
// card's issue rate keeps up with the points it evaluates in vain, 16
// above. On an H100 at lat_bits 10, 32 was faster up to 1024 lanes and 16
// from 1536 (chip_smoke.py phase 3 times either side of the threshold).
int group_for(int lanes) { return lanes <= 1024 ? 32 : 16; }

template <int G>
cudaError_t launch_group(const int32_t* slot, const float* mu,
                         const float* sigma, const float* edges,
                         int32_t* idx, int32_t* start, int32_t* freq,
                         int lanes, int lat_bits, int precision,
                         cudaStream_t stream) {
  constexpr int LB = THREADS / (G * Walk<G>::WPL);
  bucketize_kernel<G><<<(lanes + LB - 1) / LB, THREADS, 0, stream>>>(
      slot, mu, sigma, edges, idx, start, freq, lanes, lat_bits, precision);
  return cudaGetLastError();
}

}  // namespace

// Launcher, called by ../../ans/csrc/bindings.cpp. It is declared there
// with C++ linkage: a signature that drifts from this one leaves an
// undefined symbol, and the extension fails to load.
cudaError_t launch_bucketize(const int32_t* slot, const float* mu,
                             const float* sigma, const float* edges,
                             int32_t* idx, int32_t* start, int32_t* freq,
                             int lanes, int lat_bits, int precision,
                             cudaStream_t stream) {
  if (lanes == 0) return cudaSuccess;
  if (group_for(lanes) == 16)
    return launch_group<16>(slot, mu, sigma, edges, idx, start, freq,
                            lanes, lat_bits, precision, stream);
  return launch_group<32>(slot, mu, sigma, edges, idx, start, freq,
                          lanes, lat_bits, precision, stream);
}
