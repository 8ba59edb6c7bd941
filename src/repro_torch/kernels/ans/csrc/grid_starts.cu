// Grid starts for the push side: (idx, mu, sigma) -> (start = F(idx),
// freq = F(idx+1) - F(idx)) elementwise over [steps, lanes], for the
// gaussian (kind 1) and logistic (kind 2, sigma carries the scale) CDFs.
// Not a TPU kernel: the reference evaluates this in XLA
// (repro/codecs/compile.py:97-118 _push_grid_body, :357). On the card it
// must run the same CDF as the pop kernel (../../common/ndtr.cuh,
// ../../common/xla_math.cuh), or the encoder and decoder would disagree
// on a start and the stream would not decode.
//
// Bound: two CDF evaluations an element, by operations. What a launch
// costs depends on its size, and the launcher picks a layout by it:
//
//   * Up to PAIR_MAX elements (two threads each fit on the card at once:
//     phase 12's 256 elements a latent, the VAE's 40 x 1024) a launch is
//     one thread's latency - loads, F, store - and F's IEEE reciprocals
//     and division branch, so one thread cannot overlap two evaluations.
//     So two threads take an element, one evaluation each: a warp takes
//     16 elements, lanes 0-15 F(idx) and lanes 16-31 F(idx + 1) of the
//     same ones (their loads of idx, mu and sigma are one request), and a
//     shuffle hands F(idx + 1) down for freq. Blocks of 128 threads spread
//     a small launch over several SMs, and each thread loads its edge
//     before the reciprocal of sigma, so the two latencies overlap.
//   * Above, the card is full and the evaluations' throughput counts: one
//     thread an element evaluates both F, sharing its loads and 1/sigma
//     (two threads an element were slower at 1024 x 784 and 4096 x 40).
//
// Skipping the CDF at the pinned ends (ndtr.cuh grid_start_from<true>)
// was slower for both kinds at every path shape, so neither takes it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ndtr.cuh"
#include "xla_math.cuh"

namespace {

constexpr int kGaussian = 1, kLogistic = 2;
constexpr int PAIR_THREADS = 128, ONE_THREADS = 256;
// The most elements the two-thread layout takes: 2 x PAIR_MAX threads are
// the H100's 132 SMs x 2048 resident threads.
constexpr int PAIR_MAX = 132 * 1024;

// Edge z_i of F(i), clamped to [0, K] as F clamps it.
__device__ __forceinline__ float edge_at(const float* edges, int i, int k) {
  return __ldg(edges + (i < 0 ? 0 : (i > k ? k : i)));
}

// F(i) of the CDF kind on its edge z, loaded ahead: the load is issued
// before 1/sigma, whose IEEE reciprocal branches, and not after it.
template <int KIND>
__device__ __forceinline__ unsigned cdf_start(float z, int i, float mu,
                                              float inv, int k,
                                              float scale) {
  const auto load = [z](int) { return z; };
  if constexpr (KIND == kLogistic)
    return xla_math::logistic_start_from(load, i, mu, inv, k, scale);
  else
    return xla_ndtr::grid_start_from(load, i, mu, inv, k, scale);
}

template <int KIND, bool PAIR>
__global__ void __launch_bounds__(PAIR ? PAIR_THREADS : ONE_THREADS)
    grid_starts_kernel(const int32_t* __restrict__ idx,
                       const float* __restrict__ mu,
                       const float* __restrict__ sigma,
                       const float* __restrict__ edges,
                       int32_t* __restrict__ start,
                       int32_t* __restrict__ freq, int n, int lat_bits,
                       int precision) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = 1 << lat_bits;
  const float scale = (float)((1 << precision) - k);
  if constexpr (PAIR) {
    const int up = (t >> 4) & 1;             // evaluates F(idx + 1)
    const int o = (t >> 5) * 16 + (t & 15);  // the element
    const bool live = o < n;
    unsigned f = 0;
    if (live) {
      const int i = __ldg(idx + o) + up;
      const float m = __ldg(mu + o), sg = __ldg(sigma + o);
      const float z = edge_at(edges, i, k);
      f = cdf_start<KIND>(z, i, m, __frcp_rn(sg), k, scale);
    }
    const unsigned next = __shfl_down_sync(0xffffffffu, f, 16);
    if (live && !up) {
      start[o] = (int32_t)f;
      freq[o] = (int32_t)(next - f);
    }
  } else {
    if (t >= n) return;
    const int i = __ldg(idx + t);
    const float m = __ldg(mu + t), sg = __ldg(sigma + t);
    const float z0 = edge_at(edges, i, k), z1 = edge_at(edges, i + 1, k);
    const float inv = __frcp_rn(sg);
    const unsigned s = cdf_start<KIND>(z0, i, m, inv, k, scale);
    const unsigned e = cdf_start<KIND>(z1, i + 1, m, inv, k, scale);
    start[t] = (int32_t)s;
    freq[t] = (int32_t)(e - s);
  }
}

template <int KIND>
cudaError_t launch_kind(const int32_t* idx, const float* mu,
                        const float* sigma, const float* edges,
                        int32_t* start, int32_t* freq, int n, int lat_bits,
                        int precision, cudaStream_t stream) {
  if (n <= PAIR_MAX) {
    const int threads = (n + 15) / 16 * 32;
    grid_starts_kernel<KIND, true>
        <<<(threads + PAIR_THREADS - 1) / PAIR_THREADS, PAIR_THREADS, 0,
           stream>>>(idx, mu, sigma, edges, start, freq, n, lat_bits,
                     precision);
  } else {
    grid_starts_kernel<KIND, false>
        <<<(n + ONE_THREADS - 1) / ONE_THREADS, ONE_THREADS, 0, stream>>>(
            idx, mu, sigma, edges, start, freq, n, lat_bits, precision);
  }
  return cudaGetLastError();
}

}  // namespace

// Launcher, called by bindings.cpp. It is declared there with C++ linkage:
// a signature that drifts from this one leaves an undefined symbol, and
// the extension fails to load.
cudaError_t launch_grid_starts(const int32_t* idx, const float* mu,
                               const float* sigma, const float* edges,
                               int32_t* start, int32_t* freq, int n,
                               int kind, int lat_bits, int precision,
                               cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (kind == kGaussian)
    return launch_kind<kGaussian>(idx, mu, sigma, edges, start, freq, n,
                                  lat_bits, precision, stream);
  if (kind == kLogistic)
    return launch_kind<kLogistic>(idx, mu, sigma, edges, start, freq, n,
                                  lat_bits, precision, stream);
  return cudaErrorInvalidValue;
}
