// Grid starts for the push side: (idx, mu, sigma) -> (start = F(idx),
// freq = F(idx+1) - F(idx)) elementwise over [steps, lanes], for the
// gaussian (kind 1) and logistic (kind 2, sigma carries the scale) CDFs.
// Not a TPU kernel: the reference evaluates this in XLA
// (repro/codecs/compile.py:97-118 _push_grid_body, :357). On the card it
// must run the same CDF as the pop kernel (../../common/ndtr.cuh,
// ../../common/xla_math.cuh), or the encoder and decoder would disagree
// on a start and the stream would not decode. Two CDF evaluations per
// element: bound by operations.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ndtr.cuh"
#include "xla_math.cuh"

__global__ void grid_starts_kernel(const int32_t* __restrict__ idx,
                                   const float* __restrict__ mu,
                                   const float* __restrict__ sigma,
                                   const float* __restrict__ edges,
                                   int32_t* __restrict__ start,
                                   int32_t* __restrict__ freq, int n,
                                   int logistic, int lat_bits,
                                   int precision) {
  int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const int k = 1 << lat_bits;
  const float scale = (float)((1 << precision) - k);
  float m = mu[o], inv = __frcp_rn(sigma[o]);
  int i = idx[o];
  uint32_t s, e;
  if (logistic) {
    s = xla_math::logistic_start(edges, i, m, inv, k, scale);
    e = xla_math::logistic_start(edges, i + 1, m, inv, k, scale);
  } else {
    s = xla_ndtr::grid_start(edges, i, m, inv, k, scale);
    e = xla_ndtr::grid_start(edges, i + 1, m, inv, k, scale);
  }
  start[o] = (int32_t)s;
  freq[o] = (int32_t)(e - s);
}

// Launcher, called by bindings.cpp. It is declared there with C++ linkage:
// a signature that drifts from this one leaves an undefined symbol, and
// the extension fails to load.
cudaError_t launch_grid_starts(const int32_t* idx, const float* mu,
                               const float* sigma, const float* edges,
                               int32_t* start, int32_t* freq, int n,
                               int kind, int lat_bits, int precision,
                               cudaStream_t stream) {
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  if (kind != 1 && kind != 2) return cudaErrorInvalidValue;
  grid_starts_kernel<<<blocks, threads, 0, stream>>>(
      idx, mu, sigma, edges, start, freq, n, kind == 2, lat_bits,
      precision);
  return cudaGetLastError();
}
