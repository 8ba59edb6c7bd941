// Posterior-decode bucketize over the max-entropy N(0,1) bucket grid: the
// CUDA port of repro/kernels/bucketize/kernel.py:37 _bucketize_kernel.
//
// Per lane, idx = max{i : F(i) <= slot} for the fixed-point Gaussian CDF
// F(i) = floor(ndtr((z_i - mu) * (1/sigma)) * (2^p - K)) + i (F(0) = 0,
// F(K) = 2^p), then (idx, F(idx), F(idx+1) - F(idx)). F is
// xla_ndtr::grid_start of ../../common/ndtr.cuh (XLA-CPU's float32 ndtr op
// for op, the clamps after the ndtr) and the bisection is
// ../../common/bisect.cuh: the very code the gaussian kind of
// ../../ans/csrc/pop_grid.cu runs, so both decode the same buckets.
//
// One thread per lane, any lane count (the Pallas kernel pads to 128-lane
// tiles; nothing here needs tiles). The K+1 edges (4.1 KB at lat_bits 10,
// 16.4 KB at 12) are staged in shared memory by each block. lat_bits + 3
// CDF evaluations of about 100 flops each per lane against 24 bytes in and
// out: bound by operations. One launch decodes one latent position of
// every lane, so on the HVAE's path the launches, not the arithmetic, set
// the time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bisect.cuh"
#include "ndtr.cuh"

__global__ void bucketize_kernel(const int32_t* __restrict__ slot,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ sigma,
                                 const float* __restrict__ edges,
                                 int32_t* __restrict__ idx_out,
                                 int32_t* __restrict__ start_out,
                                 int32_t* __restrict__ freq_out, int lanes,
                                 int lat_bits, int precision) {
  extern __shared__ float s_edges[];
  const int k = 1 << lat_bits;
  for (int i = threadIdx.x; i <= k; i += blockDim.x) s_edges[i] = edges[i];
  __syncthreads();
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const float scale = (float)((1 << precision) - k);
  const float m = mu[l], inv = __frcp_rn(sigma[l]);
  auto f = [&](int i) {
    return xla_ndtr::grid_start(s_edges, i, m, inv, k, scale);
  };
  int idx = grid_bisect(f, (uint32_t)slot[l], lat_bits);
  uint32_t start = f(idx);
  idx_out[l] = idx;
  start_out[l] = (int32_t)start;
  freq_out[l] = (int32_t)(f(idx + 1) - start);
}

// Launcher, called by ../../ans/csrc/bindings.cpp. It is declared there
// with C++ linkage: a signature that drifts from this one leaves an
// undefined symbol, and the extension fails to load.
cudaError_t launch_bucketize(const int32_t* slot, const float* mu,
                             const float* sigma, const float* edges,
                             int32_t* idx, int32_t* start, int32_t* freq,
                             int lanes, int lat_bits, int precision,
                             cudaStream_t stream) {
  const int threads = 128;
  int blocks = (lanes + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  size_t smem = (size_t)((1 << lat_bits) + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bucketize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  bucketize_kernel<<<blocks, threads, smem, stream>>>(
      slot, mu, sigma, edges, idx, start, freq, lanes, lat_bits, precision);
  return cudaGetLastError();
}
