// Fused bucketize + rANS pop over the max-entropy N(0,1) bucket grid:
// the CUDA port of repro/kernels/ans/kernel.py:266 _pop_grid_kernel
// (pop_grid_emit), kinds "gaussian", "logistic" and "uniform".
//
// One thread per lane, the step loop inside the thread. Gaussian and
// logistic: per step a (lat_bits+1)-step bisection for the largest i with
// F(i) <= slot, where F is the fixed-point CDF (ndtr of
// ../../common/ndtr.cuh, or XLA's sigmoid of ../../common/xla_math.cuh for
// the logistic), then F(idx) and F(idx+1) for the state update; that is
// lat_bits+3 CDF evaluations per step (about 100 flops each for ndtr, 28
// for the sigmoid), so the kernel is bound by operations, not bytes. The
// K+1 bucket edges sit in shared memory, read by every evaluation.
// Uniform: a shift, no CDF. Then the masked 16-bit read from the
// pre-gathered feed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ndtr.cuh"
#include "xla_math.cuh"

// Grid kinds, as bindings.cpp passes them.
enum GridKind { kUniform = 0, kGaussian = 1, kLogistic = 2 };

// F(i) of the CDF kind (gaussian or logistic).
__device__ __forceinline__ uint32_t cdf_start(int kind, const float* edges,
                                              int i, float mu, float inv,
                                              int k, float scale) {
  return kind == kLogistic
             ? xla_math::logistic_start(edges, i, mu, inv, k, scale)
             : xla_ndtr::grid_start(edges, i, mu, inv, k, scale);
}

__global__ void pop_grid_kernel(const int64_t* __restrict__ head,
                                const float* __restrict__ mu,
                                const float* __restrict__ sigma,
                                const int32_t* __restrict__ feed,
                                const float* __restrict__ edges,
                                int64_t* __restrict__ out_head,
                                int32_t* __restrict__ idx_out,
                                int32_t* __restrict__ reads,
                                int steps, int lanes, int kind,
                                int lat_bits, int precision) {
  extern __shared__ float s_edges[];
  const int k = 1 << lat_bits;
  if (kind != kUniform) {
    for (int i = threadIdx.x; i <= k; i += blockDim.x) s_edges[i] = edges[i];
    __syncthreads();
  }
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const uint32_t mask = (1u << precision) - 1u;
  const int shift = precision - lat_bits;
  const float scale = (float)((1 << precision) - k);
  uint32_t h = (uint32_t)head[l];
  int r = 0;
  for (int t = 0; t < steps; ++t) {
    size_t o = (size_t)t * lanes + l;
    uint32_t slot = h & mask, start, freq;
    int idx;
    if (kind != kUniform) {
      float m = mu[o], inv = __frcp_rn(sigma[o]);
      int lo = 0, hi = k;
      for (int b = 0; b <= lat_bits; ++b) {
        int mid = (lo + hi + 1) >> 1;
        bool up = cdf_start(kind, s_edges, mid, m, inv, k, scale) <= slot;
        lo = up ? mid : lo;
        hi = up ? hi : mid;
      }
      idx = lo;
      start = cdf_start(kind, s_edges, idx, m, inv, k, scale);
      freq = cdf_start(kind, s_edges, idx + 1, m, inv, k, scale) - start;
    } else {
      idx = (int)(slot >> shift);
      start = (uint32_t)idx << shift;
      freq = 1u << shift;
    }
    idx_out[o] = idx;
    h = freq * (h >> precision) + slot - start;
    if (h < (1u << 16)) {
      h = (h << 16) | (uint32_t)feed[(size_t)r * lanes + l];
      ++r;
    }
  }
  out_head[l] = (int64_t)h;
  reads[l] = r;
}

// Launcher, called by bindings.cpp. It is declared there with C++ linkage:
// a signature that drifts from this one leaves an undefined symbol, and
// the extension fails to load.
cudaError_t launch_pop_grid(const int64_t* head, const float* mu,
                            const float* sigma, const int32_t* feed,
                            const float* edges, int64_t* out_head,
                            int32_t* idx, int32_t* reads, int steps,
                            int lanes, int kind, int lat_bits,
                            int precision, cudaStream_t stream) {
  const int threads = 128;
  int blocks = (lanes + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  if (kind < kUniform || kind > kLogistic) return cudaErrorInvalidValue;
  size_t smem =
      kind != kUniform ? (size_t)((1 << lat_bits) + 1) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pop_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  pop_grid_kernel<<<blocks, threads, smem, stream>>>(
      head, mu, sigma, feed, edges, out_head, idx, reads, steps, lanes,
      kind, lat_bits, precision);
  return cudaGetLastError();
}
