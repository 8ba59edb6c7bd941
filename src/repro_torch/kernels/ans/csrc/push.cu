// rANS push, `steps` symbols per lane: the CUDA port of
// repro/kernels/ans/kernel.py:35 _push_kernel (push_emit).
//
// One thread per lane; the head stays in a register for the whole step
// loop, as it stays in VMEM on the TPU. Per step and lane the kernel reads
// start and freq and writes a chunk and a need flag (16 bytes), so it is
// bound by memory traffic; the uint32 divide is the only costly ALU op.
// Loads and stores are coalesced: lane l of step t sits at t*lanes + l.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void push_kernel(const int64_t* __restrict__ head,
                            const int32_t* __restrict__ starts,
                            const int32_t* __restrict__ freqs,
                            int64_t* __restrict__ out_head,
                            int32_t* __restrict__ chunks,
                            int32_t* __restrict__ need,
                            int steps, int lanes, int precision) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  uint32_t h = (uint32_t)head[l];
  for (int t = 0; t < steps; ++t) {
    size_t o = (size_t)t * lanes + l;
    uint32_t start = (uint32_t)starts[o], freq = (uint32_t)freqs[o];
    uint32_t n = h >= (freq << (32 - precision));
    chunks[o] = n ? (int32_t)(h & 0xFFFFu) : 0;
    need[o] = (int32_t)n;
    if (n) h >>= 16;
    h = ((h / freq) << precision) + (h % freq) + start;
  }
  out_head[l] = (int64_t)h;
}

// Launcher, called by bindings.cpp. It is declared there with C++ linkage:
// a signature that drifts from this one leaves an undefined symbol, and
// the extension fails to load.
cudaError_t launch_push(const int64_t* head, const int32_t* starts,
                        const int32_t* freqs, int64_t* out_head,
                        int32_t* chunks, int32_t* need, int steps, int lanes,
                        int precision, cudaStream_t stream) {
  const int threads = 128;
  int blocks = (lanes + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  push_kernel<<<blocks, threads, 0, stream>>>(head, starts, freqs, out_head,
                                              chunks, need, steps, lanes,
                                              precision);
  return cudaGetLastError();
}
