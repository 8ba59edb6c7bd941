// The decode slot of every lane, slot = head & (2^p - 1): the CUDA port of
// repro/kernels/ans/kernel.py:92 _peek_kernel (pop_slots). One thread per
// lane; 8 bytes read and 4 written per lane, so it is bound by memory
// traffic, or at small lane counts by the launch itself.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void peek_kernel(const int64_t* __restrict__ head,
                            int32_t* __restrict__ slots, int lanes,
                            uint32_t mask) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < lanes) slots[l] = (int32_t)((uint32_t)head[l] & mask);
}

// Launcher, called by bindings.cpp (declared there with C++ linkage).
cudaError_t launch_peek(const int64_t* head, int32_t* slots, int lanes,
                        int precision, cudaStream_t stream) {
  const int threads = 128;
  int blocks = (lanes + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  peek_kernel<<<blocks, threads, 0, stream>>>(head, slots, lanes,
                                              (1u << precision) - 1u);
  return cudaGetLastError();
}
