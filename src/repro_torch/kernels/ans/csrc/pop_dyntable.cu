// Multi-step rANS pop against a cumulative-starts table per step and
// lane: the CUDA port of repro/kernels/ans/kernel.py:196
// _pop_dyntable_kernel (pop_dyntable_emit).
//
// One thread per lane. Per step: slot = head & (2^p - 1); a branchless
// pass over the A+1 table entries gives sym = #(F <= slot) - 1,
// start = max F <= slot, next = min F > slot; then the state update and,
// when head < 2^16, one 16-bit read from the pre-gathered feed. The
// table (A+1 words per step and lane) dominates the bytes, so the kernel
// is bound by memory traffic. Tables are [steps, lanes, A+1]: lane l's
// row sits at (t*lanes + l)*(A+1), neighbouring threads A+1 words apart.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void pop_dyntable_kernel(const int64_t* __restrict__ head,
                                    const int32_t* __restrict__ tables,
                                    const int32_t* __restrict__ feed,
                                    int64_t* __restrict__ out_head,
                                    int32_t* __restrict__ syms,
                                    int32_t* __restrict__ reads,
                                    int steps, int lanes, int a1,
                                    int precision) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const uint32_t total = 1u << precision, mask = total - 1u;
  uint32_t h = (uint32_t)head[l];
  int r = 0;
  for (int t = 0; t < steps; ++t) {
    size_t o = (size_t)t * lanes + l;
    const int32_t* row = tables + o * a1;
    uint32_t slot = h & mask, start = 0u, nxt = total;
    int count = 0;
    for (int j = 0; j < a1; ++j) {
      uint32_t v = (uint32_t)row[j];
      bool le = v <= slot;
      count += le;
      start = le ? max(start, v) : start;
      nxt = le ? nxt : min(nxt, v);
    }
    syms[o] = count - 1;
    h = (nxt - start) * (h >> precision) + slot - start;
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
cudaError_t launch_pop_dyntable(const int64_t* head, const int32_t* tables,
                                const int32_t* feed, int64_t* out_head,
                                int32_t* syms, int32_t* reads, int steps,
                                int lanes, int a1, int precision,
                                cudaStream_t stream) {
  const int threads = 128;
  int blocks = (lanes + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  pop_dyntable_kernel<<<blocks, threads, 0, stream>>>(
      head, tables, feed, out_head, syms, reads, steps, lanes, a1,
      precision);
  return cudaGetLastError();
}
