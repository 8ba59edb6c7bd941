// Multi-step rANS pop against one static cumulative-starts table per
// lane: the CUDA port of repro/kernels/ans/kernel.py:120 _pop_table_kernel
// (pop_table_emit), the decode of a static-table Categorical stream block.
//
// One thread per lane, the step loop inside the thread. Per step:
// slot = head & (2^p - 1); an upper-bound binary search over the lane's
// A+1 starts finds idx, the first entry above slot; then sym = idx - 1,
// start = F[idx-1] (0 when idx = 0) and next = F[idx] (2^p when
// idx = A+1). On a non-decreasing table (every cumulative table is) this
// is the reference's branchless result: sym = #(F <= slot) - 1,
// start = max F <= slot, next = min F > slot, also where equal starts
// (zero-frequency symbols) repeat, since the upper bound passes all of
// them. An all-zero row (a padded lane) gives idx = A+1 and reads only
// inside the row. Then the state update and, when head < 2^16, one 16-bit
// read from the pre-gathered feed.
//
// The table is [lanes, A+1] and read from global memory through L1: at
// byte alphabets a row is 1 KiB, and 128 rows do not fit a block's
// shared memory. Each step touches about log2(A+1) words of the row.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void pop_table_kernel(const int64_t* __restrict__ head,
                                 const int32_t* __restrict__ table,
                                 const int32_t* __restrict__ feed,
                                 int64_t* __restrict__ out_head,
                                 int32_t* __restrict__ syms,
                                 int32_t* __restrict__ reads, int steps,
                                 int lanes, int a1, int precision) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const uint32_t total = 1u << precision, mask = total - 1u;
  const int32_t* row = table + (size_t)l * a1;
  uint32_t h = (uint32_t)head[l];
  int r = 0;
  for (int t = 0; t < steps; ++t) {
    uint32_t slot = h & mask;
    int lo = 0, hi = a1;  // upper bound: first j with row[j] > slot
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if ((uint32_t)__ldg(row + mid) <= slot) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    uint32_t start = lo > 0 ? (uint32_t)__ldg(row + lo - 1) : 0u;
    uint32_t nxt = lo < a1 ? (uint32_t)__ldg(row + lo) : total;
    syms[(size_t)t * lanes + l] = lo - 1;
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
cudaError_t launch_pop_table(const int64_t* head, const int32_t* table,
                             const int32_t* feed, int64_t* out_head,
                             int32_t* syms, int32_t* reads, int steps,
                             int lanes, int a1, int precision,
                             cudaStream_t stream) {
  const int threads = 128;
  int blocks = (lanes + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  pop_table_kernel<<<blocks, threads, 0, stream>>>(
      head, table, feed, out_head, syms, reads, steps, lanes, a1, precision);
  return cudaGetLastError();
}
