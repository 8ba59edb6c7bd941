// Multi-step rANS pop against a cumulative-starts table per step and
// lane: the CUDA port of repro/kernels/ans/kernel.py:196
// _pop_dyntable_kernel (pop_dyntable_emit).
//
// Per step: slot = head & (2^p - 1); a branchless pass over the A+1 table
// entries gives sym = #(F <= slot) - 1, start = max F <= slot,
// next = min F > slot; then the state update and, when head < 2^16, one
// 16-bit read from the pre-gathered feed. Tables are [steps, lanes, A+1]
// and dominate the bytes, so the bound is the memory traffic. What stood
// in its way was each lane's serial chain: with one thread a lane, every
// step waited on A+1 global loads of its own row (12 bytes apart between
// neighbouring threads at A+1 = 3, so not coalesced, and nothing fetched
// them ahead): 0.49 ms for 4096 lanes x 784 steps on an H100, 32x the
// bound.
//
// Design, as push.cu's: a block owns LANES = 32 lanes and has two roles.
//  * HELPERS warps stage the block's rows for T steps at a time into
//    shared memory with coalesced cp.async (the rows of a block's lanes at
//    one step are contiguous, lanes x (A+1) words), STAGES tiles ahead of
//    the chain, a few copies a thread; they keep a ring of the next RING
//    feed rows there too, refilled as the lanes' reads move on; and they
//    write the walked tiles' symbols out, coalesced;
//  * one warp walks the chain, one lane a thread, reading only shared
//    memory and registers; it leaves each symbol in shared memory and
//    holds its next feed word in a register.
// T is 32 steps up to A+1 = 11 and 360 / (A+2) above (A+1 sets a
// stage's size), 1 step from A+1 = 180 (257 among them); tables wider
// than STAGED_A1 (359) words, whose stages would not fit the shared
// memory, take one thread a lane reading its rows from device memory
// (pop_dyntable_wide_kernel). The Bernoulli pixels' A+1 = 3 has an
// instance of its own, its loops unrolled. Blocks of 32 lanes spread
// 4096 lanes over 128 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int HELPERS = 4;
constexpr int THREADS = 32 * (1 + HELPERS);
constexpr int STAGES = 4;
constexpr int MAX_T = 32;
constexpr int STAGED_A1 = 359;
constexpr int SMEM_BUDGET = 180 * 1024;  // rows and symbols
constexpr int RING = 256;                // feed rows in shared memory

// Steps a tile at A+1 = a1: as many as STAGES tiles of rows and symbols
// hold in SMEM_BUDGET, at most MAX_T, at least 1.
__host__ __device__ constexpr int tile_steps(int a1) {
  return SMEM_BUDGET / (STAGES * LANES * (a1 + 1) * 4) >= MAX_T
             ? MAX_T
             : (SMEM_BUDGET / (STAGES * LANES * (a1 + 1) * 4) < 1
                    ? 1
                    : SMEM_BUDGET / (STAGES * LANES * (a1 + 1) * 4));
}

// Dynamic shared memory: the barriers, then [STAGES][T][LANES][A+1] rows
// (a tile's rows as they lie in device memory), [STAGES][T][LANES]
// symbols, the [RING][LANES] feed ring and, per stage, the chain's least
// read count after the tile and the feed rows the ring holds for it.
__host__ __device__ constexpr size_t smem_bytes(int a1) {
  return 2 * STAGES * sizeof(uint64_t) +
         (size_t)STAGES * tile_steps(a1) * LANES * (a1 + 1) * 4 +
         (size_t)RING * LANES * 4 + 2 * STAGES * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// One pop against `row` (a1 words): (sym, the new head before the read).
__device__ __forceinline__ uint32_t pop_row(const uint32_t* row, int a1,
                                            uint32_t h, int precision,
                                            int32_t* sym) {
  const uint32_t total = 1u << precision, slot = h & (total - 1u);
  uint32_t start = 0u, nxt = total;
  int count = 0;
  for (int j = 0; j < a1; ++j) {
    const uint32_t v = row[j];
    const bool le = v <= slot;
    count += le;
    start = le ? max(start, v) : start;
    nxt = le ? nxt : min(nxt, v);
  }
  *sym = count - 1;
  return (nxt - start) * (h >> precision) + slot - start;
}

// The same pop against N words in registers, the max and min taken as
// trees (the same values: both are associative), so that a step's chain
// is a few operations deep.
template <int N>
__device__ __forceinline__ uint32_t pop_vals(const uint32_t (&v)[N],
                                             uint32_t h, int precision,
                                             int32_t* sym) {
  const uint32_t total = 1u << precision, slot = h & (total - 1u);
  uint32_t lo[N], hi[N];
  int count = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool le = v[j] <= slot;
    count += le;
    lo[j] = le ? v[j] : 0u;
    hi[j] = le ? total : v[j];
  }
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int j = 0; j + w < N; j += 2 * w) {
      lo[j] = max(lo[j], lo[j + w]);
      hi[j] = min(hi[j], hi[j + w]);
    }
  *sym = count - 1;
  return (hi[0] - lo[0]) * (h >> precision) + slot - lo[0];
}

// A1: the table width when fixed at compile time (3), else 0 and a1.
template <int A1>
__global__ void __launch_bounds__(THREADS)
    pop_dyntable_kernel(const int64_t* __restrict__ head,
                        const int32_t* __restrict__ tables,
                        const int32_t* __restrict__ feed,
                        int64_t* __restrict__ out_head,
                        int32_t* __restrict__ syms,
                        int32_t* __restrict__ reads, int steps, int lanes,
                        int a1_rt, int precision) {
  const int a1 = A1 > 0 ? A1 : a1_rt;
  const int T = A1 > 0 ? tile_steps(A1) : tile_steps(a1);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + STAGES;
  uint32_t* rows = reinterpret_cast<uint32_t*>(empty + STAGES);
  int32_t* outs = reinterpret_cast<int32_t*>(rows) +
                  (size_t)STAGES * T * LANES * a1;
  uint32_t* ring = reinterpret_cast<uint32_t*>(outs) + STAGES * T * LANES;
  int* least = reinterpret_cast<int*>(ring + RING * LANES);
  int* held = least + STAGES;
  const size_t stage_rows = (size_t)T * LANES * a1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l0 = blockIdx.x * LANES;
  const int nl = min(LANES, lanes - l0);  // lanes of this block
  const int l = l0 + lane;
  const bool live = lane < nl;
  const int tiles = (steps + T - 1) / T;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], HELPERS);
      bar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp > 0) {
    // A helper. Tile j goes into stage j % STAGES once the chain has
    // walked tile j - STAGES and its symbols are out. The helpers copy a
    // tile's rows together, in chunks of 16 bytes where every step's rows
    // are 16-byte aligned, else of 4: chunk c of step tt by helper thread
    // (tt * chunks + c) % (32 HELPERS), a few copies a thread (a loop of
    // one copy a step in each thread took longer than the chain's walk of
    // the tile), one cp.async group a tile.
    const int hid = threadIdx.x - 32;
    const bool wide = reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&
                      (size_t)lanes * a1 % 4 == 0 && nl * a1 % 4 == 0;
    const int width = wide ? 4 : 1;  // words a chunk
    const int chunks = nl * a1 / width;
    // Feed rows, with the tables' chunks: row y of the block's lanes into
    // ring slot y % RING, once every lane has read past row y - RING.
    const bool fwide = reinterpret_cast<uintptr_t>(feed) % 16 == 0 &&
                       lanes % 4 == 0 && nl % 4 == 0;
    const int fwidth = fwide ? 4 : 1, fchunks = nl / fwidth;
    int filled = 0;  // feed rows issued into the ring
    auto refill = [&](int upto, int j) {
      upto = min(upto, steps);
      const int n = max(0, upto - filled) * fchunks;
      for (int e = hid; e < n; e += 32 * HELPERS) {
        const int y = filled + e / fchunks;
        const int w = (e - (y - filled) * fchunks) * fwidth;
        const int32_t* src = feed + (size_t)y * lanes + l0 + w;
        uint32_t* d = ring + (y % RING) * LANES + w;
        if (fwide)
          copy16(d, src);
        else
          copy4(d, src);
      }
      filled = max(filled, upto);
      if (hid == 0) held[j % STAGES] = filled;
    };
    auto issue = [&](int j) {
      uint32_t* dst = rows + (size_t)(j % STAGES) * stage_rows;
      const int n = min(T, steps - j * T) * chunks;
      for (int e = hid; e < n; e += 32 * HELPERS) {
        const int tt = e / chunks, w = (e - tt * chunks) * width;
        const int32_t* src =
            tables + ((size_t)(j * T + tt) * lanes + l0) * a1 + w;
        uint32_t* d = dst + (size_t)tt * LANES * a1 + w;
        if (wide)
          copy16(d, src);
        else
          copy4(d, src);
      }
    };
    // Waits for the chain's walk of tile j and writes its symbols out:
    // helper warp h - 1 the steps h - 1, h - 1 + HELPERS, ...
    auto flush = [&](int j) {
      const int s = j % STAGES;
      bar_wait(&empty[s], (j / STAGES) & 1);
      for (int tt = warp - 1; tt < T; tt += HELPERS) {
        const int t = j * T + tt;
        if (live && t < steps)
          syms[(size_t)t * lanes + l] =
              outs[((size_t)s * T + tt) * LANES + lane];
      }
    };
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < tiles) {
        refill(RING, j);
        issue(j);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int i = 0; i < tiles; ++i) {
      // All but the newest STAGES - 2 groups have landed: tile i has.
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
      __syncwarp();
      if (lane == 0) bar_arrive(&full[i % STAGES]);
      if (i > 0) flush(i - 1);
      // Stage (i - 1) % STAGES is free again: tile i + STAGES - 1 goes
      // there, with the feed rows that every lane's reads have freed.
      if (i + STAGES - 1 < tiles) {
        refill((i > 0 ? least[(i - 1) % STAGES] : 0) + RING,
               i + STAGES - 1);
        issue(i + STAGES - 1);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (tiles > 0) flush(tiles - 1);
    return;
  }

  // The chain: one lane a thread. A thread past the last lane walks its
  // neighbours' rows and stores nothing. The next read's feed word waits
  // in a register, and each step loads the one after it from the feed
  // ring before its pop (or, past the rows the ring holds, from device
  // memory when it reads): a load that the step itself waited for, or a
  // branch, was a large part of the chain's step.
  const int lc = live ? l : l0;
  uint32_t h = (uint32_t)head[lc];
  int r = 0, ready = 0;
  uint32_t fw = steps > 0 ? (uint32_t)feed[lc] : 0u;
  const auto ahead = [&]() {
    return ring[((unsigned)(r + 1) % RING) * LANES + lane];
  };
  size_t fo = (size_t)lanes + lc;  // feed row r + 1 of this lane
  const auto renorm = [&](uint32_t next) {
    const bool need = h < (1u << 16);
    h = need ? (h << 16) | fw : h;
    r += need;
    if (need && r >= ready && r < steps)  // a read past the ring
      next = (uint32_t)feed[fo];
    fw = need ? next : fw;
    fo += need ? lanes : 0;
  };
  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    bar_wait(&full[s], (i / STAGES) & 1);
    ready = held[s];
    const uint32_t* tile = rows + (size_t)s * stage_rows + lane * a1;
    int32_t* out = outs + (size_t)s * T * LANES + lane;
    const int n = min(T, steps - i * T);
    if (A1 > 0 && n == T) {
      // A whole tile, unrolled, the rows in registers one step ahead:
      // the loads of step tt + 1 are issued before step tt's chain.
      constexpr int N = A1 > 0 ? A1 : 1, TT = A1 > 0 ? tile_steps(A1) : 1;
      uint32_t cur[N], nxt[N];
#pragma unroll
      for (int c = 0; c < N; ++c) cur[c] = tile[c];
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        if (tt + 1 < TT) {
#pragma unroll
          for (int c = 0; c < N; ++c)
            nxt[c] = tile[(size_t)(tt + 1) * LANES * N + c];
        }
        const uint32_t next = ahead();
        int32_t sym;
        h = pop_vals<N>(cur, h, precision, &sym);
        out[tt * LANES] = sym;
        renorm(next);
#pragma unroll
        for (int c = 0; c < N; ++c) cur[c] = nxt[c];
      }
    } else {
      for (int tt = 0; tt < n; ++tt) {
        const uint32_t next = ahead();
        h = pop_row(tile + (size_t)tt * LANES * a1, a1, h, precision,
                    &out[tt * LANES]);
        renorm(next);
      }
    }
    const int rmin = __reduce_min_sync(0xffffffffu, live ? r : INT32_MAX);
    if (lane == 0) least[s] = rmin;
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }
  if (live) {
    out_head[l] = (int64_t)h;
    reads[l] = r;
  }
}

// Tables too wide to stage: one thread a lane, rows read from device
// memory.
__global__ void pop_dyntable_wide_kernel(const int64_t* __restrict__ head,
                                         const int32_t* __restrict__ tables,
                                         const int32_t* __restrict__ feed,
                                         int64_t* __restrict__ out_head,
                                         int32_t* __restrict__ syms,
                                         int32_t* __restrict__ reads,
                                         int steps, int lanes, int a1,
                                         int precision) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  uint32_t h = (uint32_t)head[l];
  int r = 0;
  for (int t = 0; t < steps; ++t) {
    size_t o = (size_t)t * lanes + l;
    h = pop_row(reinterpret_cast<const uint32_t*>(tables) + o * a1, a1, h,
                precision, &syms[o]);
    if (h < (1u << 16)) {
      h = (h << 16) | (uint32_t)feed[(size_t)r * lanes + l];
      ++r;
    }
  }
  out_head[l] = (int64_t)h;
  reads[l] = r;
}

template <int A1>
cudaError_t launch_staged(const int64_t* head, const int32_t* tables,
                          const int32_t* feed, int64_t* out_head,
                          int32_t* syms, int32_t* reads, int steps,
                          int lanes, int a1, int precision,
                          cudaStream_t stream) {
  // The attribute, once a card: the most any width of the instance
  // takes (smem_bytes grows to STAGED_A1).
  static bool sized[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !sized[dev]) {
    e = cudaFuncSetAttribute(
        pop_dyntable_kernel<A1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(A1 > 0 ? A1 : STAGED_A1));
    if (e != cudaSuccess) return e;
    if (dev < 64) sized[dev] = true;
  }
  const int smem = (int)smem_bytes(a1);
  const int blocks = (lanes + LANES - 1) / LANES;
  pop_dyntable_kernel<A1><<<blocks, THREADS, smem, stream>>>(
      head, tables, feed, out_head, syms, reads, steps, lanes, a1,
      precision);
  return cudaGetLastError();
}

}  // namespace

// Launcher, called by bindings.cpp. It is declared there with C++ linkage:
// a signature that drifts from this one leaves an undefined symbol, and
// the extension fails to load.
cudaError_t launch_pop_dyntable(const int64_t* head, const int32_t* tables,
                                const int32_t* feed, int64_t* out_head,
                                int32_t* syms, int32_t* reads, int steps,
                                int lanes, int a1, int precision,
                                cudaStream_t stream) {
  if (lanes == 0) return cudaSuccess;
  if (a1 == 3)
    return launch_staged<3>(head, tables, feed, out_head, syms, reads, steps,
                            lanes, a1, precision, stream);
  if (a1 <= STAGED_A1)
    return launch_staged<0>(head, tables, feed, out_head, syms, reads, steps,
                            lanes, a1, precision, stream);
  const int threads = 128;
  pop_dyntable_wide_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                             stream>>>(head, tables, feed, out_head, syms,
                                       reads, steps, lanes, a1, precision);
  return cudaGetLastError();
}
