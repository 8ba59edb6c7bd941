// Multi-step rANS pop against one static cumulative-starts table per
// lane: the CUDA port of repro/kernels/ans/kernel.py:120 _pop_table_kernel
// (pop_table_emit), the decode of a static-table Categorical stream block.
//
// Per step: slot = head & (2^p - 1); c = #(F <= slot), sym = c - 1,
// start = F[c - 1] (0 when c = 0) and next = F[c] (2^p when c = A+1). On
// a non-decreasing row (every cumulative table is; an all-zero padded row
// gives c = A+1) this is the reference's branchless result: start =
// max F <= slot, next = min F > slot, also where equal starts
// (zero-frequency symbols) repeat. Then the state update and, when
// head < 2^16, one 16-bit read from the pre-gathered feed.
//
// What bounds it on an H100: the row is read once (1 KiB a lane at 257
// entries, 4.2 MB at 4096 lanes: 1.3 us at the HBM rate), but each step
// waits on the last, so the time is steps x the step's latency unless
// the card is full. One thread a lane walked a 9-probe binary search of
// dependent global loads a step, on 32 of the 132 SMs, each probe of a
// warp touching 32 rows (0.0675 ms for 4096 lanes x 64 steps, 39x the
// bound, on an H100 80GB HBM3 at 700 W).
//
// Design: a group of G threads (8, 16 or 32) walks a lane's row, G
// entries a round. Monotone entries make the count a ballot's popcount:
// a round probes G entries spaced by the interval's width / G, and
// popc(ballot(F <= slot)) - 1 names the sub-interval that holds c. The
// last round (the window) reads G consecutive entries from the interval's
// start, so c - 1 and c are among them and start, next come by shuffles.
// The rows are staged into shared memory once, with coalesced cp.async,
// and the top round's G probes (slot-free) sit in registers. Width bands
// (m entries walked, the launcher's choice by A+1 and lane count):
//  * A+1 <= G - 1: the window alone, the whole row in registers (one
//    entry a thread): G = 8 up to 7 entries, 16 up to 15, 32 up to 31;
//  * 32 .. 992 (257 among them), G = 32: the top round, then the window
//    from shared memory; above NARROW_LANES lanes, rows of 57 to 448
//    entries take G = 8 and a probe round between: with a group of 32,
//    4096 lanes are 4096 warps whose steps wait on the card's issue
//    rate, while 1024 warps of 8 wait only on a step's latency, one
//    round longer. The 32-group's time steps up every 528 lanes (one
//    block of 4 lanes more on each of the H100's 132 SMs); up to five
//    such blocks an SM (2640 lanes) it beats the 8-group, from the sixth
//    on it loses (tools/time_variants.py times both groups at 57, 257
//    and 448 entries from 1024 to 4096 lanes; chip_smoke.py the
//    launcher at 2640 and 2641);
//  * 993 .. STAGED_A1 (4097): top, one probe round, window;
//  * wider (up to 2^16 at precision 16): the row does not fit shared
//    memory, so every SAMPLE-th entry is staged and walked as above; the
//    walk names a block of SAMPLE entries, and one last window reads them
//    from device memory (L1/L2).
// The feed rows of a block's lanes are staged too, in a ring in shared
// memory, a tile ahead of the chain; each step loads the next read's word
// at its top, so the read itself waits on nothing. A lane that falls more
// than the ring behind reads from device memory. Symbols go to shared
// memory and out a tile at a time, coalesced. Blocks of 128 threads: 4
// lanes at G = 32, 16 at G = 8.
// twin.py table_group_walk is this walk in Python.
#include <cuda_runtime.h>
#include <stdint.h>

#include "group_walk.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int T = 32;            // steps a tile of symbols
constexpr int RING = 128;        // feed rows in shared memory (power of 2)
constexpr int STAGED_A1 = 4097;  // widest row staged whole
constexpr int SAMPLE = 16;       // stride of the staged sample above it
// More lanes narrow the group (above). tools/time_variants.py builds this
// file with POP_TABLE_NARROW_LANES set to 0 and to 2^30, to time both
// groups at one shape.
#ifndef POP_TABLE_NARROW_LANES
#define POP_TABLE_NARROW_LANES 2640
#endif
constexpr int NARROW_LANES = POP_TABLE_NARROW_LANES;
constexpr uint32_t FULL = 0xffffffffu;

// The rounds of a walk over m entries: the window alone, the top round
// and the window, or top, probe and window.
enum Walk { kWindow = 0, kTop = 1, kProbe = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Dynamic shared memory: [LB][m] staged rows (or samples), the
// [RING][LB] feed ring and [T][LB] symbols.
__host__ __device__ constexpr size_t smem_bytes(int lb, int m) {
  return ((size_t)lb * m + (size_t)RING * lb + (size_t)T * lb) * 4;
}

// m entries walked: the row, or its sample.
__host__ __device__ constexpr int walked(int a1) {
  return a1 <= STAGED_A1 ? a1 : (a1 + SAMPLE - 1) / SAMPLE;
}

template <int G, int WALK, bool WIDE>
__global__ void __launch_bounds__(THREADS)
    pop_table_kernel(const int64_t* __restrict__ head,
                     const int32_t* __restrict__ table,
                     const int32_t* __restrict__ feed,
                     int64_t* __restrict__ out_head,
                     int32_t* __restrict__ syms,
                     int32_t* __restrict__ reads, int steps, int lanes,
                     int a1, int precision) {
  constexpr int LB = THREADS / G;  // lanes a block
  const int m = walked(a1);
  const int s0 = (m + G - 1) / G;   // top stride
  const int s1 = (s0 + G - 1) / G;  // probe stride
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* rows = smem;
  uint32_t* ring = rows + (size_t)LB * m;  // LB * m is a multiple of 4
  int32_t* outs = reinterpret_cast<int32_t*>(ring + RING * LB);
  const int l0 = blockIdx.x * LB;
  const int nl = min(LB, lanes - l0);  // lanes of this block

  // The block's rows (whole: contiguous in device memory, as in shared;
  // else every SAMPLE-th entry).
  if (!WIDE) {
    const int n = nl * a1;
    const int32_t* src = table + (size_t)l0 * a1;
    const int nv = reinterpret_cast<uintptr_t>(src) % 16 == 0 ? n / 4 : 0;
    for (int e = threadIdx.x; e < nv; e += THREADS)
      copy16(rows + 4 * e, src + 4 * e);
    for (int e = 4 * nv + threadIdx.x; e < n; e += THREADS)
      copy4(rows + e, src + e);
  } else {
    for (int e = threadIdx.x; e < nl * m; e += THREADS) {
      const int li = e / m, k = e - li * m;
      copy4(rows + e, table + (size_t)(l0 + li) * a1 + (size_t)k * SAMPLE);
    }
  }
  // Feed rows [y0, y1) of the block's lanes, row y into ring slot
  // y % RING: 16-byte chunks when the block is whole and aligned.
  const bool fvec = nl == LB && lanes % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(feed) % 16 == 0;
  const auto stage_feed = [&](int y0, int y1) {
    if (fvec) {
      constexpr int C = LB / 4;  // chunks a row
      for (int e = threadIdx.x; e < (y1 - y0) * C; e += THREADS) {
        const int y = y0 + e / C, c = (e % C) * 4;
        copy16(ring + (y & (RING - 1)) * LB + c,
               feed + (size_t)y * lanes + l0 + c);
      }
    } else {
      for (int e = threadIdx.x; e < (y1 - y0) * nl; e += THREADS) {
        const int y = y0 + e / nl, li = e % nl;
        copy4(ring + (y & (RING - 1)) * LB + li,
              feed + (size_t)y * lanes + l0 + li);
      }
    }
  };
  int filled = min(steps, RING);  // feed rows issued into the ring
  stage_feed(0, filled);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Thread t of the G of lane l; a group past the last lane walks lane
  // l0 and stores nothing.
  using group_walk::ballot;
  const int t = threadIdx.x & (G - 1);
  const int li = threadIdx.x / G;
  const int l = l0 + li;
  const bool live = li < nl;
  const int lr = live ? li : 0, lc = l0 + lr;
  const uint32_t* S = rows + (size_t)lr * m;
  const int32_t* row = table + (size_t)lc * a1;
  const uint32_t total = 1u << precision, mask = total - 1u;
  // The window's entry (kWindow) or the top round's probe of this thread.
  const int p_reg = WALK == kWindow ? t : t * s0;
  const uint32_t reg = p_reg < m ? S[p_reg] : total;

  uint32_t h = (uint32_t)head[lc];
  int r = 0;
  // The next read's word waits in a register; each step loads the one
  // after it first.
  uint32_t fw = steps > 0 ? ring[lr] : 0u;
  const int tiles = (steps + T - 1) / T;
  for (int j = 0; j < tiles; ++j) {
    // The rows tile j + 1 may read (r + 1 <= its last step + 1), one
    // tile ahead; rows below `held` have left the ring.
    const int want = min(steps, (j + 2) * T + 1);
    if (want > filled) {
      stage_feed(filled, want);
      filled = want;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int held = filled - RING;
    const int n = min(T, steps - j * T);
    int32_t* out = outs + li;
    const auto walk = [&](auto in_ring) {
      for (int tt = 0; tt < n; ++tt) {
        const int y = r + 1;
        uint32_t next;
        if (decltype(in_ring)::value || y >= held)
          next = ring[(y & (RING - 1)) * LB + lr];
        else
          next = (uint32_t)__ldg(feed + (size_t)min(y, steps - 1) * lanes +
                                 lc);
        const uint32_t slot = h & mask;
        int lo = 0;
        uint32_t v = reg;
        if constexpr (WALK != kWindow) {
          lo = max(__popc(ballot<G>(reg <= slot)) - 1, 0) * s0;
          if constexpr (WALK == kProbe) {
            const int p = lo + t * s1;
            const uint32_t u = p < m ? S[p] : total;
            lo += max(__popc(ballot<G>(u <= slot)) - 1, 0) * s1;
          }
          v = lo + t < m ? S[lo + t] : total;
        }
        int cnt = __popc(ballot<G>(v <= slot));
        if constexpr (WIDE) {
          lo = max(lo + cnt - 1, 0) * SAMPLE;
          v = lo + t < a1 ? (uint32_t)__ldg(row + lo + t) : total;
          cnt = __popc(ballot<G>(v <= slot));
        }
        const uint32_t below = __shfl_sync(FULL, v, max(cnt - 1, 0), G);
        const uint32_t nxt = __shfl_sync(FULL, v, cnt, G);
        const uint32_t start = cnt > 0 ? below : 0u;
        if (t == 0) out[tt * LB] = lo + cnt - 1;
        h = (nxt - start) * (h >> precision) + slot - start;
        const bool need = h < (1u << 16);
        h = need ? (h << 16) | fw : h;
        fw = need ? next : fw;
        r += need;
      }
    };
    // Warp-uniform: every read of this tile is in the ring.
    if (__all_sync(FULL, r + 1 >= held))
      walk(Flag<true>());
    else
      walk(Flag<false>());
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int e = threadIdx.x; e < n * LB; e += THREADS) {
      const int i = e % LB;
      if (i < nl)
        syms[(size_t)(j * T + e / LB) * lanes + l0 + i] = outs[e];
    }
    __syncthreads();
  }
  if (live && t == 0) {
    out_head[l] = (int64_t)h;
    reads[l] = r;
  }
}

template <int G, int WALK, bool WIDE>
cudaError_t launch_walk(const int64_t* head, const int32_t* table,
                        const int32_t* feed, int64_t* out_head,
                        int32_t* syms, int32_t* reads, int steps, int lanes,
                        int a1, int precision, cudaStream_t stream) {
  constexpr int LB = THREADS / G;
  const size_t smem = smem_bytes(LB, walked(a1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pop_table_kernel<G, WALK, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  pop_table_kernel<G, WALK, WIDE><<<(lanes + LB - 1) / LB, THREADS, smem,
                                    stream>>>(
      head, table, feed, out_head, syms, reads, steps, lanes, a1,
      precision);
  return cudaGetLastError();
}

}  // namespace

// Launcher, called by bindings.cpp. It is declared there with C++ linkage:
// a signature that drifts from this one leaves an undefined symbol, and
// the extension fails to load. 0 <= a1 <= 2^16 (bindings.cpp refuses
// wider rows: their samples would not fit shared memory).
cudaError_t launch_pop_table(const int64_t* head, const int32_t* table,
                             const int32_t* feed, int64_t* out_head,
                             int32_t* syms, int32_t* reads, int steps,
                             int lanes, int a1, int precision,
                             cudaStream_t stream) {
  if (lanes == 0) return cudaSuccess;
#define POP_TABLE(G, WALK, WIDE)                                            \
  return launch_walk<G, WALK, WIDE>(head, table, feed, out_head, syms,     \
                                    reads, steps, lanes, a1, precision,    \
                                    stream)
  if (a1 <= 7) POP_TABLE(8, kWindow, false);
  if (a1 <= 15) POP_TABLE(16, kWindow, false);
  if (a1 <= 31) POP_TABLE(32, kWindow, false);
  if (a1 > 7 * 8 && a1 <= 7 * 8 * 8 && lanes > NARROW_LANES)
    POP_TABLE(8, kProbe, false);
  if (a1 <= 31 * 32) POP_TABLE(32, kTop, false);
  if (a1 <= STAGED_A1) POP_TABLE(32, kProbe, false);
  if (walked(a1) <= 31 * 32) POP_TABLE(32, kTop, true);
  POP_TABLE(32, kProbe, true);
#undef POP_TABLE
}
