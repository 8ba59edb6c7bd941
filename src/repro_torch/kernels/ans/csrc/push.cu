// rANS push, `steps` symbols per lane: the CUDA port of
// repro/kernels/ans/kernel.py:35 _push_kernel (push_emit).
//
// Per step and lane: n = h >= freq << (32 - precision) (the shift wraps
// to 0 at freq = 2^precision, and then every step renormalizes); the
// chunk h & 0xFFFF and the flag n are written, h >>= 16 when n, and
// h = ((h / freq) << precision) + h % freq + start, all in uint32.
//
// Bound: 16 bytes a step and lane (start and freq read, chunk and need
// written) over the card's memory rate. What stood in the way was the
// serial chain of each lane: a step waited on its two loads and on an
// emulated uint32 divide. Here a block owns LANES = 32 lanes and has two
// roles:
//  * HELPERS warps stage tiles of T steps x 32 lanes of starts and freqs
//    into shared memory with cp.async, STAGES tiles ahead of the chain,
//    for each staged freq compute m = ceil(2^64 / freq) (none for freq
//    1), which does not depend on the head, and write the walked tiles'
//    chunks and flags out;
//  * one warp walks the chain, one lane a thread, touching only shared
//    memory: x = the renormalized head, q = floor(x * m / 2^64) from two
//    32-bit multiplies, and h = q (2^precision - freq) + x a + start with
//    a = 1, which is (q << precision) + x - q freq + start; for freq 1,
//    m = 0 and a = 2^precision, which is the quotient x with remainder 0.
// q is exact for every x < 2^32 and 2 <= freq <= 2^16: m freq = 2^64 + e
// with e < freq, so x m / 2^64 = x / freq + x e / (freq 2^64), and the
// added term is below 1 / freq (x e < 2^48), less than the distance from
// x / freq to the next integer. ../twin.py divmod_by_reciprocal mirrors
// this arithmetic and tests/test_torch_kernels_ans.py checks it against
// // and % over every freq. The chain leaves need << 16 | chunk in shared
// memory; its own global stores had cost as much as the rest of its walk.
// Stores stay coalesced: lane l of step t sits at t * lanes + l. Blocks of
// 32 lanes spread 4096 lanes over 128 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int HELPERS = 8;
constexpr int T = 32;  // steps a tile
constexpr int STAGES = 4;
constexpr int THREADS = 32 * (1 + HELPERS);

struct Smem {
  uint32_t start[STAGES][T][LANES];
  uint32_t freq[STAGES][T][LANES];
  uint2 rcp[STAGES][T][LANES];  // (low, high) words of m
  uint32_t out[STAGES][T][LANES];  // need << 16 | chunk, from the chain
  uint64_t full[STAGES];        // staged and divided: one arrival a helper
  uint64_t empty[STAGES];       // walked by the chain: one arrival
};

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

// 4 bytes from `src` into `dst`, or zeros when `ok` is false.
__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// m = ceil(2^64 / d) as (low, high) words, for 2 <= d <= 2^16; 0 for
// d <= 1. With 2^32 = q1 d + r1 (r1 < d): 2^64 = d (q1 2^32 + r1 q1) +
// r1^2, and r1^2 < 2^32.
__device__ __forceinline__ uint2 reciprocal(uint32_t d) {
  if (d <= 1) return make_uint2(0u, 0u);
  uint32_t q1 = 0xFFFFFFFFu / d;
  uint32_t r1 = 0xFFFFFFFFu - q1 * d + 1u;
  if (r1 == d) {
    q1 += 1u;
    r1 = 0u;
  }
  const uint32_t rr = r1 * r1;
  const uint64_t m = ((uint64_t)q1 << 32) + (uint64_t)r1 * q1 + rr / d +
                     (rr % d != 0u);
  return make_uint2((uint32_t)m, (uint32_t)(m >> 32));
}

__global__ void __launch_bounds__(THREADS)
    push_kernel(const int64_t* __restrict__ head,
                const int32_t* __restrict__ starts,
                const int32_t* __restrict__ freqs,
                int64_t* __restrict__ out_head, int32_t* __restrict__ chunks,
                int32_t* __restrict__ need, int steps, int lanes,
                int precision) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = blockIdx.x * LANES + lane;
  const bool live = l < lanes;
  const int tiles = (steps + T - 1) / T;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&sm.full[s], HELPERS);
      bar_init(&sm.empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp > 0) {
    // A helper: steps warp - 1, warp - 1 + HELPERS, ... of every tile, for
    // its lane. Tile j goes into stage j % STAGES once the chain has
    // walked tile j - STAGES and the helpers have written that tile's
    // chunks and flags out; one cp.async group a tile. A helper divides
    // tile i before it waits for the chain, so the division overlaps the
    // chain's walk of tile i - 1.
    const int h0 = warp - 1;
    auto issue = [&](int j) {
      const int s = j % STAGES;
#pragma unroll
      for (int u = 0; u < T / HELPERS; ++u) {
        const int tt = h0 + u * HELPERS;
        const int t = j * T + tt;
        const bool ok = live && t < steps;
        const size_t o = ok ? (size_t)t * lanes + l : 0;
        copy4(&sm.start[s][tt][lane], starts + o, ok);
        copy4(&sm.freq[s][tt][lane], freqs + o, ok);
      }
    };
    // Waits for the chain's walk of tile j and writes its outputs out.
    auto flush = [&](int j) {
      const int s = j % STAGES;
      bar_wait(&sm.empty[s], (j / STAGES) & 1);
#pragma unroll
      for (int u = 0; u < T / HELPERS; ++u) {
        const int tt = h0 + u * HELPERS;
        const int t = j * T + tt;
        if (live && t < steps) {
          const uint32_t w = sm.out[s][tt][lane];
          chunks[(size_t)t * lanes + l] = (int32_t)(w & 0xFFFFu);
          need[(size_t)t * lanes + l] = (int32_t)(w >> 16);
        }
      }
    };
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < tiles) issue(j);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int i = 0; i < tiles; ++i) {
      // All but the newest STAGES - 2 groups have landed: tile i has.
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
      const int s = i % STAGES;
#pragma unroll
      for (int u = 0; u < T / HELPERS; ++u) {
        const int tt = h0 + u * HELPERS;
        sm.rcp[s][tt][lane] = reciprocal(sm.freq[s][tt][lane]);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.full[s]);
      if (i > 0) flush(i - 1);
      // Stage (i - 1) % STAGES is free again: tile i + STAGES - 1 goes
      // there.
      if (i + STAGES - 1 < tiles) issue(i + STAGES - 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (tiles > 0) flush(tiles - 1);
    return;
  }

  // The chain: one lane a thread.
  const uint32_t total = 1u << precision;
  uint32_t h = live ? (uint32_t)head[l] : 0u;
  auto step = [&](int s, int tt) {
    const uint32_t start = sm.start[s][tt][lane];
    const uint32_t freq = sm.freq[s][tt][lane];
    const uint2 m = sm.rcp[s][tt][lane];
    const uint32_t a = freq == 1u ? total : 1u;
    const bool n = h >= (freq << (32 - precision));
    sm.out[s][tt][lane] = n ? (1u << 16) | (h & 0xFFFFu) : 0u;
    const uint32_t x = n ? h >> 16 : h;
    const uint32_t lo = __umulhi(x, m.x);
    const uint32_t q = (uint32_t)(((uint64_t)x * m.y + lo) >> 32);
    h = q * (total - freq) + x * a + start;
  };
  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    bar_wait(&sm.full[s], (i / STAGES) & 1);
    if (steps - i * T >= T) {
#pragma unroll
      for (int tt = 0; tt < T; ++tt) step(s, tt);
    } else {
      for (int tt = 0; tt < steps - i * T; ++tt) step(s, tt);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&sm.empty[s]);
  }
  if (live) out_head[l] = (int64_t)h;
}

}  // namespace

// Launcher, called by bindings.cpp. It is declared there with C++ linkage:
// a signature that drifts from this one leaves an undefined symbol, and
// the extension fails to load. 1 <= precision <= 16 (checked by the
// binding).
cudaError_t launch_push(const int64_t* head, const int32_t* starts,
                        const int32_t* freqs, int64_t* out_head,
                        int32_t* chunks, int32_t* need, int steps, int lanes,
                        int precision, cudaStream_t stream) {
  const int blocks = (lanes + LANES - 1) / LANES;
  if (blocks == 0) return cudaSuccess;
  const int smem = (int)sizeof(Smem);
  static bool sized[64] = {};  // the attribute, once a card
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !sized[dev]) {
    e = cudaFuncSetAttribute(push_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) sized[dev] = true;
  }
  push_kernel<<<blocks, THREADS, smem, stream>>>(head, starts, freqs,
                                                 out_head, chunks, need,
                                                 steps, lanes, precision);
  return cudaGetLastError();
}
