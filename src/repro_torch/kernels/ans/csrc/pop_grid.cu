// Fused bucketize + rANS pop over the max-entropy N(0,1) bucket grid:
// the CUDA port of repro/kernels/ans/kernel.py:266 _pop_grid_kernel
// (pop_grid_emit), kinds "gaussian", "logistic" and "uniform".
//
// Gaussian and logistic: per step the (lat_bits+1)-step bisection of
// core/discretize.py for the largest i with F(i) <= slot, where F is the
// fixed-point CDF (ndtr of ../../common/ndtr.cuh, or XLA's sigmoid of
// ../../common/xla_math.cuh for the logistic), then F(idx) and F(idx+1)
// for the state update, then the masked 16-bit read from the
// pre-gathered feed. F costs about 100 flops (28 for the sigmoid), so the
// work is operations, not bytes; but a step's lat_bits + 3 evaluations
// are a chain, each waiting on the last, and one thread a lane left the
// card waiting on that chain's latency (0.19 ms for 4096 lanes x 40 steps
// on an H100, 58x the flops' bound).
//
// Design: a group of G threads (16 or 32, one warp or half of one) walks
// the bisection's own tree a lane (../../common/group_walk.cuh): one F
// evaluation a thread a round, the group's comparisons in one
// ballot, the leaf that log2 G levels of the tree reach found by a second
// ballot, and F(idx), F(idx+1) shuffled from the last round's probes.
// The top round does not depend on the slot, so helper warps evaluate it
// ahead of the chain (tiles of T steps, STAGES tiles in flight, in shared
// memory, with each step's mu and 1 / sigma): a thread evaluating F
// inline could not overlap it with the chain's, since the IEEE divisions
// inside F branch. At lat_bits 10 a step's chain then waits on one
// evaluation (G = 32, top 6 levels) or two (16, top 3); each evaluation
// is most of a round's time on the chain. The wider group evaluates more
// points that the walk does not take: at few lanes only the latency
// counts and G = 32 wins; at many, the card's issue rate counts too
// (group_for).
// F is evaluated by the same arithmetic (xla_ndtr::grid_start_from,
// xla_math::logistic_start) as bucketize.cu's walk of the same tree, so
// every F(i) is bit-identical and the walks make the same decisions.
//
// Uniform: a shift, no CDF. A step is a few integer operations, so what
// bounds it on an H100 is its read: a step that refills needs feed[r, l],
// at an address the lane's own history of refills sets, in the same step,
// and a device-memory read there puts a round trip on the chain each time
// (some 245 in a row a lane at 32 lanes x 392 steps, on one SM). The
// words a lane reads are rows r, r + 1, ... of its own column whatever the
// data, so a helper warp stages them in shared memory ahead of the reads
// (pop_grid_uniform_kernel), and the chain touches only registers and
// shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "group_walk.cuh"
#include "ndtr.cuh"
#include "xla_math.cuh"

// Grid kinds, as bindings.cpp passes them.
enum GridKind { kUniform = 0, kGaussian = 1, kLogistic = 2 };

namespace {

constexpr int T = 2;          // steps a tile of top rounds
constexpr int STAGES = 8;

// A group of G threads a lane. CW chain warps a block hold LB = 32 CW / G
// lanes; TOP levels of each step's tree (2^TOP points a lane) are
// evaluated by 2 LB 2^TOP / 32 helper warps, each helper thread one point
// of one of a tile's two steps, so that a tile is ready one evaluation
// after its stage is free.
template <int G>
struct Shape;
template <>
struct Shape<32> {
  static constexpr int LOG_G = 5, CW = 1, TOP = 6;
};
template <>
struct Shape<16> {
  static constexpr int LOG_G = 4, CW = 2, TOP = 3;
};

template <int G>
struct Layout {
  static constexpr int LB = 32 * Shape<G>::CW / G;  // lanes a block
  static constexpr int NP = 1 << Shape<G>::TOP;     // top points a lane
  static constexpr int ROW = NP + 2;                // and mu, 1 / sigma
  static constexpr int HW = T * LB * NP / 32;       // helper warps
  static constexpr int THREADS = 32 * (Shape<G>::CW + HW);
  // Dynamic shared memory ahead of the K + 1 edges: the barriers, then
  // [STAGES][T][LB][ROW] top-round values and each step's parameters.
  static constexpr size_t TOP_BYTES =
      2 * STAGES * sizeof(uint64_t) + (size_t)STAGES * T * LB * ROW * 4;
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

// F(i) of the CDF kind.
template <int KIND>
__device__ __forceinline__ uint32_t cdf_start(const float* edges, int i,
                                              float mu, float inv, int k,
                                              float scale) {
  if constexpr (KIND == kLogistic)
    return xla_math::logistic_start(edges, i, mu, inv, k, scale);
  else
    return xla_ndtr::grid_start(edges, i, mu, inv, k, scale);
}

template <int G, int KIND>
__global__ void __launch_bounds__(Layout<G>::THREADS)
    pop_grid_group_kernel(const int64_t* __restrict__ head,
                          const float* __restrict__ mu,
                          const float* __restrict__ sigma,
                          const int32_t* __restrict__ feed,
                          const float* __restrict__ edges,
                          int64_t* __restrict__ out_head,
                          int32_t* __restrict__ idx_out,
                          int32_t* __restrict__ reads, int steps, int lanes,
                          int lat_bits, int precision) {
  using L = Layout<G>;
  constexpr int LOG_G = Shape<G>::LOG_G, CW = Shape<G>::CW;
  constexpr int LB = L::LB, NP = L::NP;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + STAGES;
  uint32_t* topv = reinterpret_cast<uint32_t*>(empty + STAGES);
  float* s_edges = reinterpret_cast<float*>(smem_raw + L::TOP_BYTES);
  const int k = 1 << lat_bits;
  for (int i = threadIdx.x; i <= k; i += blockDim.x) s_edges[i] = edges[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], L::HW);
      bar_init(&empty[s], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t mask = (1u << precision) - 1u;
  const float scale = (float)((1 << precision) - k);
  auto f = [&](int i, float m, float inv) {
    return cdf_start<KIND>(s_edges, i, m, inv, k, scale);
  };
  // The top round: the tree's top p levels, np points sp apart. When the
  // group holds every point 0 .. K + 1 (`full_round`), the chain
  // evaluates them itself in its last round and the helpers idle.
  const bool full_round = k + 2 <= G;
  const int p = min(Shape<G>::TOP, lat_bits), np = 1 << p, sp = k >> p;
  const int tiles = (steps + T - 1) / T;
  const int l0 = blockIdx.x * LB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= CW) {
    // A helper thread: point `node` of lane l0 + li at step tt of every
    // tile, into stage j % STAGES once the chain has walked tile
    // j - STAGES; node 0's thread also leaves the step's mu and 1 / sigma
    // for the chain.
    if (full_round) return;
    const int hid = threadIdx.x - 32 * CW;
    const int tt = hid / (LB * NP), li = (hid / NP) % LB, node = hid % NP;
    const int lc = min(l0 + li, lanes - 1);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % STAGES;
      if (j >= STAGES) bar_wait(&empty[s], ((j / STAGES) - 1) & 1);
      if (node < np && j * T + tt < steps) {
        const size_t o = (size_t)(j * T + tt) * lanes + lc;
        const float m = mu[o], inv = __frcp_rn(sigma[o]);
        uint32_t* row = topv + ((s * T + tt) * LB + li) * L::ROW;
        row[node] = f(node * sp, m, inv);
        if (node == 0) {
          row[NP] = __float_as_uint(m);
          row[NP + 1] = __float_as_uint(inv);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&full[s]);
    }
    return;
  }

  // A chain group: thread t of the G of lane l.
  const int t = threadIdx.x & (G - 1);
  const int li = threadIdx.x / G;
  const int l = l0 + li;
  const bool live = l < lanes;
  const int lc = live ? l : lanes - 1;
  // The leaves this thread tests (group_walk.cuh): leaf t (and t + 32)
  // of the top round, leaf t of a round above the last, and answer t of
  // the last round, whose interval has nf = 2^m points.
  using group_walk::ballot;
  using group_walk::Path;
  using group_walk::path;
  using group_walk::reaches;
  const bool top64 = NP > 32 && p == 6;
  const Path<uint64_t> top_lo = path<uint64_t>(t, top64 ? 6 : 0);
  const Path<uint64_t> top_hi = path<uint64_t>(t + 32, top64 ? 6 : 0);
  const Path<uint32_t> top_leaf =
      path<uint32_t>(t < np ? t : 0, top64 ? 0 : p);
  const Path<uint32_t> mid_leaf = path<uint32_t>(t, LOG_G);
  int nf = full_round ? k : sp;
  while (nf > G / 2) nf >>= LOG_G;
  const int m = __ffs(nf) - 1;
  const bool has_a = t < nf, has_b = t >= 1 && t <= nf;
  const Path<uint32_t> last_a = path<uint32_t>(has_a ? t : 0, m);
  const Path<uint32_t> last_b = path<uint32_t>(has_b ? t - 1 : 0, m);

  uint32_t h = (uint32_t)head[lc];
  int r = 0;
  // The next read's feed word waits in a register, and each step loads
  // the one after it before its rounds: a read then waits on nothing and
  // takes no branch (in the dyntable pop, each was a large part of its
  // chain's step).
  const auto word = [&](int row) {
    return (uint32_t)feed[(size_t)min(row, steps - 1) * lanes + lc];
  };
  uint32_t fw = steps > 0 ? word(0) : 0u;
  for (int j = 0; j < tiles; ++j) {
    const int s = j % STAGES;
    if (!full_round) bar_wait(&full[s], (j / STAGES) & 1);
    for (int tt = 0; tt < T && j * T + tt < steps; ++tt) {
      const int st = j * T + tt;
      const uint32_t next = word(r + 1);
      const uint32_t* tv = topv + ((s * T + tt) * LB + li) * L::ROW;
      // The step's parameters: from the helpers, or, when they idle, from
      // device memory.
      float m_c, inv_c;
      if (full_round) {
        const size_t o = (size_t)st * lanes + lc;
        m_c = mu[o];
        inv_c = __frcp_rn(sigma[o]);
      } else {
        m_c = __uint_as_float(tv[NP]);
        inv_c = __uint_as_float(tv[NP + 1]);
      }
      const uint32_t slot = h & mask;
      int lo = 0;
      if (!full_round) {
        // The top round's bits and the leaf they reach, then the rounds
        // above the last.
        int a;
        if (top64) {
          const uint64_t up =
              ballot<G>(tv[t] <= slot) |
              (uint64_t)ballot<G>(tv[(t + 32) % NP] <= slot) << 32;
          const uint32_t lo_hit = ballot<G>(reaches(up, top_lo));
          const uint32_t hi_hit = ballot<G>(reaches(up, top_hi));
          a = lo_hit ? __ffs(lo_hit) - 1 : 32 + __ffs(hi_hit) - 1;
        } else {
          const uint32_t up =
              ballot<G>(t < np && tv[t < NP ? t : 0] <= slot);
          a = __ffs(ballot<G>(t < np && reaches(up, top_leaf))) - 1;
        }
        lo = a * sp;
        for (int n = sp; n > G / 2; n >>= LOG_G) {
          const int step = n >> LOG_G;
          const uint32_t up = ballot<G>(f(lo + t * step, m_c, inv_c) <= slot);
          lo += (__ffs(ballot<G>(reaches(up, mid_leaf))) - 1) * step;
        }
      }
      const uint32_t v_last = f(lo + t, m_c, inv_c);
      const uint32_t up = ballot<G>(v_last <= slot);
      const int a = __ffs(ballot<G>(group_walk::answers(
                        up, last_a, has_a, last_b, has_b, t))) -
                    1;
      const uint32_t start = __shfl_sync(0xffffffffu, v_last, a, G);
      const uint32_t nxt = __shfl_sync(0xffffffffu, v_last, a + 1, G);
      if (live && t == 0) idx_out[(size_t)st * lanes + l] = lo + a;
      h = (nxt - start) * (h >> precision) + slot - start;
      const bool need = h < (1u << 16);
      h = need ? (h << 16) | fw : h;
      fw = need ? next : fw;
      r += need;
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }
  if (live && t == 0) {
    out_head[l] = (int64_t)h;
    reads[l] = r;
  }
}

// The uniform kind: blocks of U_LANES = 32 lanes, one chain warp (one
// lane a thread) and one helper warp. The helper keeps the next feed rows
// of the block's lanes in a shared-memory ring (row y of the block, 128
// coalesced bytes, in slot y % U_RING, by cp.async) ahead of the lanes'
// reads, and writes each walked tile's indices out, in 16-byte chunks
// where the rows are 16-byte aligned. The chain holds each lane's next
// feed word in a register and loads the one after it from the ring at
// the top of every step, and leaves its indices in shared memory, so a
// step waits on no device memory and takes no branch. A tile whose reads
// the ring does not hold yet (lanes whose reads run further apart than
// the ring allows, or the last, short tile) is walked by a loop that
// tests each read and takes a word the ring lacks from device memory.
constexpr int U_LANES = 32;
constexpr int U_THREADS = 64;
constexpr int U_T = 32;       // steps a tile
constexpr int U_STAGES = 3;   // tiles of indices in flight
constexpr int U_RING = 256;   // feed rows in shared memory (a power of 2)

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

__global__ void __launch_bounds__(U_THREADS)
    pop_grid_uniform_kernel(const int64_t* __restrict__ head,
                            const int32_t* __restrict__ feed,
                            int64_t* __restrict__ out_head,
                            int32_t* __restrict__ idx_out,
                            int32_t* __restrict__ reads, int steps,
                            int lanes, int lat_bits, int precision) {
  __shared__ uint64_t full[U_STAGES], empty[U_STAGES];
  __shared__ __align__(16) int32_t outs[U_STAGES][U_T][U_LANES];
  __shared__ __align__(16) uint32_t ring[U_RING][U_LANES];
  // Per stage: the chain's least read count after the tile, and the feed
  // rows the ring holds for it.
  __shared__ int least[U_STAGES], held[U_STAGES];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l0 = blockIdx.x * U_LANES;
  const int nl = min(U_LANES, lanes - l0);  // lanes of this block
  const int l = l0 + lane;
  const bool live = lane < nl;
  const int tiles = (steps + U_T - 1) / U_T;
  // A whole block whose rows are 16-byte aligned moves them in 16-byte
  // chunks, 8 a row.
  const bool wide = nl == U_LANES && lanes % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(feed) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(idx_out) % 16 == 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < U_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp > 0) {
    // The helper. Before tile j is released to the chain, the ring holds
    // the feed rows below held[j % U_STAGES]: the first 2 U_T rows for
    // tile 0, the whole ring for tile 1, then, for tile j, rows up to
    // U_RING past the chain's least read count after tile j - U_STAGES
    // (the slots of the rows every lane has read). One cp.async group a
    // tile.
    int filled = 0;  // feed rows issued into the ring
    auto refill = [&](int upto, int j) {
      upto = min(upto, steps);
      if (wide) {
        const int n = max(0, upto - filled) * 8;
        for (int e = lane; e < n; e += 32) {
          const int y = filled + (e >> 3), w = (e & 7) * 4;
          copy16(&ring[y % U_RING][w], feed + (size_t)y * lanes + l0 + w);
        }
      } else if (live) {
        for (int y = filled; y < upto; ++y)
          copy4(&ring[y % U_RING][lane], feed + (size_t)y * lanes + l);
      }
      filled = max(filled, upto);
      if (lane == 0) held[j % U_STAGES] = filled;
    };
    // Waits for the chain's walk of tile j and writes its indices out.
    auto flush = [&](int j) {
      const int s = j % U_STAGES;
      bar_wait(&empty[s], (j / U_STAGES) & 1);
      const int n = min(U_T, steps - j * U_T);
      int32_t* out = idx_out + (size_t)j * U_T * lanes + l0;
      if (wide) {
#pragma unroll
        for (int k = 0; k < U_T / 4; ++k) {
          const int row = 4 * k + lane / 8, col = (lane % 8) * 4;
          if (row < n)
            *reinterpret_cast<int4*>(out + (size_t)row * lanes + col) =
                *reinterpret_cast<const int4*>(&outs[s][row][col]);
        }
      } else if (live) {
        for (int row = 0; row < n; ++row)
          out[(size_t)row * lanes + lane] = outs[s][row][lane];
      }
    };
    for (int j = 0; j < U_STAGES - 1; ++j) {
      if (j < tiles) refill(j == 0 ? 2 * U_T : U_RING, j);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int i = 0; i < tiles; ++i) {
      // All but the newest U_STAGES - 2 groups have landed: tile i's has.
      asm volatile("cp.async.wait_group %0;\n" ::"n"(U_STAGES - 2)
                   : "memory");
      __syncwarp();
      if (lane == 0) bar_arrive(&full[i % U_STAGES]);
      if (i > 0) flush(i - 1);
      const int j = i + U_STAGES - 1;
      if (j < tiles)
        refill((i > 0 ? least[(i - 1) % U_STAGES] : 0) + U_RING, j);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (tiles > 0) flush(tiles - 1);
    return;
  }

  // The chain. A thread past the last lane walks its neighbour's column
  // and stores nothing.
  const uint32_t mask = (1u << precision) - 1u;
  const int shift = precision - lat_bits;
  const uint32_t freq = 1u << shift;
  const int lc = live ? l : l0;
  uint32_t h = (uint32_t)head[lc];
  int r = 0;
  uint32_t fw = steps > 0 ? (uint32_t)feed[lc] : 0u;
  for (int i = 0; i < tiles; ++i) {
    const int s = i % U_STAGES;
    bar_wait(&full[s], (i / U_STAGES) & 1);
    const int ready = held[s];
    const int n = min(U_T, steps - i * U_T);
    // One step: the pop, then the read of word r (fw) when the head fell
    // below 2^16; `next` is word r + 1.
    const auto step = [&](int tt, uint32_t next) {
      const uint32_t slot = h & mask;
      const uint32_t idx = slot >> shift;
      outs[s][tt][lane] = (int32_t)idx;
      h = freq * (h >> precision) + slot - (idx << shift);
      const bool need = h < (1u << 16);
      h = need ? (h << 16) | fw : h;
      r += need;
      return need;
    };
    if (n == U_T &&
        __all_sync(0xffffffffu, !live || r + U_T < ready)) {
      // Every read of the tile is in the ring.
#pragma unroll
      for (int tt = 0; tt < U_T; ++tt) {
        const uint32_t next = ring[(unsigned)(r + 1) % U_RING][lane];
        fw = step(tt, next) ? next : fw;
      }
    } else {
      for (int tt = 0; tt < n; ++tt) {
        const uint32_t next = ring[(unsigned)(r + 1) % U_RING][lane];
        if (step(tt, next))
          fw = r < ready ? next
                         : (r < steps ? (uint32_t)feed[(size_t)r * lanes + lc]
                                      : fw);
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

// The group for `lanes` lanes of `kind`: the widest (one evaluation on a
// step's chain at lat_bits 10) while the card's issue rate keeps up with
// the points it evaluates in vain, 16 above. On an H100 at 40 steps 32
// was faster up to 1024 lanes for the gaussian and 512 for the logistic,
// whose cheaper F leaves less latency to hide (chip_smoke.py phase 3
// times each kind on either side of its threshold).
int group_for(int lanes, int kind) {
  return lanes <= (kind == kLogistic ? 512 : 1024) ? 32 : 16;
}

template <int G, int KIND>
cudaError_t launch_group(const int64_t* head, const float* mu,
                         const float* sigma, const int32_t* feed,
                         const float* edges, int64_t* out_head, int32_t* idx,
                         int32_t* reads, int steps, int lanes, int lat_bits,
                         int precision, cudaStream_t stream) {
  using L = Layout<G>;
  const size_t smem =
      L::TOP_BYTES + (size_t)((1 << lat_bits) + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pop_grid_group_kernel<G, KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (lanes + L::LB - 1) / L::LB;
  pop_grid_group_kernel<G, KIND><<<blocks, L::THREADS, smem, stream>>>(
      head, mu, sigma, feed, edges, out_head, idx, reads, steps, lanes,
      lat_bits, precision);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(const int64_t* head, const float* mu,
                        const float* sigma, const int32_t* feed,
                        const float* edges, int64_t* out_head, int32_t* idx,
                        int32_t* reads, int steps, int lanes, int lat_bits,
                        int precision, cudaStream_t stream) {
  if (group_for(lanes, KIND) == 16)
    return launch_group<16, KIND>(head, mu, sigma, feed, edges, out_head,
                                  idx, reads, steps, lanes, lat_bits,
                                  precision, stream);
  return launch_group<32, KIND>(head, mu, sigma, feed, edges, out_head, idx,
                                reads, steps, lanes, lat_bits, precision,
                                stream);
}

}  // namespace

// Launcher, called by bindings.cpp. It is declared there with C++ linkage:
// a signature that drifts from this one leaves an undefined symbol, and
// the extension fails to load.
cudaError_t launch_pop_grid(const int64_t* head, const float* mu,
                            const float* sigma, const int32_t* feed,
                            const float* edges, int64_t* out_head,
                            int32_t* idx, int32_t* reads, int steps,
                            int lanes, int kind, int lat_bits,
                            int precision, cudaStream_t stream) {
  if (lanes == 0) return cudaSuccess;
  if (kind < kUniform || kind > kLogistic) return cudaErrorInvalidValue;
  if (kind == kUniform) {
    const int blocks = (lanes + U_LANES - 1) / U_LANES;
    pop_grid_uniform_kernel<<<blocks, U_THREADS, 0, stream>>>(
        head, feed, out_head, idx, reads, steps, lanes, lat_bits, precision);
    return cudaGetLastError();
  }
  return kind == kLogistic
             ? launch_kind<kLogistic>(head, mu, sigma, feed, edges,
                                      out_head, idx, reads, steps, lanes,
                                      lat_bits, precision, stream)
             : launch_kind<kGaussian>(head, mu, sigma, feed, edges,
                                      out_head, idx, reads, steps, lanes,
                                      lat_bits, precision, stream);
}
