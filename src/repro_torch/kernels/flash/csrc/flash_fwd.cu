// Flash-attention forward, float32: the port of
// src/repro/kernels/flash/kernel.py:28 _flash_fwd_kernel (its wrapper
// flash_fwd :78, pallas_call :104) for float32 inputs. bfloat16 inputs take
// the tensor-core kernel of flash_fwd_wgmma.cu; the tensor cores would run
// float32 as TF32 and miss the 2e-5 tolerance, so this route stays on the
// CUDA cores, every product an explicit __fmaf_rn.
//
// What it computes is the Pallas kernel's function: for q [BH, Sq, D] and
// k, v [BH / G, Sk, D], query head h reads key/value head h / G; scores
// are q . k * head_dim^-0.5 summed in float32; a key is valid when k < Sk,
// k <= q (causal) and k > q - window (window > 0), and an invalid score is
// set to -1e30; the online softmax (m, l, acc) is kept in float32, and the
// output is acc / max(l, 1e-30). Scores are held in log2 units (times
// log2(e)) and exponentiated with exp2f, as the plain version does.
//
// Bound: the 2 * 2 * pairs * D flops of q.k and p.v over the (query, key)
// pairs the masks leave, at the FP32 rate of the CUDA cores; the bytes of
// q, k, v and out are far less. So the design is an SGEMM micro-kernel,
// twice a key tile (FlashAttention-2's loop on the CUDA cores):
//
//   * A block of 256 threads owns 16 x RPT queries of one head and walks
//     the key tiles of BN keys that its causal and window limits leave
//     (within the plain version's, ../twin.py kv_tiles). Thread (ty, tx) =
//     (tid / 16, tid % 16) owns query rows RPT ty .. RPT ty + RPT - 1.
//   * S = Q K^T: the thread computes an RPT x BN/16 sub-tile (keys tx,
//     tx + 16, ...) from float4 loads of Q and K rows in shared memory
//     (row stride D + 4 floats, so a quarter warp's eight K rows fall on
//     32 distinct banks): a 16-byte load feeds 4 x BN/16 or 4 x RPT FMAs,
//     not one as a broadcast operand did.
//   * The online softmax's row max is taken over the 16 threads of a row
//     group, one half warp, with shuffles; each thread keeps a partial
//     row sum l, rescaled with the row, summed across the 16 at the end.
//   * O += P V: P goes to shared memory transposed ([key][query], stride
//     16 RPT + 4: conflict-free float4 stores), and the thread's O is a
//     second micro-tile of its RPT rows x D/16 columns (stripes of 4 or 2
//     columns, 16 threads apart): 40 floats at D 160, in registers. A row
//     group's P is written and read by its own half warp, so a __syncwarp
//     orders it.
//   * K and V tiles come in with cp.async (16 bytes a copy, rows past Sk
//     and columns past D zero-filled) into two stages: tile t + 1's while
//     tile t's math runs, one block barrier a tile.
//
// Instances are templated on D rounded up to 32 (every register array has
// a static index; the wrapper pads D to a multiple of 4 and passes the
// true head dim for the scale). Up to D 64, RPT = 8 (8 x 4 sub-tiles of
// S, fewer shared loads a product) when the grid of 128-query blocks
// fills the card twice over, else RPT = 4; above, RPT = 4, and keys a
// tile BN = 64 (32 at D 192, where two stages of 64 overflow shared
// memory): ../twin.py simt_tiles. From D 128 up the kernel is compiled
// for one block a multiprocessor (its shared memory holds one), which
// leaves its registers unspilled. Blocks are launched longest-first under
// a causal mask.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr double LOG2E = 1.4426950408889634;
// RPT = 8 when at least this many 128-query blocks: twice the H100's 132
// multiprocessors (../twin.py SIMT_WIDE_GRID).
constexpr long WIDE_GRID = 2 * 132;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows r0 .. r0 + ROWS - 1 of a [rows, d] matrix into shared memory at
// row stride LD, DP / 4 copies of 16 bytes a row; rows >= rows and
// columns >= d are zero-filled.
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int rows, int d) {
  constexpr int CH = DP / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool in = r0 + r < rows && c < d;
    cp_async16(dst + r * LD + c, in ? src + (size_t)(r0 + r) * d + c : src,
               in);
  }
}

// A block's queries: 16 row groups of RPT rows.
template <int RPT>
__host__ __device__ constexpr int block_q() {
  return 16 * RPT;
}

// Q [block_q][DP + 4]; two stages of K [BN][DP + 4] and V [BN][DP];
// P^T [BN][block_q + 4].
template <int DP, int BN, int RPT>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(block_q<RPT>() * (DP + 4) + 2 * BN * (DP + 4) +
                  2 * BN * DP + BN * (block_q<RPT>() + 4));
}

template <int DP, int BN, int RPT>
__device__ __forceinline__ void flash_fwd_tile(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int group, int sq,
    int sk, int d, int causal, int window, float scale2) {
  constexpr int BLOCK_Q = block_q<RPT>();
  constexpr int PLD = BLOCK_Q + 4;           // P^T row stride
  constexpr int LD = DP + 4;                 // Q, K row stride
  constexpr int KPT = BN / 16;               // keys a thread in S
  constexpr int VEC = DP % 64 == 0 ? 4 : 2;  // O columns a load
  constexpr int NS = DP / (16 * VEC);        // O column stripes
  constexpr int NC = NS * VEC;               // O columns a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [BLOCK_Q][LD]
  float* ks = qs + BLOCK_Q * LD;      // 2 x [BN][LD]
  float* vs = ks + 2 * BN * LD;       // 2 x [BN][DP]
  float* ps = vs + 2 * BN * DP;       // [BN][PLD], p transposed

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_Q;
  const int q1 = min(q0 + BLOCK_Q, sq);
  const float* qh = q + (size_t)bh * sq * d;
  const float* kh = k + (size_t)(bh / group) * sk * d;
  const float* vh = v + (size_t)(bh / group) * sk * d;

  // The key tiles this query tile may see (../twin.py kv_tiles).
  const int end = causal ? min(sk, q1) : sk;
  const int start = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = start / BN;
  const int t_hi = (end + BN - 1) / BN;

  float acc[RPT][NC], m[RPT], l[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  stage<BLOCK_Q, DP, LD>(qs, qh, q0, sq, d);
  if (t_lo < t_hi) {
    stage<BN, DP, LD>(ks, kh, t_lo * BN, sk, d);
    stage<BN, DP, DP>(vs, vh, t_lo * BN, sk, d);
  }
  cp_async_commit();

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BN;
    const int buf = (t - t_lo) & 1;
    const float* kt = ks + buf * BN * LD;
    const float* vt = vs + buf * BN * DP;
    cp_async_wait_all();
    __syncthreads();  // tile t in; every thread is done with tile t - 1
    if (t + 1 < t_hi) {
      stage<BN, DP, LD>(ks + (buf ^ 1) * BN * LD, kh, k0 + BN, sk, d);
      stage<BN, DP, DP>(vs + (buf ^ 1) * BN * DP, vh, k0 + BN, sk, d);
    }
    cp_async_commit();

    float s[RPT][KPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 a[RPT], b[KPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        a[r] = *reinterpret_cast<const float4*>(&qs[(RPT * ty + r) * LD + c]);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        b[j] = *reinterpret_cast<const float4*>(&kt[(tx + 16 * j) * LD + c]);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[r][j] = __fmaf_rn(a[r].x, b[j].x, s[r][j]);
          s[r][j] = __fmaf_rn(a[r].y, b[j].y, s[r][j]);
          s[r][j] = __fmaf_rn(a[r].z, b[j].z, s[r][j]);
          s[r][j] = __fmaf_rn(a[r].w, b[j].w, s[r][j]);
        }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qi = q0 + RPT * ty + r;
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool valid = kj < sk;
        if (causal) valid = valid && kj <= qi;
        if (window > 0) valid = valid && kj > qi - window;
        s[r][j] = valid ? s[r][j] * scale2 : NEG_INF;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float corr = exp2f(m[r] - mx);
      m[r] = mx;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[r][j] = exp2f(s[r][j] - mx);
        psum += s[r][j];
      }
      l[r] = __fmaf_rn(l[r], corr, psum);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j)
#pragma unroll
      for (int h = 0; h < RPT; h += 4)
        *reinterpret_cast<float4*>(&ps[(tx + 16 * j) * PLD + RPT * ty + h]) =
            make_float4(s[h][j], s[h + 1][j], s[h + 2][j], s[h + 3][j]);
    __syncwarp();  // the half warp's P rows are in

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float pr[RPT];
#pragma unroll
      for (int h = 0; h < RPT; h += 4) {
        const float4 p =
            *reinterpret_cast<const float4*>(&ps[j * PLD + RPT * ty + h]);
        pr[h] = p.x, pr[h + 1] = p.y, pr[h + 2] = p.z, pr[h + 3] = p.w;
      }
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const float* vrow = &vt[j * DP + st * 16 * VEC + tx * VEC];
        float vv[VEC];
        if constexpr (VEC == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow);
          vv[0] = x.x, vv[1] = x.y, vv[2] = x.z, vv[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vrow);
          vv[0] = x.x, vv[1] = x.y;
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][st * VEC + e] =
                __fmaf_rn(pr[r], vv[e], acc[r][st * VEC + e]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float lt = l[r];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    const int qi = q0 + RPT * ty + r;
    if (qi >= sq) continue;
    const float denom = fmaxf(lt, 1e-30f);
    float* orow = out + ((size_t)bh * sq + qi) * d;
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      const int col = st * 16 * VEC + tx * VEC;
      if (col >= d) continue;  // d is a multiple of 4, so of VEC
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = __fdiv_rn(acc[r][st * VEC + e], denom);
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(o[0], o[1], o[2], o[3]);
      else
        *reinterpret_cast<float2*>(orow + col) = make_float2(o[0], o[1]);
    }
  }
}

// Below D 128 ptxas picks the registers; from 128 up, where the shared
// memory holds one block a multiprocessor, the wide instance may take
// them all.
template <int DP, int BN, int RPT>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int group, int sq, int sk, int d, int causal,
                     int window, float scale2) {
  flash_fwd_tile<DP, BN, RPT>(q, k, v, out, group, sq, sk, d, causal, window,
                              scale2);
}

template <int DP, int BN, int RPT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel_wide(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ out, int group, int sq, int sk,
                          int d, int causal, int window, float scale2) {
  flash_fwd_tile<DP, BN, RPT>(q, k, v, out, group, sq, sk, d, causal, window,
                              scale2);
}

template <int DP, int BN, int RPT>
auto kernel_of() {
  if constexpr (DP >= 128)
    return flash_fwd_kernel_wide<DP, BN, RPT>;
  else
    return flash_fwd_kernel<DP, BN, RPT>;
}

template <int DP, int BN, int RPT>
cudaError_t launch_tile(const float* q, const float* k, const float* v,
                        float* out, int bh, int group, int sq, int sk, int d,
                        int head_dim, int causal, int window,
                        cudaStream_t stream) {
  const auto kernel = kernel_of<DP, BN, RPT>();
  constexpr size_t smem = smem_bytes<DP, BN, RPT>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((sq + block_q<RPT>() - 1) / block_q<RPT>(), bh);
  kernel<<<grid, THREADS, smem, stream>>>(
      q, k, v, out, group, sq, sk, d, causal, window,
      (float)(pow((double)head_dim, -0.5) * LOG2E));
  return cudaGetLastError();
}

}  // namespace

// Launcher, called by ../../ans/csrc/bindings.cpp (declared there with C++
// linkage: a signature that drifts leaves an undefined symbol). float32,
// d a multiple of 4 in [4, 192], 1 <= head_dim <= d (the scale's), q, k, v
// 16-byte aligned, bh a multiple of group: checked by the binding. The
// tiles are ../twin.py simt_tiles(d, bh, sq)'s.
cudaError_t launch_flash_fwd_simt(const void* q, const void* k,
                                  const void* v, void* out, int bh,
                                  int group, int sq, int sk, int d,
                                  int head_dim, int causal, int window,
                                  cudaStream_t stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const bool wide = (long)bh * ((sq + block_q<8>() - 1) / block_q<8>()) >=
                    WIDE_GRID;
#define FLASH_SIMT(DP, BN, RPT)                                          \
  return launch_tile<DP, BN, RPT>(qf, kf, vf, of, bh, group, sq, sk, d, \
                                  head_dim, causal, window, stream)
  if (d <= 32) {
    if (wide) FLASH_SIMT(32, 64, 8);
    FLASH_SIMT(32, 64, 4);
  }
  if (d <= 64) {
    if (wide) FLASH_SIMT(64, 64, 8);
    FLASH_SIMT(64, 64, 4);
  }
  if (d <= 96) FLASH_SIMT(96, 64, 4);
  if (d <= 128) FLASH_SIMT(128, 64, 4);
  if (d <= 160) FLASH_SIMT(160, 64, 4);
  FLASH_SIMT(192, 32, 4);
#undef FLASH_SIMT
}
