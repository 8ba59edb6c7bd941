// Flash-attention forward, float32: the port of
// src/repro/kernels/flash/kernel.py:28 _flash_fwd_kernel (its wrapper
// flash_fwd :78, pallas_call :104) for float32 inputs. bfloat16 inputs take
// the tensor-core kernel of flash_fwd_wgmma.cu; the tensor cores would run
// float32 as TF32 and miss the 2e-5 tolerance, so this route stays on the
// CUDA cores.
//
// What it computes is the Pallas kernel's function: for q [BH, Sq, D] and
// k, v [BH / G, Sk, D], query head h reads key/value head h / G; scores
// are q . k * D^-0.5 summed in float32; a key is valid when k < Sk,
// k <= q (causal) and k > q - window (window > 0), and an invalid score is
// set to -1e30; the online softmax (m, l, acc) is kept in float32, and the
// output is acc / max(l, 1e-30).
//
// Design. On the TPU the grid's key axis runs in order and carries
// (m, l, acc) in VMEM from one step to the next. Here blocks run in no
// order, so one block owns a tile of BLOCK_Q = 128 queries of one head,
// one thread per query, and loops over the key tiles itself: only those
// the causal and window limits leave (within the twin's, ../twin.py
// kv_tiles; skipping a tile that lies wholly after a query's diagonal adds
// exp(-1e30 - m) = 0, and one wholly before its window is wiped by corr =
// exp(-1e30 - m) = 0 once a valid key arrives, so the result does not
// change). Each tile of BLOCK_K = 64 keys and values is staged in shared
// memory by all threads; a thread keeps its query row and its accumulator
// in registers (DMAX of each) and walks the tile 16 keys at a time: 16
// scores, one rescale of acc, 16 rows of p . v. Every product is an
// explicit __fmaf_rn, so the extension's --fmad=false does not split them;
// exp is expf and the final division IEEE. float32 p is not rounded, so
// updating every 16 keys agrees with the plain version's one update per
// tile of 128 to float32 rounding.
//
// Bound: the 2 * 2 * Sq * Sk * D flops of q.k and p.v (half of it under a
// causal mask) against the q, k, v, out bytes. This kernel runs them on
// the CUDA cores, one FFMA at a time, with the key and value reads
// broadcast from shared memory. DMAX = 128 and 192 (the instances for
// D above 64 and 128) keep 256 and 384 floats a thread and spill to local
// memory; they are right, not fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int BLOCK_Q = 128;
constexpr int BLOCK_K = 64;
constexpr int SUB = 16;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// p rounded to v's type and back: the Pallas kernel's p.astype(v.dtype).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(BLOCK_Q)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int group,
                     int sq, int sk, int d, int causal, int window,
                     float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                    // [BLOCK_K][DMAX]
  float* vs = smem + BLOCK_K * DMAX;   // [BLOCK_K][DMAX]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int q1 = min(q0 + BLOCK_Q, sq);
  const int qi = q0 + threadIdx.x;
  const bool live = qi < sq;
  const T* kh = k + (size_t)(bh / group) * sk * d;
  const T* vh = v + (size_t)(bh / group) * sk * d;

  float qr[DMAX], acc[DMAX];
#pragma unroll
  for (int c = 0; c < DMAX; ++c) {
    qr[c] = (live && c < d) ? to_f(q[((size_t)bh * sq + qi) * d + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // The key tiles this query tile may see (../twin.py kv_tiles).
  const int end = causal ? min(sk, q1) : sk;
  const int start = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = start / BLOCK_K;
  const int t_hi = (end + BLOCK_K - 1) / BLOCK_K;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BLOCK_K;
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < BLOCK_K * DMAX; i += BLOCK_Q) {
      const int r = i / DMAX, c = i % DMAX;
      const bool in = k0 + r < sk && c < d;
      const size_t at = (size_t)(k0 + r) * d + c;
      ks[i] = in ? to_f(kh[at]) : 0.f;
      vs[i] = in ? to_f(vh[at]) : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < BLOCK_K; j0 += SUB) {
      float s[SUB];
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int c = 0; c < DMAX; c += 4) {
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) {
          const float4 kv =
              *reinterpret_cast<const float4*>(&ks[(j0 + jj) * DMAX + c]);
          s[jj] = __fmaf_rn(qr[c], kv.x, s[jj]);
          s[jj] = __fmaf_rn(qr[c + 1], kv.y, s[jj]);
          s[jj] = __fmaf_rn(qr[c + 2], kv.z, s[jj]);
          s[jj] = __fmaf_rn(qr[c + 3], kv.w, s[jj]);
        }
      }
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int kj = k0 + j0 + jj;
        bool valid = kj < sk;
        if (causal) valid = valid && kj <= qi;
        if (window > 0) valid = valid && kj > qi - window;
        s[jj] = valid ? s[jj] * scale : NEG_INF;
        m_new = fmaxf(m_new, s[jj]);
      }
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = expf(s[jj] - m_new);
        psum += p;
        s[jj] = round_to<T>(p);
      }
      l = __fmaf_rn(l, corr, psum);
#pragma unroll
      for (int c = 0; c < DMAX; ++c) acc[c] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
#pragma unroll
        for (int c = 0; c < DMAX; c += 4) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[(j0 + jj) * DMAX + c]);
          acc[c] = __fmaf_rn(s[jj], vv.x, acc[c]);
          acc[c + 1] = __fmaf_rn(s[jj], vv.y, acc[c + 1]);
          acc[c + 2] = __fmaf_rn(s[jj], vv.z, acc[c + 2]);
          acc[c + 3] = __fmaf_rn(s[jj], vv.w, acc[c + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < DMAX; ++c)
    if (c < d) out[((size_t)bh * sq + qi) * d + c] = from_f<T>(acc[c] / denom);
}

template <typename T, int DMAX>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int bh, int group, int sq, int sk, int d,
                         int causal, int window, cudaStream_t stream) {
  const size_t smem = 2 * BLOCK_K * DMAX * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((sq + BLOCK_Q - 1) / BLOCK_Q, bh);
  flash_fwd_kernel<T, DMAX><<<grid, BLOCK_Q, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), group, sq, sk, d,
      causal, window, (float)pow((double)d, -0.5));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dmax(const void* q, const void* k, const void* v,
                        void* out, int bh, int group, int sq, int sk, int d,
                        int causal, int window, cudaStream_t stream) {
  if (d <= 32)
    return launch_typed<T, 32>(q, k, v, out, bh, group, sq, sk, d, causal,
                               window, stream);
  if (d <= 64)
    return launch_typed<T, 64>(q, k, v, out, bh, group, sq, sk, d, causal,
                               window, stream);
  if (d <= 128)
    return launch_typed<T, 128>(q, k, v, out, bh, group, sq, sk, d, causal,
                                window, stream);
  return launch_typed<T, 192>(q, k, v, out, bh, group, sq, sk, d, causal,
                              window, stream);
}

}  // namespace

// Launcher, called by ../../ans/csrc/bindings.cpp (declared there with C++
// linkage: a signature that drifts leaves an undefined symbol). float32,
// d <= 192, bh a multiple of group, checked by the binding.
cudaError_t launch_flash_fwd_simt(const void* q, const void* k,
                                  const void* v, void* out, int bh,
                                  int group, int sq, int sk, int d,
                                  int causal, int window,
                                  cudaStream_t stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  return launch_dmax<float>(q, k, v, out, bh, group, sq, sk, d, causal,
                            window, stream);
}
