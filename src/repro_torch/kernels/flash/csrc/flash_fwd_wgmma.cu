// Flash-attention forward, bfloat16, on Hopper's tensor cores: the
// port of src/repro/kernels/flash/kernel.py:28 _flash_fwd_kernel (its
// wrapper flash_fwd :78, pallas_call :104) for bfloat16 inputs. The
// float32 route keeps the SIMT kernel of flash_fwd.cu.
//
// What it computes is the Pallas kernel's function: for q [BH, Sq, D] and
// k, v [BH / G, Sk, D] in bfloat16, query head h reads key/value head
// h / G in place; scores are q . k * D^-0.5 summed in float32; a key is
// valid when k < Sk, k <= q (causal) and k > q - window (window > 0), and
// an invalid score is -1e30; the online softmax (m, l, acc) is kept in
// float32, p is rounded to bfloat16 before p . v, and the output is
// acc / max(l, 1e-30) in bfloat16. The tensors' D is a multiple of 16
// (the wrapper zero-pads); the scale is the true head dim's.
//
// Bound: the 2 * 2 * Sq * Sk * D flops of q.k and p.v (about half of them
// under a causal mask) at the 989 TFLOP/s bf16 tensor-core rate; the
// q, k, v, out bytes are far smaller. Design, after Hopper's warp-
// specialised GEMMs:
//  * one block owns 128 queries of one head as two consumer warpgroups
//    of 64 rows, plus a producer warpgroup that gives up its registers
//    (setmaxnreg: 24 a thread, the consumers 240); blocks run the heaviest
//    (last) query tiles first;
//  * one producer thread brings Q once and each key tile of 128 keys (the
//    Pallas wrapper's block_k; 64 at D above 128, key_tile) of K and V
//    through TMA (cp.async.bulk.tensor, 128-byte swizzle) into a ring of
//    4 stages (3 at D 128 and 192), paced by mbarriers; TMA zero-fills
//    rows past Sq or Sk and columns past D (instances of 64, 128 and 192
//    columns). With 2 stages the next tile could only be asked for once
//    the one before had been used, and every tile waited on its load;
//  * S = Q K^T is wgmma m64nBKk16 with both operands K-major in shared
//    memory; the softmax runs on the accumulator fragments (row max by
//    quad shuffles; masks only on tiles that straddle the diagonal, the
//    window edge or Sk); p, rounded to bfloat16 in registers, is the
//    register A operand of O += P V (wgmma m64nDk16), whose B operand is
//    V read MN-major (transposed) from the same swizzled tile;
//  * a warpgroup issues P V of tile i - 1 and S of tile i as one batch,
//    waits, and runs tile i's softmax; the two warpgroups overlap each
//    other's products and exponentials. (Running tile i's softmax while
//    P V of tile i - 1 is still in flight made ptxas serialize every
//    product, C7513, and was slower.);
//  * only the key tiles that ../twin.py kv_tiles leaves are visited, one
//    online-softmax update per tile, as the plain version does (skipping
//    a tile wholly after a query's diagonal adds exp(-1e30 - m) = 0, and
//    one wholly before its window is wiped by corr = 0).
// The extension builds with --fmad=false: the softmax's one fused product
// (the row sums' update) is an explicit __fmaf_rn, and p = 2^(s * scale -
// m) with scale = D^-0.5 log2(e), as the plain version computes it, so
// that p rounds to the same bfloat16.
#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int BQ = 128;      // queries a block
constexpr int PANEL = 64;    // bf16 columns of one 128-byte swizzled row
constexpr int CONSUMERS = 256;               // two warpgroups
constexpr int THREADS = CONSUMERS + 128;     // and a producer warpgroup
constexpr float NEG_INF = -1e30f;

// Keys a tile at padded head dim DP: 128 (the Pallas wrapper's block_k)
// up to DP 128, 64 at DP 192, where Q (48 KB) and two stages of 128-key
// K and V tiles (96 KB each) would overflow the 227 KB of shared memory.
// ../twin.py block_k(D) gives the plain version the same tile, so that a
// bfloat16 p is rounded against the same running max.
template <int DP>
constexpr int key_tile() {
  return DP > 128 ? 64 : 128;
}

// Shared memory of a block for padded head dim DP (64, 128 or 192): each
// tile is DP / 64 panels of [rows][64] bf16, 128-byte rows swizzled by
// TMA, so every panel starts on a 1024-byte boundary.
template <int DP>
struct Smem {
  static constexpr int BK = key_tile<DP>();
  // Key tiles in flight: as many as the 227 KB of shared memory hold.
  static constexpr int STAGES = DP == 64 ? 4 : 3;
  __nv_bfloat16 q[DP / PANEL][BQ][PANEL];
  __nv_bfloat16 k[STAGES][DP / PANEL][BK][PANEL];
  __nv_bfloat16 v[STAGES][DP / PANEL][BK][PANEL];
  uint64_t q_full;
  uint64_t k_full[STAGES], v_full[STAGES], empty[STAGES];
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

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
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

// One TMA box ({64 columns, the map's rows, 1 head}) at (col, row, head)
// into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle (layout type 1
// in bits 62-63, the TMA maps' CU_TENSOR_MAP_SWIZZLE_128B): start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}


__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n192k16_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,\n"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,\n"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over one step of 16 keys: N = DP output columns.
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64)
    wgmma_m64n64k16_rs(o, a, db);
  else if constexpr (DP == 128)
    wgmma_m64n128k16_rs(o, a, db);
  else
    wgmma_m64n192k16_rs(o, a, db);
}

// S (+)= Q K^T over one step of 16 columns of D: N = BK keys.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&sc)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 64)
    wgmma_m64n64k16_ss(sc, da, db, scale_d);
  else
    wgmma_m64n128k16_ss(sc, da, db, scale_d);
}

// 2^x, flushing results below 2^-126 to 0 (where exp2f, like torch.exp2
// on the card, keeps subnormals, far below a bfloat16 p's weight).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issues, and commits as one group each, O += P V (PV) and S = Q K^T
// (QK) for one warpgroup; neither is waited for. S: DP / 16 steps of 16
// columns; a step moves 32 bytes along the swizzled 128-byte rows, a
// panel 128 (Q) or BK (K) rows on. P V: V's rows are keys (the
// reduction), its 64-column panels the output columns, read MN-major: 8
// keys a 1024-byte group (SBO), a panel BK rows on (LBO); a step of 16
// keys moves 2048 bytes, and the fragment of keys 16 kk .. 16 kk + 15 of
// P is pa[kk]. The registers the products read and write are written
// before the fence.
template <int DP, bool QK, bool PV, int BK = key_tile<DP>()>
__device__ __forceinline__ void issue(float (&sc)[BK / 2], float (&o)[DP / 2],
                                      uint32_t (&pa)[BK / 16][4],
                                      uint32_t q_base, uint32_t k_base,
                                      uint32_t v_base) {
  uint64_t da[DP / 16], db[DP / 16], dv[BK / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    da[kk] = desc_sw128(q_base + (kk / 4) * (BQ * 128) + (kk % 4) * 32, 16,
                        1024);
    db[kk] = desc_sw128(k_base + (kk / 4) * (BK * 128) + (kk % 4) * 32, 16,
                        1024);
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    dv[kk] = desc_sw128(v_base + kk * 2048, BK * 128, 1024);
  if (QK) fence_regs(sc);
  if (PV) {
    fence_regs(o);
    fence_regs(pa);
  }
  wgmma_fence();
  if (PV) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_pv<DP>(o, pa[kk], dv[kk]);
    wgmma_commit();
  }
  if (QK) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_qk<BK>(sc, da[kk], db[kk], kk > 0);
    wgmma_commit();
  }
}

// One online-softmax update on the scores of key tile k0 (this thread's
// rows r0 and r0 + 8, columns k0 + 8 j + c0 + {0, 1}): the new row max m,
// corr = 2^(m_old - m), the thread's share of the row sums l, and p
// rounded to bfloat16 as wgmma's register A fragments (the fragment of
// keys 16 kk .. 16 kk + 15 is the accumulator's columns 2 kk and 2 kk + 1).
// It only reads sc, the product's accumulator. p is formed as the plain
// version forms it, in log2 units: x = s * scale (scale carries log2(e);
// -1e30 where MASKED's masks fail), then p = 2^(x - m), a multiply and a
// subtraction and no fused product: a float p one ulp off rounds to
// another bfloat16 now and then, and at |v| near 90 that moves an output
// by 0.35.
template <int BK, bool MASKED>
__device__ __forceinline__ void softmax(const float (&sc)[BK / 2],
                                        float (&m)[2], float (&l)[2],
                                        float (&corr)[2],
                                        uint32_t (&pa)[BK / 16][4],
                                        float scale, int k0, int r0, int c0,
                                        int sk, int causal, int window) {
  auto score = [&](int i) {
    if (!MASKED) return sc[i] * scale;
    const int kj = k0 + 8 * (i / 4) + c0 + (i & 1);
    const int qi = r0 + 8 * ((i >> 1) & 1);
    bool valid = kj < sk;
    if (causal) valid = valid && kj <= qi;
    if (window > 0) valid = valid && kj > qi - window;
    return valid ? sc[i] * scale : NEG_INF;
  };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = score(2 * r);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(score(4 * j + 2 * r), score(4 * j + 2 * r + 1)));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
  auto p = [&](int i) {
    const float y = ex2(score(i) - m[(i >> 1) & 1]);
    psum[(i >> 1) & 1] += y;
    return y;
  };
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float lo = p(8 * kk + 2 * h), hi = p(8 * kk + 2 * h + 1);
      pa[kk][h] = pack_bf16(lo, hi);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], corr[r], psum[r]);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ out, int group, int sq,
                           int sk, int dp, int causal, int window,
                           float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(smem_raw + pad);
  constexpr int PANELS = DP / PANEL;
  constexpr int BK = Smem<DP>::BK;
  constexpr uint32_t Q_BYTES = PANELS * BQ * PANEL * 2;
  constexpr uint32_t KV_BYTES = PANELS * BK * PANEL * 2;
  constexpr int STAGES = Smem<DP>::STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int q1 = min(q0 + BQ, sq);
  // The key tiles this query tile may see (../twin.py kv_tiles).
  const int end = causal ? min(sk, q1) : sk;
  const int start = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = start / BK;
  const int n_tiles = max(0, (end + BK - 1) / BK - t_lo);
  const int tid = threadIdx.x;

  if (tid == 0) {
    bar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&sm.k_full[s], 1);
      bar_init(&sm.v_full[s], 1);
      bar_init(&sm.empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warpgroup; one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      bar_expect(&sm.q_full, Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma_load(&sm.q[p][0][0], &tq, p * PANEL, q0, bh, &sm.q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, k0 = (t_lo + i) * BK;
        if (i >= STAGES) bar_wait(&sm.empty[s], ((i / STAGES) - 1) & 1);
        bar_expect(&sm.k_full[s], KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load(&sm.k[s][p][0][0], &tk, p * PANEL, k0, bh / group,
                   &sm.k_full[s]);
        bar_expect(&sm.v_full[s], KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load(&sm.v[s][p][0][0], &tv, p * PANEL, k0, bh / group,
                   &sm.v_full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");

  // A consumer warpgroup: rows [w0, w0 + 64) of the tile; this thread
  // holds rows r0 and r0 + 8 of the accumulator fragments, columns
  // 8 j + 2 (lane % 4) + {0, 1}. Per tile: P V of the tile before and S
  // of this one in one batch, then this tile's softmax.
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int w0 = q0 + wg * 64;
  const int r0 = w0 + ((tid % 128) / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t q_base = smem_addr(&sm.q[0][wg * 64][0]);
  // Whether tile t's keys meet this warpgroup's diagonal, window edge or
  // Sk, so that it needs the masks.
  auto masked = [&](int t) {
    const int k0 = t * BK;
    return k0 + BK > sk || (causal && k0 + BK - 1 > w0) ||
           (window > 0 && k0 <= w0 + 63 - window);
  };
  auto update = [&](float(&sc)[BK / 2], float(&m)[2], float(&l)[2],
                    float(&corr)[2], uint32_t(&pa)[BK / 16][4], int t) {
    if (masked(t))
      softmax<BK, true>(sc, m, l, corr, pa, scale, t * BK, r0, c0, sk,
                        causal, window);
    else
      softmax<BK, false>(sc, m, l, corr, pa, scale, t * BK, r0, c0, sk,
                         causal, window);
  };

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  if (n_tiles > 0) {
    float sc[BK / 2], corr[2];
    uint32_t pa[BK / 16][4];
    bar_wait(&sm.q_full, 0);
    bar_wait(&sm.k_full[0], 0);
    issue<DP, true, false>(sc, o, pa, q_base, smem_addr(&sm.k[0][0][0][0]),
                           0);
    wgmma_wait<0>();
    fence_regs(sc);
    update(sc, m, l, corr, pa, t_lo);  // o is 0: corr has nothing to scale
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      bar_wait(&sm.k_full[s], (i / STAGES) & 1);
      bar_wait(&sm.v_full[sp], ((i - 1) / STAGES) & 1);
      issue<DP, true, true>(sc, o, pa, q_base, smem_addr(&sm.k[s][0][0][0]),
                            smem_addr(&sm.v[sp][0][0][0]));
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(o);
      if (lane == 0) bar_arrive(&sm.empty[sp]);
      update(sc, m, l, corr, pa, t_lo + i);
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) o[j] *= corr[(j >> 1) & 1];
    }
    const int sl = (n_tiles - 1) % STAGES;
    bar_wait(&sm.v_full[sl], ((n_tiles - 1) / STAGES) & 1);
    issue<DP, false, true>(sc, o, pa, q_base, 0,
                           smem_addr(&sm.v[sl][0][0][0]));
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) bar_arrive(&sm.empty[sl]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + c0;
    if (c >= dp) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + 8 * r;
      if (qi >= sq) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)bh * sq + qi) * dp +
                                         c) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / l[r],
                                o[4 * j + 2 * r + 1] / l[r]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// extension does not link libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a contiguous bf16 [heads, rows, dp] tensor in boxes of
// {64 columns, box_rows rows, 1 head}, 128-byte swizzled, zero past its
// edges.
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* base,
                int heads, int rows, int dp, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)dp, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dp * 2,
                                 (cuuint64_t)rows * dp * 2};
  const cuuint32_t box[3] = {PANEL, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Q in boxes of 128 query rows, K and V of the instance's key tile.
template <int DP>
cudaError_t launch_typed(EncodeTiled encode, const void* q, const void* k,
                         const void* v, void* out, int bh, int group, int sq,
                         int sk, int dp, int causal, int window, float scale,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, encode, q, bh, sq, dp, BQ) ||
      !tensor_map(&tk, encode, k, bh / group, sk, dp, Smem<DP>::BK) ||
      !tensor_map(&tv, encode, v, bh / group, sk, dp, Smem<DP>::BK))
    return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem<DP>) + 1024;  // + alignment slack
  static bool sized[64] = {};  // the attribute, once a card
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !sized[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) sized[dev] = true;
  }
  dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<DP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), group, sq, sk, dp, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// Launcher, called by ../../ans/csrc/bindings.cpp (declared there with C++
// linkage). q [bh, sq, dp], k and v [bh / group, sk, dp], out [bh, sq, dp]:
// contiguous bf16 on the current card, 16-byte aligned, dp a multiple of
// 16 in [16, 192], sk >= 1 (checked by the binding); head_dim is the true
// D <= dp that sets the scale. The instance has the next of 64, 128 and
// 192 columns; TMA fills the columns past dp with zeros.
cudaError_t launch_flash_fwd_wgmma(const void* q, const void* k,
                                   const void* v, void* out, int bh,
                                   int group, int sq, int sk, int dp,
                                   int head_dim, int causal, int window,
                                   cudaStream_t stream) {
  if (bh == 0 || sq == 0) return cudaSuccess;
  if (dp > 192) return cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const float scale =
      (float)(std::pow((double)head_dim, -0.5) * 1.4426950408889634);
  if (dp <= 64)
    return launch_typed<64>(encode, q, k, v, out, bh, group, sq, sk, dp,
                            causal, window, scale, stream);
  if (dp <= 128)
    return launch_typed<128>(encode, q, k, v, out, bh, group, sq, sk, dp,
                             causal, window, scale, stream);
  return launch_typed<192>(encode, q, k, v, out, bh, group, sq, sk, dp,
                           causal, window, scale, stream);
}
