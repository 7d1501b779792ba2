// Hopper building blocks of the bf16 flash-attention kernels (K10, K11),
// the attention probe (K12) and the bottleneck block (#15): TMA tile copies
// into 128-byte-swizzled shared memory, completing on the mbarriers of
// sm90.cuh, TMA stores back, ldmatrix / stmatrix, and warpgroup products
// (wgmma.mma_async m64nNk16, bf16 in, fp32 out).
//
// A tile of `rows` rows of a [B nh, S, dh] bf16 tensor lands in shared
// memory as dh / 64 swizzle atoms of rows x 128 bytes, atom a holding
// columns [64 a, 64 a + 64): element (r, c) of atom a sits at byte
// r * 128 + ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2, the layout TMA writes
// under CU_TENSOR_MAP_SWIZZLE_128B from a 1024-byte-aligned address. Rows
// past S are zero-filled by the copy engine (the map is 3-D over [B nh, S,
// dh], so the edge is per head). A wgmma reads such a tile through a
// matrix descriptor in one of two forms:
//   * K-major (the product's reduction runs along the row: Q, K, dO and V
//     as A or as B of Q K^T, dO V^T): start at row r0 and k step kk (16
//     columns) = atom kk / 4, byte r0 * 128 + (kk % 4) * 32; stride byte
//     offset (SBO) 1024 between 8-row groups;
//   * MN-major, "transposed" (the reduction runs down the rows: V in P V,
//     K in dS K, dO and Q in the key pass): k step kk = rows [16 kk, 16 kk
//     + 16), byte 16 kk * 128; SBO 1024 between 8-row groups along k, and
//     the leading byte offset (LBO) rows * 128 between the 64-column atoms
//     along n.
// The accumulator of m64nN, for warp w of the warpgroup and lane (g, t) =
// (lane / 4, lane % 4): d[4 i + e] is row 16 w + g + 8 (e / 2), column
// 8 i + 2 t + (e % 2), the layout of mma.sync's m16n8 tiles side by side.
// A register A operand of m64k16 is mma.sync's A fragment: a[0] row g,
// columns 2t, 2t+1; a[1] row g + 8; a[2], a[3] the same at columns + 8; so
// the accumulator of columns [16 kk, 16 kk + 16) packs to bf16 into it as
// a = {d[8kk..9], d[8kk+2..3], d[8kk+4..5], d[8kk+6..7]} (pack_a).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "sm90.cuh"

namespace flash_wg {

using namespace sm90;

// A block: consumer warpgroups that multiply (two, threads 0-255; K10 takes
// three at dh = 64), and a producer warpgroup after them whose first thread
// issues the copies into a ring of stages. Stage s has a "full" barrier
// (the copies landed) and an "empty" one (every consumer warpgroup is done
// with it: one arrival each). The producer gives its registers to the
// consumers (setmaxnreg: 128 x 40 + 256 x 232, or 128 x 24 + 384 x 160, of
// the SM's 65,536).
constexpr int kConsumers = 256;
constexpr int kBlockThreads = kConsumers + 128;

// This thread's warp, as a value the compiler knows to be warp-uniform (so
// that the branches on a warpgroup's role or rows hold no wgmma in a
// divergent path).
__device__ __forceinline__ int warp_id() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
}

// ---- TMA loads, completing on an mbarrier ----
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// The same under an L2 policy (l2_policy, l2_evict_last).
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      ::"r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "l"(policy) : "memory");
}
// L2 policies for copies: a tile read once is evicted first, so that it,
// and not a line still to be written back or read again, makes room for
// the next (else evict-normal); a tile read again soon is evicted last.
__device__ __forceinline__ uint64_t l2_policy(bool once) {
  uint64_t p;
  if (once)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                 : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// Rows [r0, r0 + ROWS) of head bh of a [B nh, S, D] map into a tile of
// D / 64 atoms (the map's box is 64 x ROWS); bytes: ROWS * D * 2.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(bf16* tile, const CUtensorMap* map,
                                         uint64_t* bar, int r0, int bh) {
#pragma unroll
  for (int a = 0; a < D / 64; ++a)
    tma_load3(tile + a * ROWS * 64, map, bar, 64 * a, r0, bh);
}

// ---- TMA stores from shared memory (a bulk group of the issuing thread;
// fence_async_smem first, stores_read / stores_done of sm90.cuh after) ----
__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           const void* src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"((uint64_t)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ---- ldmatrix / stmatrix at per-lane shared addresses ----
// Four 8x8 bf16 matrices: lanes 8 m .. 8 m + 7 give the row addresses of
// matrix m, register m of thread (g, t) holds its row g, columns 2t, 2t+1
// (an m16k16 A fragment when lane L addresses row L % 16, column 8 (L / 16)).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void stsm4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// ---- wgmma ----
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);                   // 128-byte swizzle
}
// K-major operand: rows [r0, r0 + 64) (A) or all rows (B) of a ROWS-row
// tile, k step kk.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int r0, int kk) {
  return desc(tile + (kk >> 2) * ROWS * 64 + r0 * 64 + (kk & 3) * 16, 16,
              1024);
}
// MN-major operand: k rows [16 kk, 16 kk + 16) of a ROWS-row tile, every
// column.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return desc(tile + kk * 16 * 64, ROWS * 128, 1024);
}

// The producer warpgroup gives up registers, the consumers take them
// (setmaxnreg; the two roles must not reconverge).
template <int N = 40>
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}
template <int N = 232>
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of an accumulator across the
// asynchronous products that own it.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Columns [16 kk, 16 kk + 16) of an accumulator as a register A operand.
template <int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[R],
                                       int kk) {
  a[0] = pack2(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2(d[8 * kk + 6], d[8 * kk + 7]);
}

// d (m64nN, N = 2 R) = A B + (acc ? d : 0) over k16: A and B from shared
// memory (ss) or A from registers (rs); TB = 1 reads B MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

// ---- host: the tensor maps ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime (the
// libraries link no libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A `rank`-D map (2 or 3) over a bf16 tensor of sizes dims[] (innermost
// first, contiguous), box box[], 128-byte swizzle (box[0] = 64), zeros
// outside. Returns 0 or a CUDA error.
inline int map_bf16(CUtensorMap* m, const bf16* base, int rank,
                    const cuuint64_t* dims, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, (void*)base, dims,
            strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : (int)cudaErrorInvalidValue;
}
// A 3-D map over a [BH, S, dh] bf16 tensor, box 64 columns x `rows` rows of
// one head, 128-byte swizzle, zeros past S. Returns 0 or a CUDA error.
inline int map_heads(CUtensorMap* m, const bf16* base, int BH, int S, int dh,
                     int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return map_bf16(m, base, 3, dims, box);
}

// The shared-memory address `raw` rounded up to 1024 bytes (the swizzle
// atoms' alignment); a kernel asks for 1024 bytes more than it lays out.
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

}  // namespace flash_wg
