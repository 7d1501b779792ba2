// Shared-memory tiles and fragments of the flash-attention kernels (K10,
// K11) and the attention probe (K12).
//
// namespace flash, the SIMT kernels (fp32 K10/K11, K12): a block owns kRows
// rows (queries or keys) of one (batch, head), four threads a row (K12: 128
// rows of a group of heads). Thread t4 of a row's four holds the contiguous
// dims [t4 ND, (t4 + 1) ND) of the row's vectors in registers, so a dot
// product with a tile row reads that quarter of it as ND / 4 16-byte loads
// and ends in two warp shuffles. Tiles of kTile rows of a [S, 4 ND] head
// slice are staged in fp32 shared memory with every quarter row padded by 4
// floats: the four quarters a warp reads with one 16-byte load (one row,
// t4 = 0..3) then fall on distinct banks, and the eight rows of the warp
// read the same addresses (a broadcast).
//
// namespace flash_mma, the tensor-core kernels (bf16 K10/K11): below.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace flash {

constexpr int kThreads = 128;
constexpr int kRows = 32;        // rows a block owns: 4 threads each
constexpr int kTile = 32;        // rows a shared-memory tile holds

template <int ND>
struct Tile {
  static constexpr int kQuarter = ND + 4;      // a padded quarter row (floats)
  static constexpr int kRow = 4 * kQuarter;    // a padded row
  static constexpr int kFloats = kTile * kRow;
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Rows [r0, r0 + n) of a [S, 4 ND] slice of T into the padded fp32 tile,
// by a block of kBlock threads.
template <typename T, int ND, int kBlock = kThreads>
__device__ __forceinline__ void stage(float* tile, const T* slice, int r0,
                                      int n) {
  constexpr int dh = 4 * ND;
  const T* src = slice + (size_t)r0 * dh;
  for (int i = threadIdx.x; i < n * (dh / 4); i += kBlock) {
    const int e = 4 * i, r = e / dh, c = e % dh;
    float f[4];
    load_vec<T, 4>(src + e, f);
    *reinterpret_cast<float4*>(tile + r * Tile<ND>::kRow +
                               (c / ND) * Tile<ND>::kQuarter + c % ND) =
        make_float4(f[0], f[1], f[2], f[3]);
  }
}

// This thread's quarter of tile row r.
template <int ND>
__device__ __forceinline__ const float* quarter(const float* tile, int r) {
  return tile + r * Tile<ND>::kRow + (threadIdx.x & 3) * Tile<ND>::kQuarter;
}

// sum_i x[i] * row[i] over this thread's ND dims (a partial dot product).
template <int ND>
__device__ __forceinline__ float dot(const float* x, const float* row) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < ND; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(row + i);
    a += x[i] * t.x + x[i + 1] * t.y + x[i + 2] * t.z + x[i + 3] * t.w;
  }
  return a;
}

// acc[i] += w * row[i] over this thread's ND dims.
template <int ND>
__device__ __forceinline__ void axpy(float* acc, float w, const float* row) {
#pragma unroll
  for (int i = 0; i < ND; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(row + i);
    acc[i] += w * t.x;
    acc[i + 1] += w * t.y;
    acc[i + 2] += w * t.z;
    acc[i + 3] += w * t.w;
  }
}

// This thread's ND dims of row `row` of a [S, 4 ND] slice, widened to fp32
// (zeros for a row past the end).
template <typename T, int ND>
__device__ __forceinline__ void load_quarter(float* x, const T* slice,
                                             int row, bool live) {
#pragma unroll
  for (int i = 0; i < ND; i += 4) {
    if (live) {
      load_vec<T, 4>(slice + (size_t)row * (4 * ND) + (threadIdx.x & 3) * ND + i,
                     x + i);
    } else {
      x[i] = x[i + 1] = x[i + 2] = x[i + 3] = 0.f;
    }
  }
}

// This thread's ND dims of `x` (times `mul`) rounded to T, into row `row`.
template <typename T, int ND>
__device__ __forceinline__ void store_quarter(T* slice, int row,
                                              const float* x, float mul) {
#pragma unroll
  for (int i = 0; i < ND; i += 4) {
    const float f[4] = {x[i] * mul, x[i + 1] * mul, x[i + 2] * mul,
                        x[i + 3] * mul};
    store_vec<T, 4>(slice + (size_t)row * (4 * ND) + (threadIdx.x & 3) * ND + i,
                    f);
  }
}

}  // namespace flash

// ---- the bf16 tensor-core path (mma.sync m16n8k16, fp32 accumulators) ----
//
// A warp owns 16 rows; for thread (g, t) = (lane / 4, lane % 4) an A
// fragment holds rows g and g + 8 at columns 2t, 2t + 1, 2t + 8, 2t + 9, a
// B fragment column g at rows 2t, 2t + 1, 2t + 8, 2t + 9, and an
// accumulator rows g and g + 8 at columns 2t, 2t + 1. Tiles sit in shared
// memory as bf16 rows of D + 8 elements: the 8 rows a B-fragment load or an
// ldmatrix touches then fall on distinct banks.
namespace flash_mma {

constexpr int kMmaThreads = 128;     // 4 warps
constexpr int kMmaRows = 64;         // rows a block owns: 16 a warp
constexpr int kMmaKeys = 64;         // rows a shared-memory tile holds

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats rounded to bf16 (to nearest even) in one 32-bit register, lo
// in the low half: the element order of an A fragment or a store.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b for one m16n8k16 tile.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major bf16 array of pitch `pitch`.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* base, int r0,
                                       int c0, int pitch) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* p = base + (size_t)(r0 + g) * pitch + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pitch + 8);
}

// B fragments (b0, b1) of two n8 tiles, B[k][n] = tile[k0 + k][n0 + n] for
// k < 16, n < 16 (tile row-major over k, pitch `pitch`): ldmatrix .trans of
// the four 8x8 blocks; r[0], r[1] for columns n0..n0+7, r[2], r[3] for
// n0+8..n0+15.
__device__ __forceinline__ void frag_b_trans(uint32_t* r, const bf16* tile,
                                             int k0, int n0, int pitch) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
                  n0 + (lane >> 4) * 8;
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Rows [r0, r0 + n) of a [S, D] bf16 slice into a tile of kKeys rows of
// pitch D + 8, rows n.. zero (so that masked products read no garbage).
template <int D>
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* slice, int r0,
                                      int n, int rows = kMmaKeys) {
  constexpr int kChunks = D / 8;                 // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      v = *reinterpret_cast<const uint4*>(slice + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(tile + r * (D + 8) + c) = v;
  }
}

}  // namespace flash_mma
