// Shared-memory tiles and fragments of the flash-attention kernels (K10,
// K11), the attention probe (K12) and the bf16 short-sequence attention
// kernels (K2, K4).
//
// namespace flash, the SIMT layout of the attention probe (K12): a block
// owns rows of a group of heads, four threads a row. Thread t4 of a row's
// four holds the contiguous dims [t4 ND, (t4 + 1) ND) of the row's vectors
// in registers, so a dot product with a tile row reads that quarter of it
// as ND / 4 16-byte loads and ends in two warp shuffles. Tiles of kTile
// rows of a [S, 4 ND] head slice are staged in fp32 shared memory with
// every quarter row padded by 4 floats: the four quarters a warp reads with
// one 16-byte load (one row, t4 = 0..3) then fall on distinct banks, and the
// eight rows of the warp read the same addresses (a broadcast).
//
// namespace flash_mma, the mma.sync kernels (bf16 K2, K4; bf16 K10 and K11
// run on wgmma, flash_wgmma.cuh), and
// namespace flash_simt, the register-tiled fp32 kernels (K2, K4, K10, K11):
// below.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace flash {

constexpr int kThreads = 128;
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

// ---- the bf16 mma.sync path (m16n8k16, fp32 accumulators; K2, K4) ----
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

// B fragments (b0, b1) of two n8 tiles, B[k][n] = tile[n0 + n][k0 + k] for
// k < 16, n < 16 (tile row-major over n, pitch a multiple of 8): ldmatrix of
// the four 8x8 blocks; r[0], r[1] for columns n0..n0+7, r[2], r[3] for
// n0+8..n0+15.
__device__ __forceinline__ void frag_b(uint32_t* r, const bf16* tile, int n0,
                                       int k0, int pitch) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (n0 + (lane & 7) + ((lane >> 4) & 1) * 8) * pitch +
                  k0 + ((lane >> 3) & 1) * 8;
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The A fragment of a transpose, A[m][k] = base[r0 + k][c0 + m] for m, k <
// 16, of a row-major bf16 array of pitch `pitch` (a multiple of 8):
// ldmatrix .trans of its four 8x8 blocks.
__device__ __forceinline__ void frag_a_trans(uint32_t* a, const bf16* base,
                                             int r0, int c0, int pitch) {
  const int lane = threadIdx.x & 31;
  const bf16* p = base + (r0 + (lane & 7) + ((lane >> 4) & 1) * 8) * pitch +
                  c0 + ((lane >> 3) & 1) * 8;
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// c[j] (n8 tile j) += A B^T over D: A = rows [r0, r0 + 16) of a_s, B^T =
// the rows of b_t, both [*, D + 8] bf16 tiles; pairs of tiles at or past
// column `nend` are skipped.
template <int D, int JT>
__device__ __forceinline__ void mma_abt(float (&c)[JT][4], const bf16* a_s,
                                        int r0, const bf16* b_t, int nend) {
  constexpr int P = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, a_s, r0, kk * 16, P);
#pragma unroll
    for (int j = 0; j < JT; j += 2) {
      if (j * 8 < nend) {
        uint32_t b[4];
        frag_b(b, b_t, j * 8, kk * 16, P);
        mma(c[j], a, b[0], b[1]);
        mma(c[j + 1], a, b[2], b[3]);
      }
    }
  }
}

// Asynchronous copies from device to shared memory (cp.async): issued,
// grouped by commit, and waited for until at most N groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + n) of a [*, dh] bf16 slice into the first `rows` rows of a
// tile of pitch D + 8 (D: dh rounded up to a multiple of 16) by cp.async
// from kThr threads; rows n.. and columns dh.. get zeros by plain stores,
// so that products over the padding read zeros. dh % 4 == 0: whole 16-byte
// chunks where dh % 8 == 0, else 8-byte halves (a row of the slice then
// starts on an 8-byte boundary only). Visible after cp_wait and a barrier.
template <int D, int kThr>
__device__ __forceinline__ void stage_async(bf16* tile, const bf16* slice,
                                            int r0, int n, int rows, int dh) {
  constexpr int kChunks = D / 8;                 // 16-byte chunks a row
  const bool whole = (dh & 7) == 0;
  const uint2 zero = make_uint2(0u, 0u);
  for (int i = threadIdx.x; i < rows * kChunks; i += kThr) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    bf16* dst = tile + r * (D + 8) + c;
    const bf16* src = slice + (size_t)(r0 + r) * dh + c;
    const int live = r < n ? dh - c : 0;         // elements left in the row
    if (live >= 8 && whole) {
      cp_async16(dst, src);
    } else {
      if (live >= 4) cp_async8(dst, src);
      else *reinterpret_cast<uint2*>(dst) = zero;
      if (live >= 8) cp_async8(dst + 4, src + 4);
      else *reinterpret_cast<uint2*>(dst + 4) = zero;
    }
  }
}

}  // namespace flash_mma

// ---- the fp32 path (K2, K4, K10, K11): register micro-tiles, CUDA cores ----
//
// A block of 16 RG threads owns 8 RG rows of one (b, h) (queries; keys in
// the key passes) and streams tiles of kCols = 64 rows of the other side
// through shared memory (attention_f32.cuh holds the kernels' bodies).
// Thread (rg, cg) = (tid / 16, tid % 16) owns rows rg + RG i (i < 8) and,
// of a 64-row tile, the columns cg + 16 j (j < 4): an 8 x 4 micro-tile of
// scores in registers; of a [rows, D] accumulator, the dims 64 h + 4 cg + e
// (h < D / 64, e < 4): an 8 x D / 16 micro-tile. A row group is a
// half-warp, so a row statistic is reduced by four shuffles inside it, once
// a tile. Tiles sit in fp32 shared memory row-major, rows of D + 4 floats,
// staged by 16-byte cp.async straight from the [S, dh] slice (dh <= D;
// columns dh.. zero-filled, so products over them add zeros). A product
// step reads 4 dims of each of its 8 + 4 rows as one 16-byte load and does
// 8 x 4 x 4 FMAs with them, so a shared float feeds 4 or 8 FMAs. The two
// rows a warp reads at once are adjacent (4 banks apart: one wavefront);
// the 16 tile rows cg + 16 j of a half-warp cover the 32 banks twice (two
// wavefronts for 256 bytes, the least). Score tiles (P, dS) pass through a
// buffer of rows of 64 + 16 floats (128 + 16 in K4's head kernel): a warp's
// two rows sit 16 banks apart, so the scalar stores of a micro-tile do not
// collide.
namespace flash_simt {

constexpr int kTM = 8;               // rows a thread owns
constexpr int kTN = 4;               // columns of a score tile a thread owns
constexpr int kCols = 16 * kTN;      // rows of a streamed tile
constexpr int kPitchS = kCols + 16;  // a row of a score buffer (floats)

template <int D>
constexpr int kPitch = D + 4;        // a row of a [*, D] tile (floats)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The max and the sum over the 16 threads of a row group.
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [r0, r0 + n) of a [*, dh] fp32 slice (dh <= D, dh % 4 == 0, so a
// row starts on a 16-byte boundary when the slice does) into rows [0, rows)
// of a tile of pitch D + 4 by 16-byte cp.async from kThr threads; rows n..
// and columns dh.. get zeros by plain stores, so that products over them
// read zeros. Visible after cp_wait and a barrier.
template <int D, int kThr>
__device__ __forceinline__ void stage_rows(float* tile, const float* slice,
                                           int r0, int n, int rows,
                                           int dh) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThr) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float* dst = tile + r * kPitch<D> + c;
    if (r < n && (dh == D || c < dh))
      flash_mma::cp_async16(dst, slice + (size_t)(r0 + r) * dh + c);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Rows [r0, r0 + n) of a [*, dh] fp32 slice set to zero by kThr threads,
// 16 bytes a store (a kv_len 0 head, keys past kv_len).
template <int kThr>
__device__ __forceinline__ void zero_rows(float* slice, int r0, int n,
                                          int dh) {
  float4* p = reinterpret_cast<float4*>(slice + (size_t)r0 * dh);
  for (int i = threadIdx.x; i < n * dh / 4; i += kThr)
    p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// c[i][j] += sum_d a[rg + RG i][d] * b[cg + 16 j][d] over d < D, in order
// of d (a, b: tiles of pitch D + 4): S = Q K^T and its kin.
template <int D, int RG>
__device__ __forceinline__ void fma_abt(float (&c)[kTM][kTN], const float* a,
                                        const float* b, int rg, int cg) {
  constexpr int P = kPitch<D>;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 bv[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) bv[j] = ld4(b + (cg + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float4 av = ld4(a + (rg + RG * i) * P + d);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        c[i][j] = fmaf(av.x, bv[j].x, c[i][j]);
        c[i][j] = fmaf(av.y, bv[j].y, c[i][j]);
        c[i][j] = fmaf(av.z, bv[j].z, c[i][j]);
        c[i][j] = fmaf(av.w, bv[j].w, c[i][j]);
      }
    }
  }
}

// c[i][4 h + e] += sum_k w[rg + RG i][k] * b[k][64 h + 4 cg + e] over the
// kCols rows of b, in order of k (w: a score buffer of pitch PW; b: a tile
// of pitch D + 4): O += P V and its kin.
template <int D, int RG, int PW = kPitchS>
__device__ __forceinline__ void fma_ab(float (&c)[kTM][D / 16],
                                       const float* w, const float* b, int rg,
                                       int cg) {
  constexpr int P = kPitch<D>, H = D / 64;
#pragma unroll 2
  for (int k = 0; k < kCols; k += 4) {
    float4 wv[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) wv[i] = ld4(w + (rg + RG * i) * PW + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 bv[H];
#pragma unroll
      for (int h = 0; h < H; ++h) bv[h] = ld4(b + (k + kk) * P + 64 * h + 4 * cg);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float x = kk == 0 ? wv[i].x : kk == 1 ? wv[i].y
                      : kk == 2 ? wv[i].z : wv[i].w;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          c[i][4 * h] = fmaf(x, bv[h].x, c[i][4 * h]);
          c[i][4 * h + 1] = fmaf(x, bv[h].y, c[i][4 * h + 1]);
          c[i][4 * h + 2] = fmaf(x, bv[h].z, c[i][4 * h + 2]);
          c[i][4 * h + 3] = fmaf(x, bv[h].w, c[i][4 * h + 3]);
        }
      }
    }
  }
}

// c[i][4 h + e] += sum_k w[k][r0 + i] * b[k][64 h + 4 cg + e] over k < nk,
// in order of k (w: a score buffer of pitch PW read down its columns r0..
// r0 + 7, two 16-byte loads a k; b: a tile of pitch D + 4): dV = P^T dO and
// its kin, for a thread that owns the 8 adjacent rows r0.. of the output.
template <int D, int PW>
__device__ __forceinline__ void fma_atb(float (&c)[kTM][D / 16],
                                        const float* w, const float* b, int r0,
                                        int cg, int nk) {
  constexpr int P = kPitch<D>, H = D / 64;
#pragma unroll 4
  for (int k = 0; k < nk; ++k) {
    const float4 w0 = ld4(w + k * PW + r0), w1 = ld4(w + k * PW + r0 + 4);
    const float x[kTM] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    float4 bv[H];
#pragma unroll
    for (int h = 0; h < H; ++h) bv[h] = ld4(b + k * P + 64 * h + 4 * cg);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        c[i][4 * h] = fmaf(x[i], bv[h].x, c[i][4 * h]);
        c[i][4 * h + 1] = fmaf(x[i], bv[h].y, c[i][4 * h + 1]);
        c[i][4 * h + 2] = fmaf(x[i], bv[h].z, c[i][4 * h + 2]);
        c[i][4 * h + 3] = fmaf(x[i], bv[h].w, c[i][4 * h + 3]);
      }
    }
  }
}

// This thread's dims of row `row` of a [*, dh] slice (dh <= D: columns
// dh.. are not stored), from c (times mul).
template <int D>
__device__ __forceinline__ void store_dims(float* slice, int row,
                                           const float (&c)[D / 16], float mul,
                                           int cg, int dh) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h) {
    const int col = 64 * h + 4 * cg;
    if (dh == D || col < dh)
      *reinterpret_cast<float4*>(slice + (size_t)row * dh + col) =
          make_float4(c[4 * h] * mul, c[4 * h + 1] * mul, c[4 * h + 2] * mul,
                      c[4 * h + 3] * mul);
  }
}

}  // namespace flash_simt
