// #15: the fused bf16 ResNet bottleneck chain, for sm_90a.
//
// Replaces tools/_rn_pallas_block.py:64 pallas_block (body `kernel` :42):
// for x [B, H, W, C] bf16 (NHWC) and bf16 weights w1 [C, M], w2 [3, 3, M, M]
// (HWIO), w3 [M, C],
//   y1  = bf16(relu(x . w1))                         1x1, C -> M
//   y2  = bf16(relu(sum_{dy,dx} shift(y1) . w2[dy, dx]))   3x3, stride 1, pad 1
//   out = bf16(relu(y2 . w3 + x))                    1x1, M -> C, residual in fp32
// with fp32 accumulation everywhere, rounded where the tool's kernel rounds.
// No batch norm and no bias: the tool's kernel has none.
//
// What bounds it on this card: at the tool's shape (B=128, 56x56, C=256,
// M=64) the bytes: x read once and out written once, 2 x 205.5 MB over
// 3.35 TB/s = 0.123 ms, against 55.9 GFLOP over 989 TFLOP/s = 0.057 ms.
// The two 64-channel intermediates never touch device memory.
//
// What the TPU design relies on and what this one does instead. The TPU
// kernel takes one image a grid step and keeps the whole 1.6 MB activation
// and a padded y1 in VMEM. A Hopper block has at most 227 KB of shared
// memory, so a block takes a strip of R = 4 output rows of one image
// (B*H/4 blocks, 1792 at the tool's shape, about 14 per SM), and:
//   1. computes y1 for its R + 2 rows (the 3x3's halo rows are recomputed:
//      (R+2)/R of the first product) into shared memory as [R+2][W+2][M]
//      with zero columns at both ends and zero rows outside the image,
//      streaming x through shared memory 48 pixels at a time, w1 staged;
//   2. computes y2 for its R rows as 9 shifted [R W, M] x [M, M] products
//      read straight from the padded y1, w2 staged; y2 stays in shared
//      memory;
//   3. computes y2 . w3 (w3 staged), adds the residual x (the strip's rows
//      were read in phase 1, so this second read mostly hits L2), applies
//      relu and writes out.
// R = 4 is the largest strip whose phase-2 working set (y1 [6][58][72], w2
// and y2, pitches padded by 8 elements against bank conflicts) fits one
// block in shared memory at W = 56, M = 64 (165 KB), and 4 W = 224 pixels
// is a whole number of 16-row tiles. Weights are staged by phase, never all
// resident at once, transposed so each B fragment is a 32-bit load.
// The products run on the tensor cores through warp-level
// mma.sync.m16n8k16 bf16 with fp32 accumulators (8 warps; a warp owns a
// 16-pixel by 16-channel output tile at a time, its A fragment reused over
// two n8 tiles). wgmma and TMA are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;           // output rows a block owns
constexpr int kGroup = 48;         // pixels of x staged at a time in phase 1
constexpr int kPad = 8;            // elements added to every shared row
constexpr int kMaxSmem = 232448;   // the block's limit on sm_90

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// d += a . b for one m16n8k16 tile: a row-major 16x16, b 16x8 given as its
// transpose (n-major), fp32 accumulators.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += A[16 x K] . Bt[16 n x K]^T over two n8 tiles j, K a multiple of
// 16. a_lo/a_hi: this thread's A rows (g, g + 8) at column 2t; bt: row
// (n0 + g) of the transposed B at column 2t, pitch bp.
__device__ __forceinline__ void tile_k(float (*acc)[4], const bf16* a_lo,
                                       const bf16* a_hi, const bf16* bt,
                                       int bp, int K) {
  for (int k = 0; k < K; k += 16) {
    const uint32_t a[4] = {ld32(a_lo + k), ld32(a_hi + k), ld32(a_lo + k + 8),
                           ld32(a_hi + k + 8)};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* b = bt + j * 8 * bp + k;
      mma16816(acc[j], a, ld32(b), ld32(b + 8));
    }
  }
}

// dst[n][k] = src[k][n] for a [K, N] bf16 matrix, into pitch dp.
__device__ __forceinline__ void stage_t(bf16* dst, const bf16* src, int K,
                                        int N, int dp) {
  for (int i = threadIdx.x; i < K * N; i += kThreads) {
    const int k = i / N, n = i % N;
    dst[n * dp + k] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                  bf16* __restrict__ out, int H, int W, int C, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int MP = M + kPad, CP = C + kPad;
  const int y1_elems = (kRows + 2) * (W + 2) * MP;
  bf16* Y1 = reinterpret_cast<bf16*>(smem);            // [R+2][W+2][MP]
  bf16* Y2 = Y1 + y1_elems;                            // [R W][MP]
  bf16* WR = Y2 + kRows * W * MP;                      // the phase's weights
  const int strip = blockIdx.x, b = blockIdx.y;
  const int r0 = strip * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ---- phase 1: y1 for rows r0-1 .. r0+R of the image ------------------
  bf16* W1t = WR;                                      // [M][CP]
  bf16* Xs = WR + M * CP;                              // [kGroup][CP]
  stage_t(W1t, w1, C, M, CP);
  for (int i = threadIdx.x; i < (kRows + 2) * 2 * M; i += kThreads) {
    const int rr = i / (2 * M), side = (i / M) & 1, n = i % M;
    Y1[(rr * (W + 2) + (side ? W + 1 : 0)) * MP + n] = from_f<bf16>(0.f);
  }
  const int units1 = (kGroup / 16) * (M / 16);
  for (int p0 = 0; p0 < (kRows + 2) * W; p0 += kGroup) {
    __syncthreads();                                   // Xs free, W1t staged
    for (int i = threadIdx.x; i < kGroup * (C / 8); i += kThreads) {
      const int px = i / (C / 8), c8 = i % (C / 8);
      const int p = p0 + px, row = r0 - 1 + p / W;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);            // rows off the image: 0
      if (row >= 0 && row < H)
        v = *reinterpret_cast<const uint4*>(
            x + (((size_t)b * H + row) * W + p % W) * C + c8 * 8);
      *reinterpret_cast<uint4*>(Xs + px * CP + c8 * 8) = v;
    }
    __syncthreads();
    for (int u = warp; u < units1; u += kWarps) {
      const int mt = u / (M / 16), n0 = (u % (M / 16)) * 16;
      float acc[2][4] = {};
      const bf16* a_lo = Xs + (mt * 16 + g) * CP + 2 * t;
      tile_k(acc, a_lo, a_lo + 8 * CP, W1t + (n0 + g) * CP + 2 * t, CP, C);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + mt * 16 + g + 8 * h;
        bf16* dst = Y1 + ((p / W) * (W + 2) + p % W + 1) * MP + n0 + 2 * t;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          st_pair(dst + j * 8, fmaxf(acc[j][2 * h], 0.f),
                  fmaxf(acc[j][2 * h + 1], 0.f));
      }
    }
  }
  __syncthreads();                                     // y1 complete

  // ---- phase 2: y2 = relu(sum of 9 shifted products) -------------------
  bf16* W2t = WR;                                      // [9][M][MP]
  for (int tap = 0; tap < 9; ++tap)
    stage_t(W2t + tap * M * MP, w2 + (size_t)tap * M * M, M, M, MP);
  __syncthreads();
  const int units2 = (kRows * W / 16) * (M / 16);
  for (int u = warp; u < units2; u += kWarps) {
    const int mt = u / (M / 16), n0 = (u % (M / 16)) * 16;
    const int p_lo = mt * 16 + g, p_hi = p_lo + 8;
    // output pixel (r, c) reads y1 row r + dy, padded column c + dx
    const bf16* a_lo = Y1 + ((p_lo / W) * (W + 2) + p_lo % W) * MP + 2 * t;
    const bf16* a_hi = Y1 + ((p_hi / W) * (W + 2) + p_hi % W) * MP + 2 * t;
    float acc[2][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * (W + 2) + tap % 3) * MP;
      tile_k(acc, a_lo + off, a_hi + off,
             W2t + (tap * M + n0 + g) * MP + 2 * t, MP, M);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bf16* dst = Y2 + (mt * 16 + g + 8 * h) * MP + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        st_pair(dst + j * 8, fmaxf(acc[j][2 * h], 0.f),
                fmaxf(acc[j][2 * h + 1], 0.f));
    }
  }
  __syncthreads();                                     // y2 complete, W2t free

  // ---- phase 3: out = relu(y2 . w3 + x) --------------------------------
  bf16* W3t = WR;                                      // [C][MP]
  stage_t(W3t, w3, M, C, MP);
  __syncthreads();
  const int units3 = (kRows * W / 16) * (C / 16);
  for (int u = warp; u < units3; u += kWarps) {
    const int mt = u / (C / 16), n0 = (u % (C / 16)) * 16;
    const bf16* a_lo = Y2 + (mt * 16 + g) * MP + 2 * t;
    float acc[2][4] = {};
    tile_k(acc, a_lo, a_lo + 8 * MP, W3t + (n0 + g) * MP + 2 * t, MP, M);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      const size_t o = (((size_t)b * H + r0 + p / W) * W + p % W) * C + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(x + o + j * 8);
        st_pair(out + o + j * 8,
                fmaxf(acc[j][2 * h] + __low2float(r), 0.f),
                fmaxf(acc[j][2 * h + 1] + __high2float(r), 0.f));
      }
    }
  }
}

}  // namespace

// The dynamic shared memory a block needs, or 0 when it is over the limit.
extern "C" int bottleneck_block_smem_bytes(int W, int C, int M) {
  const long long MP = M + kPad, CP = C + kPad;
  const long long phase1 = (long long)M * CP + (long long)kGroup * CP;
  const long long phase2 = 9LL * M * MP;
  const long long phase3 = (long long)C * MP;
  long long wr = phase1 > phase2 ? phase1 : phase2;
  wr = wr > phase3 ? wr : phase3;
  const long long bytes =
      2 * ((kRows + 2LL) * (W + 2) * MP + (long long)kRows * W * MP + wr);
  return bytes > kMaxSmem ? 0 : (int)bytes;
}

// x, out: [B, H, W, C] bf16; w1 [C, M], w2 [3, 3, M, M], w3 [M, C] bf16.
// Takes H % 4 == 0, W % 8 == 0, C and M multiples of 16 (the wrapper
// checks), and a shared-memory footprint within the block's limit.
extern "C" int bottleneck_block_bf16(const bf16* x, const bf16* w1,
                                     const bf16* w2, const bf16* w3, bf16* out,
                                     int B, int H, int W, int C, int M,
                                     void* stream) {
  if (B == 0) return 0;
  const int bytes = bottleneck_block_smem_bytes(W, C, M);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / kRows, B);
  bottleneck_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, w1, w2, w3, out, H, W, C, M);
  return (int)cudaGetLastError();
}
