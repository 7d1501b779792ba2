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
// Two kernels, by shape (the wrapper's plan, bottleneck.py `plan`, picks):
//
// bottleneck_wg_kernel<KC>, M = 64, C = 64 KC (KC = 1..4), W <= 63: on
// wgmma and TMA. One block an SM (grid = min(SMs, tiles)) walks a fixed,
// contiguous run of the (image, tile) list, a tile being 64 consecutive
// pixels of one image in flat h W + w order (the last tile of an image may
// be short). Pixels are flat so that every product is a whole m64 wgmma
// whatever W is: a 56-pixel image row is not. A block of 192 threads:
//   * a producer warp whose first thread loads the weights once by TMA
//     (w1, the nine w2 taps and w3, each in the 128-byte-swizzled layout a
//     wgmma descriptor reads, MN-major: [k rows][64 n], so no transpose),
//     then streams x, a [64 pixels][64 channels] atom at a time, through a
//     ring of 4 atoms (3-D map over [B, H W, C]; pixels past H W come back
//     zero), in the order product 1 takes them, under an evict-last L2
//     policy;
//   * a second producer warp whose first thread copies each output tile's
//     x again, for its residual, into a ring of 4 atoms (evict-first: these
//     reads hit L2, where the tile went a step before);
//   * one consumer warpgroup. For output tile j of image b it needs y1 of
//     tiles j-1, j and j+1 (a 3x3 neighbour is at most W + 1 <= 64 pixels
//     away). Within a run y1 rolls: each y1 tile is computed once, into a
//     ring of 3 tiles in shared memory, so only the tile before and after
//     a run's first and last outputs is computed twice (about 4 of every
//     48 at the tool's shape, against 2 of every 4 rows for 4-row strips).
//     A step: product 1 for y1 tile j+1 (wgmma m64n64k16, A = the x atoms
//     through K-major descriptors, B = w1), its x atoms released at once,
//     relu, bf16, stmatrix into the y1 ring (rows 128 bytes, 16-byte chunks
//     XOR-swizzled by row % 8); product 2 for tile j: nine taps of 4
//     k-steps, A gathered from the y1 ring by ldmatrix at per-lane row
//     addresses (the neighbour pixel p + (dy-1) W + dx-1 of each output
//     pixel, or a zero row where it is off the image), fed as a register
//     operand (wgmma_rs) with B = the tap, a tap's gather overlapping the
//     last tap's products; relu and bf16 of y2 in registers, packed as the
//     register A operand of product 3 (the accumulator-to-A reuse K10 makes
//     of P); product 3 in KC chunks of 64 output channels (B = w3's atom),
//     each chunk's relu(y3 + x) computed from the residual atom (ldmatrix)
//     and written back over it (stmatrix); then one barrier and KC TMA
//     stores. A tile's residual atoms go back to their producer once the
//     stores have read them, while the next step's product 1 runs. x is
//     read from device memory once and out written once, in whole sectors.
//   Measured against the alternatives (`flash_ab.py --kernels variants`,
//   H100 80GB HBM3 at 700 W, ms at the tool's shape, each pair from one
//   call): without the L2 policies 0.1970-0.2000, with them 0.1882-0.1888;
//   product 3 as two m64n128 chunks 0.1947-0.1965 against 0.1970-0.2000;
//   one A buffer in product 2 0.2030-0.2043 against 0.1970-0.2000; the
//   residual loaded into registers by 4-byte loads (an x ring of 6 atoms,
//   2 output atoms, a barrier a chunk) 0.2284-0.2295 against 0.1957-0.1960;
//   the residual held in an x ring of 8 atoms from product 1 to the
//   epilogue (two tiles held, so the next tile's copy waited for a tile's
//   stores) 0.2531-0.2544.
//   Shared memory (KC = 4): w1 32 KB + w2 72 KB + w3 32 KB + y1 ring 24 KB
//   + x ring 32 KB + residual ring 32 KB + 1 KB of alignment = 230,400
//   bytes (dynamic), plus about 160 bytes of barriers and a zero row: one
//   block an SM. All the sums run in a fixed order, so two calls give the
//   same bits.
//
// bottleneck_kernel, every other shape the wrapper takes (C, M multiples
// of 16, H % 4 == 0, W % 8 == 0, a strip within a block's shared memory):
// a block takes a strip of 4 output rows of one image, recomputes y1 for
// its 6 rows into shared memory ([6][W+2][M], zero columns and rows at the
// image's edges), then y2 and out, on warp-level mma.sync.m16n8k16 with
// each phase's weights staged transposed. Blocks loop over images past
// the grid's 65535 in y.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace flash_wg;

// ---------------------------------------------------------------------------
// bottleneck_wg_kernel: M = 64, C = 64 KC, W <= 63
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 192;        // the consumer warpgroup + 2 producers
constexpr int kAtom = 64 * 64;         // elements of a [64][64] swizzled atom
constexpr int kXStages = 4;            // x atoms in the ring
constexpr int kOutStages = 4;          // residual / output atoms
constexpr int kY1Tiles = 3;            // y1 tiles in the ring
constexpr int kY1Rows = 64 * kY1Tiles;

// Dynamic shared memory of bottleneck_wg_kernel<KC>: w1 (KC atoms), w2 (9),
// w3 (KC), the y1 ring (3), the x ring (4) and the residual / output ring
// (4), and 1024 bytes to align.
constexpr int wg_smem_bytes(int KC) {
  return 1024 + 2 * kAtom * (2 * KC + 9 + kY1Tiles + kXStages + kOutStages);
}

// The block's run of the (image, tile) list, one image at a time.
struct Run {
  long long g, end;
  int T;
  // The next segment: image b, output tiles [ja, jb); false at the end.
  __device__ bool next(int& b, int& ja, int& jb) {
    if (g >= end) return false;
    b = (int)(g / T);
    ja = (int)(g - (long long)b * T);
    const long long left = end - g;
    jb = left < T - ja ? ja + (int)left : T;
    g += jb - ja;
    return true;
  }
};

__device__ __forceinline__ void wg_bar() {         // the consumers only
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The ring-row address of y1 row q (q >= 0) at 16-byte chunk c.
__device__ __forceinline__ uint32_t y1_addr(uint32_t ring, int q, int c) {
  return ring + (uint32_t)(q % kY1Rows) * 128u + (uint32_t)((c ^ (q & 7)) << 4);
}

template <int KC>
__global__ void __launch_bounds__(kWgThreads, 1)
bottleneck_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w2map,
                     const __grid_constant__ CUtensorMap w3map, int B, int H,
                     int W, int T) {
  constexpr int C = 64 * KC;
  extern __shared__ unsigned char smem_raw[];
  bf16* w1_s = reinterpret_cast<bf16*>(align1024(smem_raw));   // [C][64]
  bf16* w2_s = w1_s + KC * kAtom;                              // 9 x [64][64]
  bf16* w3_s = w2_s + 9 * kAtom;                               // KC x [64][64]
  bf16* y1_s = w3_s + KC * kAtom;                              // [192][64]
  bf16* x_s = y1_s + kY1Tiles * kAtom;                         // 4 x [64][64]
  bf16* o_s = x_s + kXStages * kAtom;                          // 4 x [64][64]
  __shared__ uint64_t wbar, x_full[kXStages], x_empty[kXStages],
      o_full[kOutStages], o_empty[kOutStages];
  __shared__ __align__(16) uint4 zero_row;
  const int tid = threadIdx.x, wid = warp_id();
  const long long N = (long long)B * T;
  Run run{blockIdx.x * N / gridDim.x, (blockIdx.x + 1) * N / gridDim.x, T};
  if (tid == 0) {
    mbar_init(&wbar, 1);
    for (int i = 0; i < kXStages; ++i) {
      mbar_init(&x_full[i], 1);
      mbar_init(&x_empty[i], 1);
    }
    for (int i = 0; i < kOutStages; ++i) {
      mbar_init(&o_full[i], 1);
      mbar_init(&o_empty[i], 1);
    }
    zero_row = make_uint4(0u, 0u, 0u, 0u);
    mbar_fence_init();
  }
  __syncthreads();

  if (wid == 4) {                       // the weights and the x ring
    if (tid != 128) return;
    mbar_expect(&wbar, (2 * KC + 9) * kAtom * 2);
    tma_load2(w1_s, &w1map, &wbar, 0, 0);
    for (int t = 0; t < 9; ++t) tma_load2(w2_s + t * kAtom, &w2map, &wbar, 0, 64 * t);
    for (int a = 0; a < KC; ++a) tma_load2(w3_s + a * kAtom, &w3map, &wbar, 64 * a, 0);
    const uint64_t keep = l2_evict_last();   // read again for the residual
    int n = 0, b, ja, jb;
    while (run.next(b, ja, jb)) {
      const int y_end = min(T - 1, jb);
      for (int y = max(0, ja - 1); y <= y_end; ++y)
        for (int a = 0; a < KC; ++a, ++n) {
          const int st = n % kXStages;
          if (n >= kXStages) mbar_wait(&x_empty[st], (n / kXStages - 1) & 1);
          mbar_expect(&x_full[st], kAtom * 2);
          tma_load3(x_s + st * kAtom, &xmap, &x_full[st], 64 * a, 64 * y, b,
                    keep);
        }
    }
    return;
  }
  if (wid == 5) {                       // the residual ring: x of each output tile
    if (tid != 160) return;
    const uint64_t once = l2_policy(true);   // x's last read
    int m = 0, b, ja, jb;
    while (run.next(b, ja, jb))
      for (int j = ja; j < jb; ++j)
        for (int a = 0; a < KC; ++a, ++m) {
          const int st = m % kOutStages;
          if (m >= kOutStages) mbar_wait(&o_empty[st], (m / kOutStages - 1) & 1);
          mbar_expect(&o_full[st], kAtom * 2);
          tma_load3(o_s + st * kAtom, &xmap, &o_full[st], 64 * a, 64 * j, b,
                    once);
        }
    return;
  }

  // ---- the consumer warpgroup: warp w owns accumulator rows 16w..16w+15
  const int lane = tid & 31, warp = wid;
  const bool lead = tid == 0;
  const int HW = H * W;
  const uint32_t y1_ring = smem_u32(y1_s), o_ring = smem_u32(o_s),
                 zero = smem_u32(&zero_row);
  const int lrow = 16 * warp + (lane & 15), lhalf = lane >> 4;
  mbar_wait(&wbar, 0);

  // m: the residual ring's count at this tile; the lead releases a tile's
  // atoms once its stores have read them, while the next step's product 1
  // runs
  int n = 0, m = 0, done = -1, b, ja, jb;
  while (run.next(b, ja, jb)) {
    int next_y = max(0, ja - 1);
    for (int j = ja; j < jb; ++j) {
      // product 1: y1 tiles up to j + 1
      for (; next_y <= min(T - 1, j + 1); ++next_y, n += KC) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        wg_fence();
#pragma unroll
        for (int a = 0; a < KC; ++a) {
          const int st = (n + a) % kXStages;
          mbar_wait(&x_full[st], ((n + a) / kXStages) & 1);
          const bf16* xa = x_s + st * kAtom;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<1>(acc, desc_k<64>(xa, 0, kk), desc_mn<C>(w1_s, 4 * a + kk),
                        a | kk);
        }
        wg_commit();
        if (lead && done >= 0) {        // the last tile's stores have read
          stores_read<0>();
          for (int a = 0; a < KC; ++a) mbar_arrive(&o_empty[(done + a) % kOutStages]);
          done = -1;
        }
        wg_wait<0>();
        reg_fence(acc);
        if (lead)
          for (int a = 0; a < KC; ++a) mbar_arrive(&x_empty[(n + a) % kXStages]);
        const int q = next_y * 64 + lrow;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          uint32_t r[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            r[e] = pack2(relu_f(acc[8 * h + 2 * e]),
                         relu_f(acc[8 * h + 2 * e + 1]));
          stsm4(y1_addr(y1_ring, q, 2 * h + lhalf), r);
        }
      }
      wg_bar();                         // y1 of tiles j-1 .. j+1 visible
      if (lead && done >= 0) {          // a step with no product 1
        stores_read<0>();
        for (int a = 0; a < KC; ++a) mbar_arrive(&o_empty[(done + a) % kOutStages]);
        done = -1;
      }

      // product 2: the nine taps, A gathered from the y1 ring
      const int p = j * 64 + lrow;      // this lane's output pixel
      const int ph = p / W, pw = p - ph * W;
      auto gather = [&](uint32_t (&af)[4][4], int tap) {
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const bool on = p < HW && ph + dy >= 0 && ph + dy < H && pw + dx >= 0 &&
                        pw + dx < W;
        const int q = p + dy * W + dx;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm4(af[kk], on ? y1_addr(y1_ring, q, 2 * kk + lhalf) : zero);
      };
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      uint32_t af[2][4][4];
      gather(af[0], 0);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(acc, af[tap & 1][kk], desc_mn<64>(w2_s + tap * kAtom, kk),
                      tap | kk);
        wg_commit();
        if (tap < 8) {
          wg_wait<1>();                 // tap - 1's products have read their A
          reg_fence(af[(tap + 1) & 1]);
          gather(af[(tap + 1) & 1], tap + 1);
        }
      }
      wg_wait<0>();
      reg_fence(acc);
      uint32_t ya[4][4];                // y2 = bf16(relu(.)), product 3's A
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = relu_f(acc[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(ya[kk], acc, kk);

      // product 3 and the epilogue, 64 output channels at a time: the
      // residual atom (copied a tile ahead) takes relu(y3 + x) in place
#pragma unroll
      for (int a = 0; a < KC; ++a) {
        float o[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;
        reg_fence(ya);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(o, ya[kk], desc_mn<64>(w3_s + a * kAtom, kk), kk);
        wg_commit();
        wg_wait<0>();
        reg_fence(o);
        const int st = (m + a) % kOutStages;
        mbar_wait(&o_full[st], ((m + a) / kOutStages) & 1);
        const uint32_t oa = o_ring + (uint32_t)(st * kAtom * 2);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const uint32_t addr =
              oa + (uint32_t)lrow * 128u +
              (uint32_t)(((2 * h + lhalf) ^ (lrow & 7)) << 4);
          uint32_t r[4];
          ldsm4(r, addr);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            r[e] = pack2(
                relu_f(o[8 * h + 2 * e] + __uint_as_float(r[e] << 16)),
                relu_f(o[8 * h + 2 * e + 1]
                       + __uint_as_float(r[e] & 0xffff0000u)));
          stsm4(addr, r);
        }
      }
      fence_async_smem();
      wg_bar();
      if (lead) {
        for (int a = 0; a < KC; ++a)
          tma_store3(&omap, o_s + ((m + a) % kOutStages) * kAtom, 64 * a,
                     64 * j, b);
        done = m;
      }
      m += KC;
    }
  }
  if (lead) stores_done();
}

// ---------------------------------------------------------------------------
// bottleneck_kernel: mma.sync, every other shape
// ---------------------------------------------------------------------------

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
                  bf16* __restrict__ out, int B, int H, int W, int C, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int MP = M + kPad, CP = C + kPad;
  const int y1_elems = (kRows + 2) * (W + 2) * MP;
  bf16* Y1 = reinterpret_cast<bf16*>(smem);            // [R+2][W+2][MP]
  bf16* Y2 = Y1 + y1_elems;                            // [R W][MP]
  bf16* WR = Y2 + kRows * W * MP;                      // the phase's weights
  const int strip = blockIdx.x;
  const int r0 = strip * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int b = blockIdx.y; b < B; b += gridDim.y) {
  __syncthreads();                                     // the last image done

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
          st_pair(dst + j * 8, relu_f(acc[j][2 * h]),
                  relu_f(acc[j][2 * h + 1]));
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
        st_pair(dst + j * 8, relu_f(acc[j][2 * h]),
                relu_f(acc[j][2 * h + 1]));
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
                relu_f(acc[j][2 * h] + __low2float(r)),
                relu_f(acc[j][2 * h + 1] + __high2float(r)));
      }
    }
  }
  }
}

}  // namespace

// The dynamic shared memory of the wgmma kernel for C = 64 KC.
extern "C" int bottleneck_block_wg_smem_bytes(int KC) {
  return KC >= 1 && KC <= 4 ? wg_smem_bytes(KC) : 0;
}

// The dynamic shared memory a block of the mma.sync kernel needs, or 0 when
// it is over the limit.
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

// x, out: [B, H, W, C] bf16; w1 [C, M], w2 [3, 3, M, M], w3 [M, C] bf16, all
// 16-byte aligned. M = 64, C = 64 KC (KC = 1..4), W <= 63 (the wrapper's
// plan checks); `grid` blocks, at most one an SM, walk the B ceil(H W / 64)
// tiles.
extern "C" int bottleneck_block_wg_bf16(const bf16* x, const bf16* w1,
                                        const bf16* w2, const bf16* w3,
                                        bf16* out, int B, int H, int W, int C,
                                        int M, int grid, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const int KC = C / 64;
  if (M != 64 || C % 64 || KC < 1 || KC > 4 || W > 63 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int HW = H * W, T = (HW + 63) / 64;
  CUtensorMap xm, om, w1m, w2m, w3m;
  const cuuint64_t xd[3] = {(cuuint64_t)C, (cuuint64_t)HW, (cuuint64_t)B};
  const cuuint32_t xb[3] = {64, 64, 1};
  const cuuint64_t w1d[2] = {64, (cuuint64_t)C}, w2d[2] = {64, 9 * 64},
                   w3d[2] = {(cuuint64_t)C, 64};
  const cuuint32_t w1b[2] = {64, (cuuint32_t)C}, ab[2] = {64, 64};
  int rc = map_bf16(&xm, x, 3, xd, xb);
  if (!rc) rc = map_bf16(&om, out, 3, xd, xb);
  if (!rc) rc = map_bf16(&w1m, w1, 2, w1d, w1b);
  if (!rc) rc = map_bf16(&w2m, w2, 2, w2d, ab);
  if (!rc) rc = map_bf16(&w3m, w3, 2, w3d, ab);
  if (rc) return rc;
  const int bytes = wg_smem_bytes(KC);
  cudaStream_t st = (cudaStream_t)stream;
  switch (KC) {
#define BOTTLENECK_WG(K)                                                      \
  case K:                                                                     \
    rc = (int)cudaFuncSetAttribute(bottleneck_wg_kernel<K>,                   \
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                   bytes);                                    \
    if (rc) return rc;                                                        \
    bottleneck_wg_kernel<K><<<grid, kWgThreads, bytes, st>>>(xm, om, w1m, w2m, \
                                                             w3m, B, H, W, T); \
    break;
    BOTTLENECK_WG(1)
    BOTTLENECK_WG(2)
    BOTTLENECK_WG(3)
    BOTTLENECK_WG(4)
#undef BOTTLENECK_WG
  }
  return (int)cudaGetLastError();
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
  dim3 grid(H / kRows, B < 65535 ? B : 65535);
  bottleneck_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, w1, w2, w3, out, B, H, W, C, M);
  return (int)cudaGetLastError();
}
