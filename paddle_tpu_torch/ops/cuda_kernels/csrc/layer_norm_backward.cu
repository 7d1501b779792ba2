// K5: row layer norm + affine + act, backward, fp32 and bf16, for sm_90a.
//
// Replaces the backward of paddle_tpu/ops/pallas_kernels/epilogue.py
// layer_norm_act (vjp_bwd's pallas_call :373 -> _ln_bwd_kernel :323). For
// each row of x [R, K] it recomputes the mean and rstd r (as the TPU kernel
// and K3 do: the mean, then the mean of the centered squares), x^ = (x -
// mean) r, z = x^ scale + bias, dz = dy act'(z) (identity, or relu: z > 0),
// dx^ = dz scale, and writes
//   dx = r (dx^ - mean(dx^) - x^ mean(dx^ x^)),
// dscale = sum_rows dz x^ and dbias = sum_rows dz. x, dy and dx are fp32 or
// bf16 (T); scale, bias, the statistics and the arithmetic are fp32; a bf16
// dx is rounded once, at the store, as the TPU kernel casts it (:336).
//
// What bounds it on this card: HBM bytes, 3 R K sizeof(T) (x and dy read
// once, dx written once); about 20 flops per element, far below the ridge.
//
// What the design does about it (layer_norm_rows.cuh holds the layout):
//   * one warp a row up to K = 768 (two warps to 1024, four to 2048, so a
//     lane holds at most 24 or 16 values of each of x, dy, dscale, dbias and
//     scale without spilling), 4 warps a block; the row's sums are three
//     rounds of warp shuffles: sum x, then sum (x - m)^2 (the TPU's two
//     passes; pairing them would need E[x^2] - m^2), then sum dx^ and sum
//     dx^ x^ paired in one round. No shared memory and no barrier on the
//     row path of a one-warp row;
//   * 16-byte ld.global.nc loads of x and dy and 16-byte stores of dx when
//     K sizeof(T) % 16 == 0 and x, dy, dx are 16-byte aligned; a scalar
//     instantiation of the same kernel, coalesced, otherwise;
//   * software pipelining: the next row's x and dy are loaded into
//     registers, as raw bits, before the current row's reductions (scale
//     staged in shared memory, the column sums kept in the warp's shared
//     memory, and a second row ahead were each tried in bring-up to free
//     registers for more warps or bytes in flight, and none was faster);
//   * dscale and dbias: a lane owns the same columns in every row its warp
//     walks and sums dz x^ and dz for them in registers, in row order. The
//     grid is fixed (the blocks the card holds at once, as the occupancy
//     calculator gives them for the instantiation, and no more than the
//     rows need), so at the end the block's warps combine in shared memory,
//     in warp order, into one partial row a block, [blocks, K], and a second
//     kernel of this source sums the partials over the blocks in a fixed
//     order. No atomics: dx, dscale and dbias repeat bit for bit from launch
//     to launch on the same inputs and card.
#include <cuda_runtime.h>
#include <math.h>

#include "elem.cuh"
#include "layer_norm_rows.cuh"

namespace {

using namespace ln_rows;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSumCols = 32;     // partial-sum kernel: columns a block
constexpr int kSumSlices = 16;   // and slices of the blocks' partials

template <typename T, int KB, int W, bool VEC, bool RELU>
// one block an SM at least: ptxas may take every register it needs and
// spills none (at its default it spilled a few bytes in some buckets)
__global__ void __launch_bounds__(kThreads, 1)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, const T* __restrict__ dy,
                      T* __restrict__ dx, float* __restrict__ part, int R,
                      int K, float eps) {
  using G = Geo<T, KB, W>;
  constexpr int E = G::E, NV = G::NV, V = G::V, RPB = kWarps / W;
  __shared__ float red[2][RPB][W];
  __shared__ float2 red2[RPB][W];
  __shared__ float comb[2][RPB][KB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / W, wi = warp % W;
  const long long step = (long long)gridDim.x * RPB;

  uint4 rx[NV] = {}, rd[NV] = {};
  long long row = (long long)blockIdx.x * RPB + grp;
  if (row < R) {
    load_raw<T, NV, VEC>(x + row * K, K, wi, lane, rx);
    load_raw<T, NV, VEC>(dy + row * K, K, wi, lane, rd);
  }
  float sc[V], bi[RELU ? V : 1], ds[V], db[V];
  load_param<E, NV, VEC>(scale, K, wi, lane, sc);
  if constexpr (RELU) load_param<E, NV, VEC>(bias, K, wi, lane, bi);
#pragma unroll
  for (int i = 0; i < V; ++i) ds[i] = db[i] = 0.f;

  // every warp of a block walks the same number of turns (the barriers of
  // a row held by W > 1 warps); a row past R adds and stores nothing
  for (long long base = (long long)blockIdx.x * RPB; base < R; base += step) {
    row = base + grp;
    const bool live = row < R;
    float xv[V], g[V];
    unpack<T, NV>(rx, xv);
    unpack<T, NV>(rd, g);
    if (row + step < R) {
      load_raw<T, NV, VEC>(x + (row + step) * K, K, wi, lane, rx);
      load_raw<T, NV, VEC>(dy + (row + step) * K, K, wi, lane, rd);
    }

    // columns past K hold 0
    const float mean = row_sum<W>(tree_sum<V>(xv), red[0], grp, wi, lane) / K;
    float t[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = inside<E, NV, VEC>(wi, lane, i, K) ? xv[i] - mean : 0.f;
      t[i] = d * d;
    }
    const float r =
        rsqrtf(row_sum<W>(tree_sum<V>(t), red[1], grp, wi, lane) / K + eps);
#pragma unroll
    for (int i = 0; i < V; ++i) {   // past K dy and scale are 0: dz, dx^ are 0
      const float xh = (xv[i] - mean) * r;
      float dz = g[i];
      if constexpr (RELU) {
        if (!(xh * sc[i] + bi[i] > 0.f)) dz = 0.f;
      }
      if (live) {
        ds[i] += dz * xh;
        db[i] += dz;
      }
      const float dxh = dz * sc[i];
      xv[i] = xh;                                // keep x^ and dx^ for dx
      g[i] = dxh;
      t[i] = dxh * xh;
    }
    float sa = tree_sum<V>(g), sc2 = tree_sum<V>(t);
    row_sum2<W>(sa, sc2, red2, grp, wi, lane);
    const float a = sa / K, cc = sc2 / K;
    if (live) {
#pragma unroll
      for (int i = 0; i < V; ++i) g[i] = r * (g[i] - a - xv[i] * cc);
      store_row<T, NV, VEC>(dx + row * K, K, wi, lane, g);
    }
  }

  // the block's partial row: its row groups' sums added in group order
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = col<E, NV, VEC>(wi, lane, i / E, i % E);
    comb[0][grp][c] = ds[i];
    comb[1][grp][c] = db[i];
  }
  __syncthreads();
  float* ds_part = part + (size_t)blockIdx.x * K;
  float* db_part = part + ((size_t)gridDim.x + blockIdx.x) * K;
  for (int c = threadIdx.x; c < K; c += kThreads) {
    float a = comb[0][0][c], b = comb[1][0][c];
#pragma unroll
    for (int gi = 1; gi < RPB; ++gi) {
      a += comb[0][gi][c];
      b += comb[1][gi][c];
    }
    ds_part[c] = a;
    db_part[c] = b;
  }
}

// dscale (blockIdx.y 0) or dbias (1): the blocks' partial rows [G, K] summed
// over G in a fixed order, kSumSlices strided slices of G a column and then
// the slices in order.
__global__ void __launch_bounds__(kSumCols * kSumSlices)
layer_norm_bwd_sum_kernel(const float* __restrict__ part,
                          float* __restrict__ dscale,
                          float* __restrict__ dbias, int G, int K) {
  constexpr int kAcc = 4;        // independent sums a thread, for loads in flight
  __shared__ float red[kSumSlices][kSumCols + 1];
  const int cx = threadIdx.x % kSumCols, gy = threadIdx.x / kSumCols;
  const int c = blockIdx.x * kSumCols + cx;
  const float* p = part + (size_t)blockIdx.y * G * K + c;
  float s[kAcc] = {};
  if (c < K) {
    int gi = gy;
    for (; gi + (kAcc - 1) * kSumSlices < G; gi += kAcc * kSumSlices)
#pragma unroll
      for (int u = 0; u < kAcc; ++u) s[u] += p[(size_t)(gi + u * kSumSlices) * K];
    for (; gi < G; gi += kSumSlices) s[0] += p[(size_t)gi * K];
  }
  red[gy][cx] = (s[0] + s[1]) + (s[2] + s[3]);
  __syncthreads();
  if (gy == 0 && c < K) {
    float t = red[0][cx];
#pragma unroll
    for (int i = 1; i < kSumSlices; ++i) t += red[i][cx];
    (blockIdx.y ? dbias : dscale)[c] = t;
  }
}

// The blocks of the row kernel for R rows: those the card holds at once
// (the 16-byte instantiation's occupancy; the scalar one takes the same
// grid), and no more than the rows need.
template <typename T, int KB, int W, bool RELU>
int blocks_bucket(int R) {
  static const int resident = resident_blocks(
      (const void*)layer_norm_bwd_kernel<T, KB, W, true, RELU>, kThreads);
  constexpr int rpb = kWarps / W;
  const long long groups = ((long long)R + rpb - 1) / rpb;
  return (int)(groups < resident ? groups : resident);
}

template <typename T, bool RELU>
int blocks_act(int R, int K) {
  if (K <= 256) return blocks_bucket<T, 256, 1, RELU>(R);
  if (K <= 512) return blocks_bucket<T, 512, 1, RELU>(R);
  if (K <= 768) return blocks_bucket<T, 768, 1, RELU>(R);
  if (K <= 1024) return blocks_bucket<T, 1024, 2, RELU>(R);
  return blocks_bucket<T, 2048, 4, RELU>(R);
}

template <typename T>
int blocks(int R, int K, int act) {
  if (R < 1 || K < 1 || K > 2048) return 0;
  return act ? blocks_act<T, true>(R, K) : blocks_act<T, false>(R, K);
}

template <typename T, int KB, int W, bool RELU>
int launch_bucket(const T* x, const float* scale, const float* bias,
                  const T* dy, T* dx, float* part, int R, int K, float eps,
                  int grid, cudaStream_t stream) {
  const bool vec = (K * sizeof(T)) % 16 == 0 && aligned16(x) && aligned16(dy)
                   && aligned16(dx);
  if (vec)
    layer_norm_bwd_kernel<T, KB, W, true, RELU><<<grid, kThreads, 0, stream>>>(
        x, scale, bias, dy, dx, part, R, K, eps);
  else
    layer_norm_bwd_kernel<T, KB, W, false, RELU><<<grid, kThreads, 0, stream>>>(
        x, scale, bias, dy, dx, part, R, K, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool RELU>
int launch_act(const T* x, const float* scale, const float* bias, const T* dy,
               T* dx, float* part, int R, int K, float eps, int grid,
               cudaStream_t s) {
  if (K <= 256) return launch_bucket<T, 256, 1, RELU>(x, scale, bias, dy, dx, part, R, K, eps, grid, s);
  if (K <= 512) return launch_bucket<T, 512, 1, RELU>(x, scale, bias, dy, dx, part, R, K, eps, grid, s);
  if (K <= 768) return launch_bucket<T, 768, 1, RELU>(x, scale, bias, dy, dx, part, R, K, eps, grid, s);
  if (K <= 1024) return launch_bucket<T, 1024, 2, RELU>(x, scale, bias, dy, dx, part, R, K, eps, grid, s);
  return launch_bucket<T, 2048, 4, RELU>(x, scale, bias, dy, dx, part, R, K, eps, grid, s);
}

template <typename T>
int launch(const T* x, const float* scale, const float* bias, const T* dy,
           T* dx, float* dscale, float* dbias, float* part, int R, int K,
           float eps, int act, int grid, void* stream) {
  if (R == 0) return 0;
  if (R < 0 || K < 1 || K > 2048 || grid != blocks<T>(R, K, act))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = act ? launch_act<T, true>(x, scale, bias, dy, dx, part, R, K, eps, grid, s)
                     : launch_act<T, false>(x, scale, bias, dy, dx, part, R, K, eps, grid, s);
  if (rc) return rc;
  layer_norm_bwd_sum_kernel<<<dim3((K + kSumCols - 1) / kSumCols, 2),
                              kSumCols * kSumSlices, 0, s>>>(part, dscale,
                                                             dbias, grid, K);
  return (int)cudaGetLastError();
}

}  // namespace

// The blocks of the row kernel for R rows of K with act (0 identity, 1
// relu): the first dimension of the partials the entries below take.
extern "C" int layer_norm_act_backward_blocks_f32(int R, int K, int act) {
  return blocks<float>(R, K, act);
}

extern "C" int layer_norm_act_backward_blocks_bf16(int R, int K, int act) {
  return blocks<bf16>(R, K, act);
}

// x, dy, dx: [R, K] of the entry's type, K <= 2048; scale, bias, dscale,
// dbias: [K] fp32; part: [2, grid, K] fp32 scratch, grid the blocks the
// entry above gives for (R, K, act).
extern "C" int layer_norm_act_backward_f32(const float* x, const float* scale,
                                           const float* bias, const float* dy,
                                           float* dx, float* dscale,
                                           float* dbias, float* part, int R,
                                           int K, float eps, int act,
                                           int grid, void* stream) {
  return launch<float>(x, scale, bias, dy, dx, dscale, dbias, part, R, K, eps,
                       act, grid, stream);
}

extern "C" int layer_norm_act_backward_bf16(const bf16* x, const float* scale,
                                            const float* bias, const bf16* dy,
                                            bf16* dx, float* dscale,
                                            float* dbias, float* part, int R,
                                            int K, float eps, int act,
                                            int grid, void* stream) {
  return launch<bf16>(x, scale, bias, dy, dx, dscale, dbias, part, R, K, eps,
                      act, grid, stream);
}
