// K3: row layer norm + affine + act, fp32 and bf16, for sm_90a.
//
// Replaces the forward of paddle_tpu/ops/pallas_kernels/epilogue.py:421
// layer_norm_act (_make_ln :342 -> _ln_fwd_kernel :313). Each row of x [R, K]
// is normalized over K with fp32 statistics (mean, then the mean of the
// centered squares: two passes over registers), scaled, shifted, and passed
// through identity or relu. The row's mean and variance are written too
// (the layer_norm op's Mean and Variance outputs). x and y are fp32 or bf16
// (T); scale, bias, the statistics and the arithmetic are fp32; a bf16 y is
// rounded once, at the store, as the TPU kernel casts its output
// (epilogue.py:410).
//
// What bounds it on this card: HBM bytes, 2 R K sizeof(T) (x read once, y
// written once); about 8 flops per element, far below the ridge.
//
// What the design does about it (layer_norm_rows.cuh holds the layout):
//   * one warp a row (two past K = 1024), 8 warps a block: the statistics
//     are two rounds of warp shuffles, with no shared memory and no barrier
//     on the row path (a 2048-wide row adds one shared-memory combine a
//     round);
//   * 16-byte loads (ld.global.nc) and stores, 8 bf16 or 4 fp32 a lane an
//     access, when K sizeof(T) % 16 == 0 and x, y are 16-byte aligned; a
//     scalar instantiation of the same kernel, coalesced, otherwise;
//   * a fixed grid of resident blocks walks the rows (a grid-stride loop);
//     scale and bias are read from device memory once a block, into shared
//     memory (16-byte reads there): held in registers for the whole walk
//     they would take ~40 more registers a lane, and the SM half its warps;
//   * bytes in flight by software pipelining: the next row's loads are
//     issued before the current row's reductions and sit in registers as
//     raw bits while it is reduced and stored (and the first row's before
//     scale and bias are staged). Chosen over more warps: at ~100-130
//     registers a lane the card holds 16 warps an SM, too few to cover HBM
//     latency with one row each; a second row ahead (a second set of raw
//     registers) was tried in bring-up and was not faster.
#include <cuda_runtime.h>
#include <math.h>

#include "elem.cuh"
#include "layer_norm_rows.cuh"

namespace {

using namespace ln_rows;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int KB, int W, bool VEC>
// one block an SM at least: ptxas may take every register it needs and
// spills none (at its default it spilled a few bytes in some buckets)
__global__ void __launch_bounds__(kThreads, 1)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ var_out,
                  int R, int K, float eps, int relu) {
  using G = Geo<T, KB, W>;
  constexpr int E = G::E, NV = G::NV, V = G::V, RPB = kWarps / W;
  __shared__ float red[2][RPB][W];
  __shared__ __align__(16) float sp[2][KB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / W, wi = warp % W;
  const long long step = (long long)gridDim.x * RPB;

  uint4 raw[NV] = {};
  long long row = (long long)blockIdx.x * RPB + grp;
  if (row < R) load_raw<T, NV, VEC>(x + row * K, K, wi, lane, raw);
  stage_params<KB, kThreads>(scale, bias, K, sp);
  __syncthreads();
  // every warp of a block walks the same number of turns (the barriers of
  // a row held by W > 1 warps); a row past R computes and stores nothing
  for (long long base = (long long)blockIdx.x * RPB; base < R; base += step) {
    row = base + grp;
    const bool live = row < R;
    float v[V];
    unpack<T, NV>(raw, v);
    if (row + step < R) load_raw<T, NV, VEC>(x + (row + step) * K, K, wi, lane, raw);

    // columns past K hold 0
    const float mean = row_sum<W>(tree_sum<V>(v), red[0], grp, wi, lane) / K;
    float d2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = inside<E, NV, VEC>(wi, lane, i, K) ? v[i] - mean : 0.f;
      d2[i] = d * d;
    }
    const float var = row_sum<W>(tree_sum<V>(d2), red[1], grp, wi, lane) / K;
    const float rstd = rsqrtf(var + eps);
    if (live) {
      float sc[V], bi[V];
      read_param<E, NV, VEC>(sp[0], wi, lane, sc);
      read_param<E, NV, VEC>(sp[1], wi, lane, bi);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float z = (v[i] - mean) * rstd * sc[i] + bi[i];
        if (relu) z = relu_f(z);
        v[i] = z;
      }
      store_row<T, NV, VEC>(y + row * K, K, wi, lane, v);
      if (lane == 0 && wi == 0) {
        mean_out[row] = mean;
        var_out[row] = var;
      }
    }
  }
}

template <typename T, int KB, int W, bool VEC>
int launch_bucket(const T* x, const float* scale, const float* bias, T* y,
                  float* mean, float* var, int R, int K, float eps, int act,
                  cudaStream_t stream) {
  static const int resident = resident_blocks(
      (const void*)layer_norm_kernel<T, KB, W, VEC>, kThreads);
  constexpr int rpb = kWarps / W;
  const long long groups = ((long long)R + rpb - 1) / rpb;
  const int grid = (int)(groups < resident ? groups : resident);
  layer_norm_kernel<T, KB, W, VEC><<<grid, kThreads, 0, stream>>>(
      x, scale, bias, y, mean, var, R, K, eps, act);
  return (int)cudaGetLastError();
}

template <typename T, int KB, int W>
int launch_layout(const T* x, const float* scale, const float* bias, T* y,
                  float* mean, float* var, int R, int K, float eps, int act,
                  cudaStream_t stream) {
  const bool vec = (K * sizeof(T)) % 16 == 0 && aligned16(x) && aligned16(y);
  return vec ? launch_bucket<T, KB, W, true>(x, scale, bias, y, mean, var, R,
                                             K, eps, act, stream)
             : launch_bucket<T, KB, W, false>(x, scale, bias, y, mean, var, R,
                                              K, eps, act, stream);
}

template <typename T>
int launch(const T* x, const float* scale, const float* bias, T* y,
           float* mean, float* var, int R, int K, float eps, int act,
           void* stream) {
  if (R == 0) return 0;
  if (R < 0 || K < 1 || K > 2048) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 256) return launch_layout<T, 256, 1>(x, scale, bias, y, mean, var, R, K, eps, act, s);
  if (K <= 512) return launch_layout<T, 512, 1>(x, scale, bias, y, mean, var, R, K, eps, act, s);
  if (K <= 768) return launch_layout<T, 768, 1>(x, scale, bias, y, mean, var, R, K, eps, act, s);
  if (K <= 1024) return launch_layout<T, 1024, 1>(x, scale, bias, y, mean, var, R, K, eps, act, s);
  return launch_layout<T, 2048, 2>(x, scale, bias, y, mean, var, R, K, eps, act, s);
}

}  // namespace

// x, y: [R, K] of the entry's type, K <= 2048; scale, bias: [K] fp32;
// mean, var: [R] fp32.
extern "C" int layer_norm_act_f32(const float* x, const float* scale,
                                  const float* bias, float* y, float* mean,
                                  float* var, int R, int K, float eps, int act,
                                  void* stream) {
  return launch<float>(x, scale, bias, y, mean, var, R, K, eps, act, stream);
}

extern "C" int layer_norm_act_bf16(const bf16* x, const float* scale,
                                   const float* bias, bf16* y, float* mean,
                                   float* var, int R, int K, float eps, int act,
                                   void* stream) {
  return launch<bf16>(x, scale, bias, y, mean, var, R, K, eps, act, stream);
}
