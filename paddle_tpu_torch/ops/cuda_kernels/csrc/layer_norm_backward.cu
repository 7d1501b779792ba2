// K5: row layer norm + affine + act, backward, fp32 and bf16, for sm_90a.
//
// Replaces the backward of paddle_tpu/ops/pallas_kernels/epilogue.py
// layer_norm_act (vjp_bwd's pallas_call :373 -> _ln_bwd_kernel :323). For
// each row of x [R, K] it recomputes the mean and rstd r (as the TPU kernel
// and K3 do), x^ = (x - mean) r, z = x^ scale + bias, dz = dy act'(z)
// (identity, or relu: z > 0), dx^ = dz scale, and writes
//   dx = r (dx^ - mean(dx^) - x^ mean(dx^ x^)).
// dscale = sum_rows dz x^ and dbias = sum_rows dz come out as per-block
// partial rows [nblocks, K]; the caller sums them over the blocks outside
// the kernel, as the TPU version sums its ds_p/db_p partials in jnp
// (epilogue.py:392). x, dy and dx are fp32 or bf16 (T); scale, bias, the
// statistics, the arithmetic and the partials are fp32; a bf16 dx is
// rounded once, at the store, as the TPU kernel casts it (:336).
//
// What bounds it on this card: HBM bytes, 3 R K sizeof(T) (x and dy read
// once, dx written once); about 20 flops per element.
//
// What the design does about it: a block of 256 threads walks 16 rows one
// after another, each row in registers (up to 8 elements a thread, K <=
// 2048, neighbouring threads on neighbouring columns); the row's four sums
// are two paired block reductions. Each thread owns the same columns in
// every row, so the dscale/dbias partials stay in registers across the
// block's rows and one [K] pair per block is written at the end: 16 rows
// a block make the partials 1/8 of dx's bytes.
#include <cuda_runtime.h>
#include <math.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kRowsPerBlock = 16;

// Sum a and b over the block; every thread gets both totals.
__device__ void block_sum2(float& a, float& b, float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[w].x;
    b += red[w].y;
  }
  __syncthreads();   // red is reused by the next reduction
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, const T* __restrict__ dy,
                      T* __restrict__ dx, float* __restrict__ ds_part,
                      float* __restrict__ db_part, int R, int K, float eps,
                      int relu) {
  __shared__ float2 red[kWarps];
  float sc[kPerThread], bi[kPerThread], ds[kPerThread], db[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    sc[i] = c < K ? scale[c] : 0.f;
    bi[i] = c < K ? bias[c] : 0.f;
    ds[i] = 0.f;
    db[i] = 0.f;
  }
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(R, r0 + kRowsPerBlock);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + (size_t)row * K;
    const T* dyr = dy + (size_t)row * K;
    float xv[kPerThread], g[kPerThread];
    float sum = 0.f, unused = 0.f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      xv[i] = c < K ? to_f(xr[c]) : 0.f;
      g[i] = c < K ? to_f(dyr[c]) : 0.f;
      sum += xv[i];
    }
    block_sum2(sum, unused, red);
    const float mean = sum / K;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const float dv = c < K ? xv[i] - mean : 0.f;
      sq += dv * dv;
    }
    block_sum2(sq, unused, red);
    const float r = rsqrtf(sq / K + eps);
    float sa = 0.f, sc2 = 0.f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < K) {
        const float xh = (xv[i] - mean) * r;
        float dz = g[i];
        if (relu && !(xh * sc[i] + bi[i] > 0.f)) dz = 0.f;
        ds[i] += dz * xh;
        db[i] += dz;
        const float dxh = dz * sc[i];
        xv[i] = xh;                              // keep x^ and dx^ for dx
        g[i] = dxh;
        sa += dxh;
        sc2 += dxh * xh;
      }
    }
    block_sum2(sa, sc2, red);
    const float a = sa / K, cc = sc2 / K;
    T* dxr = dx + (size_t)row * K;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < K) dxr[c] = from_f<T>(r * (g[i] - a - xv[i] * cc));
    }
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < K) {
      ds_part[(size_t)blockIdx.x * K + c] = ds[i];
      db_part[(size_t)blockIdx.x * K + c] = db[i];
    }
  }
}

template <typename T>
int launch(const T* x, const float* scale, const float* bias, const T* dy,
           T* dx, float* ds_part, float* db_part, int R, int K, float eps,
           int act, void* stream) {
  if (R == 0) return 0;
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_bwd_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, scale, bias, dy, dx, ds_part, db_part, R, K, eps, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int layer_norm_act_backward_rows_per_block() { return kRowsPerBlock; }

// x, dy, dx: [R, K] of the entry's type; scale, bias: [K] fp32; ds_part,
// db_part: [ceil(R / rows_per_block), K] fp32.
extern "C" int layer_norm_act_backward_f32(const float* x, const float* scale,
                                           const float* bias, const float* dy,
                                           float* dx, float* ds_part,
                                           float* db_part, int R, int K,
                                           float eps, int act, void* stream) {
  return launch<float>(x, scale, bias, dy, dx, ds_part, db_part, R, K, eps,
                       act, stream);
}

extern "C" int layer_norm_act_backward_bf16(const bf16* x, const float* scale,
                                            const float* bias, const bf16* dy,
                                            bf16* dx, float* ds_part,
                                            float* db_part, int R, int K,
                                            float eps, int act, void* stream) {
  return launch<bf16>(x, scale, bias, dy, dx, ds_part, db_part, R, K, eps,
                      act, stream);
}
