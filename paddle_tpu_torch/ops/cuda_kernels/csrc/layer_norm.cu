// K3: row layer norm + affine + act, fp32 and bf16, for sm_90a.
//
// Replaces the forward of paddle_tpu/ops/pallas_kernels/epilogue.py:421
// layer_norm_act (_make_ln :342 -> _ln_fwd_kernel :313). Each row of x [R, K]
// is normalized over K with fp32 statistics (mean, then the mean of the
// centered squares), scaled, shifted, and passed through identity or relu.
// The row's mean and variance are written too (the layer_norm op's Mean and
// Variance outputs). x and y are fp32 or bf16 (T); scale, bias, the
// statistics and the arithmetic are fp32; a bf16 y is rounded once, at the
// store, as the TPU kernel casts its output (epilogue.py:410).
//
// What bounds it on this card: HBM bytes, 2 R K sizeof(T) (x read once, y
// written once); about 8 flops per element.
//
// What the design does about it: one block of 256 threads per row keeps the
// whole row in registers (up to 8 elements a thread, K <= 2048), so x is
// read once and y written once with neighbouring threads on neighbouring
// addresses; both statistics are block reductions (warp shuffles, then one
// shared-memory step across the 8 warps) over the registers.
#include <cuda_runtime.h>
#include <math.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;

__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();   // red is reused by the next reduction
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ var_out,
                  int K, float eps, int relu) {
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  float vals[kPerThread];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    vals[i] = c < K ? to_f(xr[c]) : 0.f;
    sum += vals[i];
  }
  const float mean = block_sum(sum, red) / K;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const float d = c < K ? vals[i] - mean : 0.f;
    sq += d * d;
  }
  const float var = block_sum(sq, red) / K;
  const float rstd = rsqrtf(var + eps);
  T* yr = y + row * K;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < K) {
      float z = (vals[i] - mean) * rstd * scale[c] + bias[c];
      if (relu) z = fmaxf(z, 0.f);
      yr[c] = from_f<T>(z);
    }
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}

template <typename T>
int launch(const T* x, const float* scale, const float* bias, T* y,
           float* mean, float* var, int R, int K, float eps, int act,
           void* stream) {
  if (R == 0) return 0;
  layer_norm_kernel<T><<<R, kThreads, 0, (cudaStream_t)stream>>>(
      x, scale, bias, y, mean, var, K, eps, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [R, K] of the entry's type; scale, bias: [K] fp32; mean, var: [R]
// fp32.
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
