// K8: batch-norm apply epilogue, forward, fp32 and bf16, for sm_90a.
//
// Replaces the forward of paddle_tpu/ops/pallas_kernels/epilogue.py
// bn_apply_act (:280; _apply_call_fwd :142 -> pallas_call :151, body
// _apply_fwd_kernel :91). Given per-channel statistics it computes, in one
// visit of x,
//   y = act((x - mean) * (inv * scale) + bias [+ residual]),
// act identity or relu, in the TPU kernel's order of operations, for both
// canonical 2-D layouts:
//   "cl" (NHWC): x [R = N*H*W, C], the parameter of a column is p[col];
//   "cr" (NCHW): x [R = N*C, HW],  the parameter of a row is p[row % C]
//                (the TPU version pre-tiles its parameters to [N*C, 1]).
// x, the residual and y are fp32 or bf16 (T); the parameters are fp32 and
// the arithmetic is fp32 in registers; a bf16 y is rounded once, at the
// store, where the TPU kernel casts (epilogue.py:98).
//
// What bounds it on this card: HBM bytes, 2 or 3 R*row*sizeof(T) (x and the
// residual read once, y written once); 4 flops per element.
//
// What the design does about it: any R is taken and the tail is masked (the
// TPU grid needs a row tile that divides R). "cl": a block of 256 threads is
// TX column groups by TY rows, TX the power of two that covers C/VEC (or
// C), so a warp reads whole contiguous rows; a thread keeps its columns'
// parameters in registers and walks its strip of rows with 16-byte
// accesses (4 fp32 or 8 bf16). C not a multiple of VEC, or a pointer off 16
// bytes, takes the same kernel with one element per access. "cr": one warp
// per row (49 values at ResNet's last stage, 3136 at its first), the row's
// one parameter set in registers, 16-byte accesses when HW % VEC == 0 and
// scalar otherwise (rows of 49 start off 16 bytes).
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_apply_cl_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, const float* __restrict__ mean,
                   const float* __restrict__ inv, const T* __restrict__ res,
                   T* __restrict__ y, int R, int C, int TX,
                   int rows_per_block, int relu) {
  const int TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int groups = C / VEC;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)R, r0 + rows_per_block);
  for (int g = tx; g < groups; g += TX) {
    const int c = g * VEC;
    float s[VEC], b[VEC], m[VEC], v[VEC], a[VEC];
    load_vec<float, VEC>(scale + c, s);
    load_vec<float, VEC>(bias + c, b);
    load_vec<float, VEC>(mean + c, m);
    load_vec<float, VEC>(inv + c, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = v[k] * s[k];
    for (long long r = r0 + ty; r < r1; r += TY) {
      const size_t off = (size_t)r * C + c;
      float z[VEC];
      load_vec<T, VEC>(x + off, z);
#pragma unroll
      for (int k = 0; k < VEC; ++k) z[k] = (z[k] - m[k]) * a[k] + b[k];
      if (res != nullptr) {
        float rv[VEC];
        load_vec<T, VEC>(res + off, rv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) z[k] += rv[k];
      }
      if (relu) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) z[k] = relu_f(z[k]);
      }
      store_vec<T, VEC>(y + off, z);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_apply_cr_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, const float* __restrict__ mean,
                   const float* __restrict__ inv, const T* __restrict__ res,
                   T* __restrict__ y, int R, int HW, int C, int relu) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const int lane = threadIdx.x & 31;
  const int c = (int)(row % C);
  const float a = inv[c] * scale[c], b = bias[c], m = mean[c];
  const size_t base = (size_t)row * HW;
  for (int i = lane * VEC; i < HW; i += 32 * VEC) {
    float z[VEC];
    load_vec<T, VEC>(x + base + i, z);
#pragma unroll
    for (int k = 0; k < VEC; ++k) z[k] = (z[k] - m) * a + b;
    if (res != nullptr) {
      float rv[VEC];
      load_vec<T, VEC>(res + base + i, rv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) z[k] += rv[k];
    }
    if (relu) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) z[k] = relu_f(z[k]);
    }
    store_vec<T, VEC>(y + base + i, z);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int pow2_cover(int n, int cap) {
  int t = 1;
  while (t < n && t < cap) t <<= 1;
  return t;
}

// VEC: the elements of T in 16 bytes.
template <typename T>
int launch(const T* x, const float* scale, const float* bias,
           const float* mean, const float* inv, const T* res, T* y, int R,
           int row, int C, int mode, int act, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (R == 0 || row == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = row % VEC == 0 && aligned16(x) && aligned16(y) &&
                   (res == nullptr || aligned16(res));
  if (mode == 0) {
    const bool pvec = vec && aligned16(scale) && aligned16(bias) &&
                      aligned16(mean) && aligned16(inv);
    const int groups = pvec ? C / VEC : C;
    const int TX = pow2_cover(groups, kThreads), TY = kThreads / TX;
    // about four rows a thread, fewer when R is short
    int iters = (R + TY * 1024 - 1) / (TY * 1024);
    iters = iters < 1 ? 1 : (iters > 4 ? 4 : iters);
    const int rows_per_block = TY * iters;
    const int blocks = (R + rows_per_block - 1) / rows_per_block;
    if (pvec)
      bn_apply_cl_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, y, R, C, TX, rows_per_block, act);
    else
      bn_apply_cl_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, y, R, C, TX, rows_per_block, act);
  } else {
    const int blocks = (R + kWarps - 1) / kWarps;
    if (vec)
      bn_apply_cr_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, y, R, row, C, act);
    else
      bn_apply_cr_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, y, R, row, C, act);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (and res, or null): [R, row] of the entry's type; scale/bias/mean/
// inv: [C] fp32. mode 0 = "cl" (row == C), mode 1 = "cr" (R % C == 0);
// act 0 = identity, 1 = relu.
extern "C" int bn_apply_act_f32(const float* x, const float* scale,
                                const float* bias, const float* mean,
                                const float* inv, const float* res, float* y,
                                int R, int row, int C, int mode, int act,
                                void* stream) {
  return launch<float>(x, scale, bias, mean, inv, res, y, R, row, C, mode,
                       act, stream);
}

extern "C" int bn_apply_act_bf16(const bf16* x, const float* scale,
                                 const float* bias, const float* mean,
                                 const float* inv, const bf16* res, bf16* y,
                                 int R, int row, int C, int mode, int act,
                                 void* stream) {
  return launch<bf16>(x, scale, bias, mean, inv, res, y, R, row, C, mode,
                      act, stream);
}
