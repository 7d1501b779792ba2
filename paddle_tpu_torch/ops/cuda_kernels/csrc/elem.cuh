// Element types of the kernels: fp32 and bf16 in memory, fp32 in registers.
//
// A kernel templated on T reads T, computes in float, and writes T. to_f
// widens; from_f<T> rounds to nearest even (the rounding of a TPU
// `astype(bfloat16)`); round_to<T> is a rounding in registers, the identity
// for float, so a kernel's float instantiation is its fp32 kernel unchanged.
// Vec<T, N> is N elements moved as one access of up to 16 bytes: a float4 of
// fp32 is an 8-wide access of bf16.
#pragma once
#include <cuda_bf16.h>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// relu that keeps a NaN, as torch.relu and the TPU kernels' jnp.maximum do
// (fmaxf(NaN, 0) is 0, which would hide a non-finite input downstream).
__device__ __forceinline__ float relu_f(float x) { return x < 0.f ? 0.f : x; }

template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

// N consecutive elements at p (aligned to the access) widened into out.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const Vec<T, N> t = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = to_f(t.v[k]);
}

// N floats rounded to T and written to p (aligned to the access).
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  Vec<T, N> t;
#pragma unroll
  for (int k = 0; k < N; ++k) t.v[k] = from_f<T>(in[k]);
  *reinterpret_cast<Vec<T, N>*>(p) = t;
}
