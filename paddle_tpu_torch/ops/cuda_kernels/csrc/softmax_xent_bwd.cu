// K7: softmax cross-entropy backward over a large vocabulary, fp32 and bf16
// logits, sm_90a.
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas_kernels/xent.py:
//   xent_grad (:228, pallas_call :233 -> _bwd_kernel_nostats :196), the
//     program path's grad: row statistics recomputed from the logits, and
//   softmax_xent_rows' backward (_run_bwd :139 -> _bwd_kernel :95), which
//     reads the forward's saved m and lse instead (a mode of this kernel).
// For each row of logits x [N, V], its hard label and its loss cotangent g
// it writes dx = g (exp(x - m - lse) - onehot(label)). The logits and dx
// are fp32 or bf16 (T), g and the statistics fp32; a bf16 dx is rounded
// once, at the store, as the TPU kernels cast it (xent.py:108, :218).
//
// What bounds it on this card: HBM bytes, 2 N V sizeof(T) (the logits read
// once, dx written once) with saved statistics; without them the row is
// read a second time for its (max, sum), 3 N V sizeof(T) unless the second
// read hits L2.
//
// What the design does about it: one block of 256 threads per row; the
// statistics pass is K6's online (max, sum) with four loads in flight per
// thread; the write pass streams the row again with neighbouring threads on
// neighbouring columns. The ragged vocab edge is masked by index (no padded
// copy, unlike the TPU caller's -1e30 lanes).
#include <cuda_runtime.h>
#include <math.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;                   // m == -inf: s is 0
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void online_merge(float& m, float& s, float m2,
                                             float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;                   // both empty
  s = (m == -INFINITY ? 0.f : s * expf(m - mn))
      + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mn));
  m = mn;
}

// m + log(sum exp(x - m)) of the row, in every thread of the block.
template <typename T>
__device__ float row_mlse(const T* __restrict__ xr, int V) {
  __shared__ float red_m[kWarps], red_s[kWarps];
  float m = -INFINITY, s = 0.f;
  for (int c0 = threadIdx.x; c0 < V; c0 += kUnroll * kThreads) {
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      xv[u] = c < V ? to_f(xr[c]) : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c0 + u * kThreads < V) online_add(m, s, xv[u]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    online_merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  m = -INFINITY;
  s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) online_merge(m, s, red_m[w], red_s[w]);
  return m + logf(s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_xent_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                        const float* __restrict__ g, const float* __restrict__ m_in,
                        const float* __restrict__ lse_in, T* __restrict__ dx,
                        int V) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * V;
  const float mlse = m_in != nullptr ? m_in[row] + lse_in[row] : row_mlse(xr, V);
  const int lab = labels[row];
  const float gr = g[row];
  T* dxr = dx + row * V;
  for (int c0 = threadIdx.x; c0 < V; c0 += kUnroll * kThreads) {
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      xv[u] = c < V ? to_f(xr[c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c < V)
        dxr[c] = from_f<T>((expf(xv[u] - mlse) - (c == lab ? 1.f : 0.f)) * gr);
    }
  }
}

template <typename T>
int launch(const T* x, const int* labels, const float* g, const float* m,
           const float* lse, T* dx, int N, int V, void* stream) {
  if (N == 0) return 0;
  softmax_xent_bwd_kernel<T><<<N, kThreads, 0, (cudaStream_t)stream>>>(
      x, labels, g, m, lse, dx, V);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dx: [N, V] of the entry's type; labels: [N] int32; g: [N] fp32; m,
// lse: the forward's saved [N] fp32 statistics, or both null to recompute.
extern "C" int softmax_xent_bwd_f32(const float* x, const int* labels,
                                    const float* g, const float* m,
                                    const float* lse, float* dx, int N, int V,
                                    void* stream) {
  return launch<float>(x, labels, g, m, lse, dx, N, V, stream);
}

extern "C" int softmax_xent_bwd_bf16(const bf16* x, const int* labels,
                                     const float* g, const float* m,
                                     const float* lse, bf16* dx, int N, int V,
                                     void* stream) {
  return launch<bf16>(x, labels, g, m, lse, dx, N, V, stream);
}
