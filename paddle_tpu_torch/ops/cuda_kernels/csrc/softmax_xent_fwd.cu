// K6: softmax cross-entropy forward over a large vocabulary, fp32 and bf16
// logits, sm_90a.
//
// Replaces paddle_tpu/ops/pallas_kernels/xent.py softmax_xent_rows (:160) and
// xent_loss_fwd (:221) (_run_fwd :122 -> _fwd_kernel :70). For each row of
// logits x [N, V] and its hard label it writes
//   m = max_v x,  lse = log sum_v exp(x - m),  loss = -(x[label] - m - lse),
// all fp32 [N], from fp32 or bf16 logits (T) widened in registers: nothing
// is rounded. A label outside [0, V) picks 0 (the TPU kernel's one-hot
// select picks nothing for a label past the padded width).
//
// What bounds it on this card: HBM bytes, N V sizeof(T) for the one read of
// the logits (the three [N] outputs are noise); about 4 flops and one exp
// per element.
//
// What the design does about it: one block of 256 threads per row reads the
// row once, neighbouring threads on neighbouring columns and four loads in
// flight per thread, keeping an online (max, sum) pair per thread; the
// pairs merge by warp shuffles and one shared-memory step. The TPU caller
// pads the vocab to a lane multiple with -1e30 (a padded [N, Vp] copy);
// here the ragged vocab edge is masked by index and nothing is copied.
#include <cuda_runtime.h>
#include <math.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// Fold value x into the online pair (m, s): s = sum exp(. - m).
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

// The row's (max, sum of exp(x - max)), in every thread of the block.
template <typename T>
__device__ void row_stats(const T* __restrict__ xr, int V, float& m_out,
                          float& s_out) {
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
  m_out = m;
  s_out = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                        float* __restrict__ loss, float* __restrict__ m_out,
                        float* __restrict__ lse_out, int V) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * V;
  float m, s;
  row_stats(xr, V, m, s);
  if (threadIdx.x == 0) {
    const int lab = labels[row];
    const float picked = (lab >= 0 && lab < V) ? to_f(xr[lab]) : 0.f;
    const float lse = logf(s);
    loss[row] = -(picked - m - lse);
    m_out[row] = m;
    lse_out[row] = lse;
  }
}

template <typename T>
int launch(const T* x, const int* labels, float* loss, float* m, float* lse,
           int N, int V, void* stream) {
  if (N == 0) return 0;
  softmax_xent_fwd_kernel<T><<<N, kThreads, 0, (cudaStream_t)stream>>>(
      x, labels, loss, m, lse, V);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [N, V] of the entry's type; labels: [N] int32; loss, m, lse: [N] fp32.
extern "C" int softmax_xent_fwd_f32(const float* x, const int* labels,
                                    float* loss, float* m, float* lse, int N,
                                    int V, void* stream) {
  return launch<float>(x, labels, loss, m, lse, N, V, stream);
}

extern "C" int softmax_xent_fwd_bf16(const bf16* x, const int* labels,
                                     float* loss, float* m, float* lse, int N,
                                     int V, void* stream) {
  return launch<bf16>(x, labels, loss, m, lse, N, V, stream);
}
