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
// once, at the store, as the TPU kernels cast it (xent.py:108, :218). A
// label outside [0, V) subtracts nothing.
//
// What bounds it on this card: HBM bytes, 2 N V sizeof(T) (the logits read
// once, dx written once) in both modes. The TPU kernel holds its block in
// VMEM and reads the row once ("one read, one write"); so does this one:
//   * a row is cut into 16-byte chunks of its address range; C blocks (a
//     thread-block cluster, C = 1, 2, 4 or 8) share a row, the smallest C
//     whose share is at most 64 KB, so that several blocks of different
//     rows are resident on an SM (3 of 61 KB at V = 30522 in both dtypes:
//     fp32 C = 2, bf16 C = 1) and the next rows' copies land while a block
//     reduces and writes. At the main path's shapes on the H100 (700 W;
//     `flash_ab.py --kernels variants` builds such alternatives, text
//     edits of this source, beside it), with the statistics recomputed, a
//     share of 64 KB was 0.6% faster than one of 32 KB and 7% faster than
//     16 KB; an evict-first L2 hint on the copies was 3-4% slower,
//     streaming stores 0.7-1% slower, 256 threads a block within 0.3%;
//   * one thread copies the block's whole chunks into shared memory with
//     one TMA bulk copy (cp.async.bulk, completing on an mbarrier); the
//     row's unaligned head and tail (the chunks its start and end cut, at
//     most 7 elements each) are read and written one element a thread. The
//     wrapper gives dx the logits' address phase mod 16, so a chunk of x
//     and the chunk of dx at its place are both 16-byte aligned and every
//     other access is 16 bytes wide;
//   * statistics: the block's max (no exponential), then its sum of
//     2^((x - m_b) log2 e) (one FADD, one FMUL and one ex2.approx an
//     element); the C blocks of a row exchange (m_b, s_b) through
//     distributed shared memory and each merges them in rank order, so all
//     hold the same row (m, log2 s). dx = g (2^((x - m) log2 e - log2 s) -
//     onehot), one more ex2 an element. Subtracting m before the scaling
//     keeps the exponent's error relative to x - m, not to x: about 2^-24
//     |x - m| log2 e, under 3e-6 relative in p wherever p > e^-30; the
//     tests hold dx element by element, to 1e-4 relative (fp32) or one
//     bf16 unit, 2^-7 relative (bf16), above a floor of 1e-3 of the
//     median |dx|;
//   * every sum runs in a fixed order (a thread's chunks in turn, a
//     shuffle tree, the warps and then the cluster's blocks in rank order),
//     with no atomics, so dx repeats bit for bit from call to call.
// Widths: a row's window of W = ceil(V sizeof(T) / 16) + 1 chunks is
// staged while ceil(W / 8) chunks fit a block's 224 KB, that is up to V =
// 458,748 (fp32) and 917,496 (bf16). Only a wider row streams: the same
// cluster of 8 reads its share twice from device memory (an online max and
// sum, then the write pass).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kTargetShare = 64 * 1024;   // bytes a block stages, at most,
                                          // below the largest cluster
constexpr int kMaxShare = 224 * 1024;     // bytes a block can stage
constexpr float kLog2e = 1.4426950408889634f;

// A 16-byte chunk of T as floats, and back (rounded to nearest even).
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[E]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[E]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Chunk<bf16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[E]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[E]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

// `bytes` (a multiple of 16) from global `src` into shared `dst`, both
// 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The float at `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

// (m, s) and (m2, s2), each a max and a sum of 2^((x - max) log2 e), as one.
// The same operands in either order give the same bits.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = (s == 0.f ? 0.f : s * ex2((m - mn) * kLog2e))
      + (s2 == 0.f ? 0.f : s2 * ex2((m2 - mn) * kLog2e));
  m = mn;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w]);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v += red[w];
  return v;
}

__device__ __forceinline__ void block_merge(float& m, float& s, float* rm,
                                            float* rs) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, s, off));
  if ((threadIdx.x & 31) == 0) {
    rm[threadIdx.x >> 5] = m;
    rs[threadIdx.x >> 5] = s;
  }
  __syncthreads();
  m = rm[0];
  s = rs[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) merge(m, s, rm[w], rs[w]);
}

// Block b of the C blocks of row blockIdx.x / C. The row's window is its
// address range widened to 16 bytes: nch chunks from f0, the first cut by
// the row's start (head) and the last by its end (tail); the block owns
// chunks [k0, k1) and stages the whole ones among them, [kf0, kf1).
// STAGED = false streams the share from device memory twice (rows past
// kMaxShare a block).
template <typename T, bool STAGED>
__global__ void __launch_bounds__(kThreads, 8)
softmax_xent_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                        const float* __restrict__ g, const float* __restrict__ m_in,
                        const float* __restrict__ lse_in, T* __restrict__ dx,
                        int V, int C) {
  using Ch = Chunk<T>;
  constexpr int E = Ch::E;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  __shared__ float red_m[kWarps], red_s[kWarps], xch[2];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x / C;
  const int b = blockIdx.x % C;
  const T* xr = x + row * V;
  const uintptr_t r0 = (uintptr_t)xr, r1 = r0 + (size_t)V * sizeof(T);
  const uintptr_t f0 = r0 & ~(uintptr_t)15;
  const int nch = (int)((((r1 + 15) & ~(uintptr_t)15) - f0) >> 4);
  const bool head = (r0 & 15) != 0, tail = (r1 & 15) != 0;
  const int q = (nch + C - 1) / C;
  const int k0 = min(b * q, nch), k1 = min(k0 + q, nch);
  const int kf0 = max(k0, head ? 1 : 0), kf1 = min(k1, tail ? nch - 1 : nch);
  const int nfull = max(0, kf1 - kf0);
  const uint4* src = reinterpret_cast<const uint4*>(f0) + kf0;
  // dx's chunks at the same places (the wrapper aligns dx's phase to x's)
  uint4* dst = reinterpret_cast<uint4*>(
                   f0 + ((uintptr_t)dx - (uintptr_t)x)) + kf0;
  const uint4* buf = reinterpret_cast<const uint4*>(smem);

  if (STAGED) {
    if (tid == 0) {
      mbar_init(&bar, 1);
      mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0 && nfull) {
      mbar_expect(&bar, 16u * nfull);
      bulk_load(smem, src, 16u * nfull, &bar);
    }
  }

  // the head's and the tail's elements: one a thread of the first 2E
  int pcol = -1;
  float xv = 0.f;
  if (tid < 2 * E) {
    const int k = tid < E ? 0 : nch - 1;
    const bool cut = tid < E ? head : tail && !(head && nch == 1);
    const long long col =
        ((long long)(f0 + 16 * (uintptr_t)k) - (long long)r0) / (long long)sizeof(T)
        + tid % E;
    if (cut && k >= k0 && k < k1 && col >= 0 && col < V) {
      pcol = (int)col;
      xv = to_f(xr[pcol]);
    }
  }
  const float gr = g[row];
  const int lab = labels[row];

  // m: the row's max; c: log2 of its sum of exp(x - m)
  float m, c;
  const bool merged = m_in == nullptr && C > 1;
  if (m_in != nullptr) {
    m = m_in[row];
    c = lse_in[row] * kLog2e;
    if (STAGED && nfull) mbar_wait(&bar, 0);
  } else {
    float s;
    if (STAGED) {
      if (nfull) mbar_wait(&bar, 0);
      float mx = pcol >= 0 ? xv : -INFINITY;
      for (int k = tid; k < nfull; k += kThreads) {
        float f[E];
        Ch::unpack(buf[k], f);
#pragma unroll
        for (int e = 0; e < E; ++e) mx = fmaxf(mx, f[e]);
      }
      m = block_max(mx, red_m);
      s = 0.f;
      if (m != -INFINITY) {          // a share of only -inf sums nothing
        if (pcol >= 0) s = ex2((xv - m) * kLog2e);
        for (int k = tid; k < nfull; k += kThreads) {
          float f[E], cs = 0.f;
          Ch::unpack(buf[k], f);
#pragma unroll
          for (int e = 0; e < E; ++e) cs += ex2((f[e] - m) * kLog2e);
          s += cs;
        }
      }
      s = block_sum(s, red_s);
    } else {
      m = pcol >= 0 ? xv : -INFINITY;
      s = pcol >= 0 ? 1.f : 0.f;
      for (int k = tid; k < nfull; k += kThreads) {
        float f[E], cm = -INFINITY, cs = 0.f;
        Ch::unpack(__ldg(src + k), f);
#pragma unroll
        for (int e = 0; e < E; ++e) cm = fmaxf(cm, f[e]);
        if (cm == -INFINITY) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) cs += ex2((f[e] - cm) * kLog2e);
        merge(m, s, cm, cs);
      }
      block_merge(m, s, red_m, red_s);
    }
    if (merged) {                    // the cluster's blocks, in rank order
      if (tid == 0) {
        xch[0] = m;
        xch[1] = s;
      }
      cluster_arrive_release();
      cluster_wait();
      m = ld_cluster(&xch[0], 0);
      s = ld_cluster(&xch[1], 0);
      for (int j = 1; j < C; ++j)
        merge(m, s, ld_cluster(&xch[0], j), ld_cluster(&xch[1], j));
      cluster_arrive_relaxed();      // done reading the others' xch
    }
    c = log2f(s);
  }

  // dx = g (2^((x - m) log2 e - c) - onehot)
  const long long klab =
      lab >= 0 && lab < V
          ? ((long long)(r0 + (size_t)lab * sizeof(T) - f0) >> 4) - kf0 : -1;
  const int elab = lab >= 0 && lab < V
                       ? (int)(((r0 + (size_t)lab * sizeof(T)) & 15) / sizeof(T))
                       : -1;
  for (int k = tid; k < nfull; k += kThreads) {
    float f[E];
    Ch::unpack(STAGED ? buf[k] : __ldg(src + k), f);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = ex2(fmaf(f[e] - m, kLog2e, -c));
    if (k == klab) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e == elab) f[e] -= 1.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] *= gr;
    dst[k] = Ch::pack(f);
  }
  if (pcol >= 0) {
    const float p = ex2(fmaf(xv - m, kLog2e, -c));
    dx[row * V + pcol] = from_f<T>((p - (pcol == lab ? 1.f : 0.f)) * gr);
  }
  if (merged) cluster_wait();        // the others are done reading mine
}

// The window's most chunks, over every address phase of a row's start.
template <typename T>
long long window_chunks(int V) {
  return ((long long)V * sizeof(T) + 15) / 16 + 1;
}

template <typename T, bool STAGED>
int launch_kernel(const T* x, const int* labels, const float* g,
                  const float* m, const float* lse, T* dx, int N, int V, int C,
                  int smem, cudaStream_t st) {
  auto kernel = softmax_xent_bwd_kernel<T, STAGED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShare);
  if (e == cudaSuccess)     // the carveout that holds 3 shares of 61 KB
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)N * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  // only the recomputed statistics exchange anything within a row
  if (m == nullptr && C > 1) {
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, x, labels, g, m, lse, dx, V, C);
}

// The smallest cluster (1, 2, 4 or 8 blocks a row) whose share is at most
// kTargetShare; staged while the share fits kMaxShare, else streamed.
template <typename T>
int launch(const T* x, const int* labels, const float* g, const float* m,
           const float* lse, T* dx, int N, int V, void* stream) {
  if (N == 0) return 0;
  if (V < 1 || ((uintptr_t)x & 15) != ((uintptr_t)dx & 15))
    return (int)cudaErrorInvalidValue;
  const long long W = window_chunks<T>(V);
  int C = 1;
  while (C < kMaxCluster && (W + C - 1) / C * 16 > kTargetShare) C *= 2;
  const long long share = (W + C - 1) / C * 16;
  const bool staged = share <= kMaxShare;
  if ((long long)N * C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc =
      staged ? launch_kernel<T, true>(x, labels, g, m, lse, dx, N, V, C,
                                      (int)share, st)
             : launch_kernel<T, false>(x, labels, g, m, lse, dx, N, V, C, 0, st);
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace

// x, dx: [N, V] of the entry's type, at the same address phase mod 16;
// labels: [N] int32; g: [N] fp32; m, lse: the forward's saved [N] fp32
// statistics, or both null to recompute.
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
