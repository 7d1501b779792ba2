// Rows of a layer norm held by warps: the row layout that K3
// (layer_norm.cu) and K5 (layer_norm_backward.cu) share.
//
// A row of x [R, K] (K <= 2048) is held by W warps (a "row group"), each
// lane holding NV chunks of E = 16 / sizeof(T) elements (4 fp32 or 8 bf16)
// in registers. The row's bucket KB (256, 512, 768, 1024 or 2048 columns,
// the smallest that holds K) fixes NV and W at compile time; the columns
// from K to KB are masked. Two layouts of the same registers:
//   * VEC (K sizeof(T) a multiple of 16 and every row pointer 16-byte
//     aligned): a chunk is E consecutive columns, moved by one 16-byte
//     access, neighbouring lanes on neighbouring chunks (512 bytes a warp
//     an access); a chunk is wholly inside the row or wholly past it;
//   * scalar (any other K or alignment): element k of chunk j sits at a
//     column 32 apart from its lane's neighbour's, so each access is still
//     one coalesced 32-element strip.
// A chunk travels as a uint4 of raw bits (4 fp32 or 8 bf16) so the next
// row's loads can sit in registers while the current row is reduced, and
// is widened to fp32 only when its row's turn comes.
#pragma once
#include <cuda_runtime.h>

#include "elem.cuh"

namespace ln_rows {

constexpr unsigned kFull = 0xffffffffu;

template <typename T, int KB, int W>
struct Geo {
  static constexpr int E = 16 / sizeof(T);        // elements a chunk
  static constexpr int NV = KB / (W * 32 * E);    // chunks a lane
  static constexpr int V = NV * E;                // values a lane
  static_assert(NV >= 1 && NV * W * 32 * E == KB, "bucket does not tile");
};

// The column of element k of chunk j of `lane` in warp `wi` of its row.
template <int E, int NV, bool VEC>
__device__ __forceinline__ int col(int wi, int lane, int j, int k) {
  return VEC ? ((wi * NV + j) * 32 + lane) * E + k
             : ((wi * NV + j) * E + k) * 32 + lane;
}

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

__device__ __forceinline__ void set_word(uint4& u, int i, unsigned w) {
  if (i == 0) u.x = w;
  else if (i == 1) u.y = w;
  else if (i == 2) u.z = w;
  else u.w = w;
}

// Element k of a chunk, widened to fp32.
template <typename T>
__device__ __forceinline__ float widen(const uint4& u, int k);
template <>
__device__ __forceinline__ float widen<float>(const uint4& u, int k) {
  return __uint_as_float(word(u, k));
}
template <>
__device__ __forceinline__ float widen<bf16>(const uint4& u, int k) {
  const unsigned w = word(u, k >> 1);
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits(bf16 v) { return __bfloat16_as_ushort(v); }

// The lane's chunks of row p (K columns) as raw bits; columns past K are 0.
template <typename T, int NV, bool VEC>
__device__ __forceinline__ void load_raw(const T* __restrict__ p, int K,
                                         int wi, int lane, uint4 (&raw)[NV]) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    raw[j] = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (VEC) {
      const int c = col<E, NV, VEC>(wi, lane, j, 0);
      if (c < K) raw[j] = __ldg(reinterpret_cast<const uint4*>(p + c));
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int c = col<E, NV, VEC>(wi, lane, j, k);
        if (c < K) {
          const unsigned b = bits(p[c]);
          if constexpr (sizeof(T) == 4) set_word(raw[j], k, b);
          else set_word(raw[j], k >> 1, word(raw[j], k >> 1) | (b << (16 * (k & 1))));
        }
      }
    }
  }
}

template <typename T, int NV>
__device__ __forceinline__ void unpack(const uint4 (&raw)[NV], float* v) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < E; ++k) v[j * E + k] = widen<T>(raw[j], k);
}

// The lane's values of a row rounded to T (once, here) and stored; columns
// past K are not written.
template <typename T, int NV, bool VEC>
__device__ __forceinline__ void store_row(T* __restrict__ p, int K, int wi,
                                          int lane, const float* v) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if constexpr (VEC) {
      const int c = col<E, NV, VEC>(wi, lane, j, 0);
      if (c < K) {
        uint4 u;
        if constexpr (sizeof(T) == 4) {
          u = make_uint4(__float_as_uint(v[j * E]), __float_as_uint(v[j * E + 1]),
                         __float_as_uint(v[j * E + 2]), __float_as_uint(v[j * E + 3]));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            set_word(u, i, bits(from_f<bf16>(v[j * E + 2 * i]))
                               | (bits(from_f<bf16>(v[j * E + 2 * i + 1])) << 16));
        }
        *reinterpret_cast<uint4*>(p + c) = u;
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int c = col<E, NV, VEC>(wi, lane, j, k);
        if (c < K) p[c] = from_f<T>(v[j * E + k]);
      }
    }
  }
}

// An fp32 vector of length K (scale, bias) in the lane's layout; 0 past K.
template <int E, int NV, bool VEC>
__device__ __forceinline__ void load_param(const float* __restrict__ p, int K,
                                           int wi, int lane, float* v) {
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int c = col<E, NV, VEC>(wi, lane, j, k);
      v[j * E + k] = c < K ? __ldg(p + c) : 0.f;
    }
}

// scale or bias staged in shared memory (sp [KB], 0 past K), read into the
// lane's layout: 16-byte reads of consecutive columns in the VEC layout.
template <int E, int NV, bool VEC>
__device__ __forceinline__ void read_param(const float* sp, int wi, int lane,
                                           float* v) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if constexpr (VEC) {
#pragma unroll
      for (int k = 0; k < E; k += 4) {
        const float4 f = *reinterpret_cast<const float4*>(
            sp + col<E, NV, VEC>(wi, lane, j, k));
        v[j * E + k] = f.x;
        v[j * E + k + 1] = f.y;
        v[j * E + k + 2] = f.z;
        v[j * E + k + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) v[j * E + k] = sp[col<E, NV, VEC>(wi, lane, j, k)];
    }
  }
}

// Stage scale and bias [K] into sp [2][KB] (0 past K) with the block's
// kThreads threads: every load is issued before the first store, so the
// block waits for one round trip, not one a column strip.
template <int KB, int kThreads>
__device__ __forceinline__ void stage_params(const float* __restrict__ scale,
                                             const float* __restrict__ bias,
                                             int K, float (*sp)[KB]) {
  constexpr int N = (KB + kThreads - 1) / kThreads;
  float a[N], b[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = threadIdx.x + n * kThreads;
    a[n] = c < K ? __ldg(scale + c) : 0.f;
    b[n] = c < K ? __ldg(bias + c) : 0.f;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = threadIdx.x + n * kThreads;
    if (c < KB) {
      sp[0][c] = a[n];
      sp[1][c] = b[n];
    }
  }
}

// Whether element i (= j E + k) of the lane lies inside the row.
template <int E, int NV, bool VEC>
__device__ __forceinline__ bool inside(int wi, int lane, int i, int K) {
  return col<E, NV, VEC>(wi, lane, i / E, i % E) < K;
}

// The sum of v[0..N) as a balanced tree: a chain of log2 N dependent adds
// where a running sum would take N (the latency of a lone warp's row).
template <int N>
__device__ __forceinline__ float tree_sum(const float* v) {
  if constexpr (N == 1) return v[0];
  else return tree_sum<N / 2>(v) + tree_sum<N - N / 2>(v + N / 2);
}

// Row sums: a butterfly of shuffles within the warp (every lane ends with
// the same bits: each step adds the same two numbers on both lanes), then,
// for a row held by W > 1 warps, one shared-memory combine in warp order.
// red is [rows a block][W] and is not reused before the block's next
// barrier.
template <int W>
__device__ __forceinline__ float row_sum(float v, float (*red)[W], int grp,
                                         int wi, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if constexpr (W > 1) {
    if (lane == 0) red[grp][wi] = v;
    __syncthreads();
    v = red[grp][0];
#pragma unroll
    for (int w = 1; w < W; ++w) v += red[grp][w];
  }
  return v;
}

// Two row sums in one round of shuffles.
template <int W>
__device__ __forceinline__ void row_sum2(float& a, float& b, float2 (*red)[W],
                                         int grp, int wi, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
  if constexpr (W > 1) {
    if (lane == 0) red[grp][wi] = make_float2(a, b);
    __syncthreads();
    a = red[grp][0].x;
    b = red[grp][0].y;
#pragma unroll
    for (int w = 1; w < W; ++w) {
      a += red[grp][w].x;
      b += red[grp][w].y;
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// Blocks of `kernel` (threads a block) that fit on the whole card at once.
inline int resident_blocks(const void* kernel, int threads) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, 0);
  return sms * (occ > 0 ? occ : 1);
}

}  // namespace ln_rows
