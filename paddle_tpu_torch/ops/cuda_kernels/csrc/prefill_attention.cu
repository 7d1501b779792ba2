// K2: causal prefill attention, fp32 and bf16, for sm_90a.
//
// Replaces the forward of two TPU kernels:
//   paddle_tpu/ops/pallas_kernels/short_attention.py:248 short128_attention
//     (_fwd :141 -> _fwd_kernel :87; S <= 128, optional ragged kv_lens), and
//   paddle_tpu/ops/pallas_kernels/attention.py:211 short_seq_attention
//     (_fwd :135 -> _fwd_kernel :85; S % 128 == 0, S <= 512).
// out[b, h] = softmax(Q K^T * scale) V over [S, dh], with an optional causal
// mask and key slots >= kv_lens[b] masked; a fully masked row emits zeros.
// It takes any S in 1..512 and dh % 4 == 0, dh <= 128. The scores, the
// softmax statistics and the accumulator are fp32. In bf16 the weights
// exp(s - m), m the row's full max, are rounded to bf16 before they
// multiply V, and the output at its store, where the TPU kernel casts them
// (short_attention.py:97, :100); the row sum l is taken unrounded, as there.
//
// What bounds it on this card: fp32 runs on the CUDA cores (67 TFLOP/s, TF32
// off), so at S = 512 the operations (2 products of 2 S^2 dh per head,
// halved under the causal mask) and at small S the bytes (q, k, v read
// once, out written once); bf16 runs on the tensor cores (989 TFLOP/s), so
// the bytes up to S = 128 and the operations past it.
//
// What the design does about it:
//   * fp32 (register micro-tiles on the CUDA cores, K10's forward body,
//     attention_f32.cuh attn_fwd): a block of 128 threads owns 64 query
//     rows of one (b, h); a thread holds an 8 x 4 tile of the scores and an
//     8 x D / 16 tile of the output in registers, so each shared float
//     feeds 4 or 8 FMAs. K and V stream in 64-key tiles, double-buffered by
//     cp.async, only up to the causal bound of the block's last row and
//     kv_lens, under an online softmax in base 2 (the row max reduced by
//     four shuffles a row once a tile); the [S, S] scores never exist. The
//     head width runs on D = 64 (dh <= 64) or D = 128 (dh <= 128), columns
//     dh.. zero-filled in shared memory and never stored. A row with no live
//     key keeps m = -inf (its update guarded) and l = 0 and is stored as
//     zeros; a kv_len 0 head runs no tile. D = 64: 107,520 bytes of shared
//     memory, 2 blocks an SM; D = 128: 189,440 bytes, 1.
//   * bf16 (mma.sync m16n8k16, fp32 accumulators): a block owns 64 query
//     rows, a warp 16 (the flash_mma layout of flash_tile.cuh). Q and the
//     key and value tiles sit in padded bf16 shared memory, staged by
//     cp.async; a head width that is not a multiple of 16 is zero-filled to
//     the next one there, and columns past dh are never stored. S <= 128:
//     the whole of K and V in one tile of 128 keys; V's copy is issued
//     before Q K^T starts and lands while the scores are formed; each warp
//     keeps its 16 x 128 fp32 scores in registers, takes the full row max,
//     and packs exp(s - m) to bf16 A fragments for P V. 128 < S <= 512:
//     64-key tiles, double-buffered with cp.async, in two passes: the row
//     max first (Q K^T alone), then Q K^T again, exp at the full max and
//     P V, so that P is rounded at the TPU's point (three products of work
//     for two; an online softmax would round P at a running max). Key tiles
//     past the causal or kv_lens bound of a block are neither loaded nor
//     multiplied, nor are a warp's key columns past its own causal bound.
#include <cuda_runtime.h>
#include <math.h>

#include "attention_f32.cuh"

namespace {

// ---- fp32: register micro-tiles on the CUDA cores -------------------------

using namespace flash_simt;

// K10's forward body (attention_f32.cuh attn_fwd) with kv_lens and the head
// width padded: a block of 16 RG threads owns 8 RG query rows of one (b, h).
template <int D, int RG>
__global__ void __launch_bounds__(16 * RG)
prefill_attention_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const int* __restrict__ kv_lens,
                             float* __restrict__ out, int nh, int S, int dh,
                             int causal, float sm_scale) {
  const int len =
      kv_lens == nullptr ? S : min(max(kv_lens[blockIdx.z], 0), S);
  attn_fwd<D, RG>(q, k, v, out, nullptr, nh, S, dh, len, causal, sm_scale);
}

// D = dh rounded up to 64 or 128, the widths the micro-tiles take.
template <int D>
int launch_f32(const float* q, const float* k, const float* v,
               const int* kv_lens, float* out, int B, int nh, int S, int dh,
               int causal, float sm_scale, cudaStream_t st) {
  constexpr int RG = 8, BM = kTM * RG, kSmem = fwd_smem<D, RG>();
  const cudaError_t e = cudaFuncSetAttribute(
      prefill_attention_f32_kernel<D, RG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BM - 1) / BM, nh, B);
  prefill_attention_f32_kernel<D, RG><<<grid, 16 * RG, kSmem, st>>>(
      q, k, v, kv_lens, out, nh, S, dh, causal, sm_scale);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores ------------------------------------------------------

using namespace flash_mma;

constexpr int kWhole = 128;        // S up to this: K and V staged whole

// s[j] (n8 tile j of keys c0 + 8j..) = Q K^T of this warp's 16 rows, times
// scale2 (the scale in base 2), -inf where masked; pairs of tiles at or
// past `wend` (this warp's key bound) are not multiplied.
template <int D, int JT>
__device__ __forceinline__ void scores(float (&s)[JT][4], const bf16* q_s,
                                       const bf16* k_t, int c0, int wend,
                                       const int* rows, int causal,
                                       float scale2) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < JT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  mma_abt<D>(s, q_s, (threadIdx.x >> 5) * 16, k_t, wend - c0);
#pragma unroll
  for (int j = 0; j < JT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + j * 8 + 2 * t + (e & 1), row = rows[e >> 1];
      const bool live = col < wend && (!causal || col <= row);
      s[j][e] = live ? s[j][e] * scale2 : -INFINITY;
    }
  }
}

// m = max(m, row max of s), over the four threads of each row.
template <int JT>
__device__ __forceinline__ void row_max(float* m, const float (&s)[JT][4]) {
#pragma unroll
  for (int j = 0; j < JT; ++j) {
    m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
    m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }
}

// l += exp2(s - m) (this thread's part, unrounded) and o += P V with P =
// exp2(s - m) rounded to bf16 as it becomes the A fragment; key slices at
// or past `wend` are skipped (their P is 0).
template <int D, int JT>
__device__ __forceinline__ void softmax_pv(float (&o)[D / 8][4], float* l,
                                           const float (&s)[JT][4],
                                           const float* m, const bf16* v_t,
                                           int c0, int wend) {
  constexpr int P = D + 8;
#pragma unroll
  for (int kk = 0; kk < JT / 2; ++kk) {
    if (c0 + kk * 16 >= wend) continue;
    uint32_t pa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mi = m[e >> 1];
        p[e] = mi == -INFINITY ? 0.f : exp2f(s[2 * kk + h][e] - mi);
      }
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pa[2 * h] = pack(p[0], p[1]);
      pa[2 * h + 1] = pack(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t bv[4];
      frag_b_trans(bv, v_t, kk * 16, j * 8, P);
      mma(o[j], pa, bv[0], bv[1]);
      mma(o[j + 1], pa, bv[2], bv[3]);
    }
  }
}

// D = dh rounded up to 16; KC = keys a tile holds: kWhole (one tile, S <=
// 128) or kMmaKeys (double-buffered tiles, two passes).
template <int D, int KC>
__global__ void __launch_bounds__(kMmaThreads)
prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ kv_lens,
                   bf16* __restrict__ out, int nh, int S, int dh, int causal,
                   float sm_scale) {
  constexpr int P = D + 8, NT = D / 8, JT = KC / 8;
  constexpr int NBUF = KC == kWhole ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kMmaRows * P;                // NBUF tiles of KC keys
  bf16* v_s = k_s + NBUF * KC * P;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const size_t head = ((size_t)b * nh + h) * (size_t)S * dh;
  const int q0 = qt * kMmaRows, row0 = q0 + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};   // this thread's two rows
  const int len = kv_lens == nullptr ? S : min(max(kv_lens[b], 0), S);
  // keys any row of the block sees, and keys this warp's rows see
  const int key_end = causal ? min(len, q0 + kMmaRows) : len;
  const int wend = causal ? min(key_end, row0 + 16) : key_end;
  const int nc = (key_end + KC - 1) / KC;
  const float scale2 = sm_scale * kLog2e;

  auto stage = [&](bf16* tile, const bf16* src, int c) {
    const int n = min(KC, key_end - c * KC);
    stage_async<D, kMmaThreads>(tile + (c % NBUF) * KC * P, src + head,
                                c * KC, n, min(KC, (n + 15) & ~15), dh);
  };
  stage_async<D, kMmaThreads>(q_s, q + head, q0, min(kMmaRows, S - q0),
                              kMmaRows, dh);
  if (nc > 0) stage(k_s, k, 0);
  cp_commit();

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[JT][4];
  if (nc == 1) {
    stage(v_s, v, 0);                            // lands while Q K^T runs
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    scores<D>(s, q_s, k_s, 0, wend, rows, causal, scale2);
    row_max(m, s);
    cp_wait<0>();
    __syncthreads();
    softmax_pv<D>(o, l, s, m, v_s, 0, wend);
  } else if (nc > 1) {
    // pass 1: the full row max
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc) {
        stage(k_s, k, c + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      scores<D>(s, q_s, k_s + (c % NBUF) * KC * P, c * KC, wend, rows, causal,
                scale2);
      row_max(m, s);
      __syncthreads();                           // tile c % 2 is free
    }
    // pass 2: the scores again, P at the full max, P V
    stage(k_s, k, 0);
    stage(v_s, v, 0);
    cp_commit();
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc) {
        stage(k_s, k, c + 1);
        stage(v_s, v, c + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int off = (c % NBUF) * KC * P;
      scores<D>(s, q_s, k_s + off, c * KC, wend, rows, causal, scale2);
      softmax_pv<D>(o, l, s, m, v_s + off, c * KC, wend);
      __syncthreads();
    }
  } else {
    cp_wait<0>();                                // kv_len 0: zeros
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = rows[i];
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);  // l == 0: fully masked
    bf16* orow = out + head + (size_t)r * dh + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j * 8 + 2 * t < dh)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

template <int D, int KC>
int launch_mma(const bf16* q, const bf16* k, const bf16* v,
               const int* kv_lens, bf16* out, int B, int nh, int S, int dh,
               int causal, float sm_scale, cudaStream_t st) {
  constexpr int kSmem =
      (kMmaRows + 2 * (KC == kWhole ? 1 : 2) * KC) * (D + 8) * (int)sizeof(bf16);
  const cudaError_t e = cudaFuncSetAttribute(
      prefill_mma_kernel<D, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kMmaRows - 1) / kMmaRows, nh, B);
  prefill_mma_kernel<D, KC><<<grid, kMmaThreads, kSmem, st>>>(
      q, k, v, kv_lens, out, nh, S, dh, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const int* kv_lens, bf16* out, int B, int nh, int S, int dh,
                int causal, float sm_scale, cudaStream_t st) {
  return S <= kWhole
             ? launch_mma<D, kWhole>(q, k, v, kv_lens, out, B, nh, S, dh,
                                     causal, sm_scale, st)
             : launch_mma<D, kMmaKeys>(q, k, v, kv_lens, out, B, nh, S, dh,
                                       causal, sm_scale, st);
}

}  // namespace

// q, k, v, out: [B, nh, S, dh] of the entry's type; kv_lens: [B] int32 or
// null.
extern "C" int causal_prefill_attention_f32(
    const float* q, const float* k, const float* v, const int* kv_lens,
    float* out, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  if (dh > 128) return (int)cudaErrorInvalidValue;
  return (dh <= 64 ? launch_f32<64> : launch_f32<128>)(
      q, k, v, kv_lens, out, B, nh, S, dh, causal, sm_scale,
      (cudaStream_t)stream);
}

extern "C" int causal_prefill_attention_bf16(
    const bf16* q, const bf16* k, const bf16* v, const int* kv_lens,
    bf16* out, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // the head width rounded up to a multiple of 16, zero-filled in the tiles
#define PREFILL_BF16(D)                                                     \
  case D:                                                                   \
    return launch_bf16<D>(q, k, v, kv_lens, out, B, nh, S, dh, causal,      \
                          sm_scale, st)
  switch ((dh + 15) & ~15) {
    PREFILL_BF16(16);
    PREFILL_BF16(32);
    PREFILL_BF16(48);
    PREFILL_BF16(64);
    PREFILL_BF16(80);
    PREFILL_BF16(96);
    PREFILL_BF16(112);
    PREFILL_BF16(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PREFILL_BF16
}
