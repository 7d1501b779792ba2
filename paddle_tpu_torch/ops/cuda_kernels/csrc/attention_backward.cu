// K4: attention backward (dQ, dK, dV), fp32 and bf16, for sm_90a.
//
// Replaces the backward of two TPU kernels:
//   paddle_tpu/ops/pallas_kernels/short_attention.py short128_attention
//     (_bwd :164 -> _bwd_kernel :103; S <= 128, optional ragged kv_lens), and
//   paddle_tpu/ops/pallas_kernels/attention.py short_seq_attention
//     (_bwd :154 -> _bwd_kernel :97; S % 128 == 0, S <= 512).
// From q, k, v and dO [B, nh, S, dh] it recomputes P = softmax(Q K^T * scale)
// under the causal and kv_lens masks and writes
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dP . P),
//   dS = P . (dP - delta) * scale,  dQ = dS K,  dK = dS^T Q.
// delta comes from the recomputed P, as on the TPU: the grad op is given no
// forward output to take rowsum(dO . O) from. A fully masked query row (a
// kv_len 0 row) gets zero gradients, matching K2's zero output, and so does
// a key past kv_len. It takes any S in 1..512 and dh % 4 == 0, dh <= 128
// (K2's domain). The scores, the softmax statistics, delta and the
// accumulators are fp32. In bf16 the kernels round where the TPU kernel
// casts (short_attention.py:114, :124, :129-131): P to bf16 before it
// multiplies dO, dS = P (dP - delta) scale to bf16 before it multiplies K
// and Q, and the three outputs at their stores; delta is taken from the
// unrounded P.
//
// What bounds it on this card: fp32 runs on the CUDA cores (67 TFLOP/s), so
// the operations (5 products of 2 S^2 dh each per head); bf16 runs on the
// tensor cores (989 TFLOP/s), so the bytes (q, k, v, dO read once, dq, dk,
// dv written once) up to S = 128 and the operations past it.
//
// What the design does about it:
//   * fp32 (register micro-tiles on the CUDA cores, flash_tile.cuh
//     flash_simt: a thread holds 8 x 4 tiles of scores and 8 x D / 16 tiles
//     of its outputs, so each shared float feeds 4 or 8 FMAs), S <= 128 and
//     dh <= 64: one block of 256 threads a (b, h), the TPU kernel's shape.
//     Q, K, V and dO are staged once by cp.async; each thread forms its 8 x 8
//     scores and dP in registers, the full-row softmax P, delta and dS;
//     P, then dS, pass through one [128, 144] buffer to dV = P^T dO, dQ = dS
//     K and dK = dS^T Q. Five products, no scratch, 212,992 bytes of shared
//     memory, one block an SM. Past it (128 < S <= 512, or dh > 64, on D =
//     64 or 128): K11's query and key passes (attention_f32.cuh), the query
//     pass first visiting the key tiles for the online m, l and d = sum_j
//     e^(s_j - m) dP_j, so lse = m + log l and delta = d / l come out of
//     one visit into the [B, nh, S] fp32 scratch; the key pass reads them
//     per query tile. Nine products for five, for having no [S, S] array and
//     no atomics. Columns past dh are zero in shared memory and never
//     stored.
//   * bf16 (mma.sync m16n8k16, fp32 accumulators; flash_tile.cuh), S <= 128:
//     one block per (b, h), the TPU kernel's own shape, a whole head in fast
//     memory. Q, K, V and dO are staged once by cp.async (K with Q first, V
//     and dO landing while Q K^T runs), in padded bf16 shared memory, the
//     head width zero-filled to a multiple of 16. Each of 8 warps owns 16
//     query rows and forms in registers S = Q K^T and its full-row softmax
//     P, dP = dO V^T, delta, dS and dQ = dS K, stored directly. P (rounded)
//     goes to a shared [S, S + 8] bf16 buffer; after a barrier each warp
//     forms dV = P^T dO for 16 key rows (ldmatrix .trans of the buffer as
//     A); then dS overwrites P and dK = dS^T Q follows. Five products, no
//     atomics, no scratch, and q, k, v, dO read and dq, dk, dv written once.
//   * bf16, 128 < S <= 512: the fp32 split on the tensor cores, as K11's
//     (flash_attention_backward.cu): a query kernel (64 rows, a warp 16)
//     over double-buffered 64-key tiles keeps the online m, l and d of the
//     recomputed P, then forms dS again and accumulates dQ; a key kernel
//     (64 keys) over double-buffered query tiles with their rows' lse and
//     delta rebuilds P^T and dS^T and accumulates dV and dK. Nine products
//     for five, for having no [S, S] array and no atomics.
#include <cuda_runtime.h>
#include <math.h>

#include "attention_f32.cuh"

namespace {

__device__ __forceinline__ int live_len(const int* kv_lens, int b, int S) {
  return kv_lens == nullptr ? S : min(max(kv_lens[b], 0), S);
}

// ---- fp32: register micro-tiles on the CUDA cores -------------------------

using namespace flash_simt;

constexpr int kHeadRows = 128;   // S up to this (dh <= 64): one block a head
constexpr int kHeadRG = 16;            // row groups: 256 threads, 8 rows each
constexpr int kHeadThr = 16 * kHeadRG;
constexpr int kHeadPitch = kHeadRows + 16;   // a row of the P / dS buffer
constexpr int kHeadSmem =              // Q, K, V, dO [128, 68] and P / dS
    (4 * kHeadRows * kPitch<64> + kHeadRows * kHeadPitch) * 4;

// S <= 128, dh <= 64: one block of 256 threads a (b, h), the TPU kernel's
// shape (short_attention.py:174, a whole head in fast memory). Q, K, V and
// dO are staged once ([128, 68] fp32, rows past S or kv_len and columns
// past dh zero), K with Q first, V and dO landing while Q K^T runs. Thread
// (rg, cg) owns query rows rg + 16 i (i < 8) and, of each 64-key half, the
// columns cg + 16 j (j < 4): S = Q K^T and its full-row softmax P, then dP
// = dO V^T, delta = rowsum(dP . P) from the unrounded P and dS = P (dP -
// delta), all in registers (8 x 8 of each). P goes to the buffer; after a
// barrier each thread forms dV = P^T dO for its 8 adjacent key rows 8 rg..
// (the buffer read down its columns); then dS overwrites P and dQ = dS K
// (query rows) and dK = dS^T Q (key rows) follow. Five products, no
// scratch, and q, k, v, dO read and dq, dk, dv written once.
__global__ void __launch_bounds__(kHeadThr, 1)
attn_bwd_head_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const int* __restrict__ kv_lens,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, int nh, int S, int dh,
                         int causal, float sm_scale) {
  constexpr int D = 64, P = kPitch<D>, RG = kHeadRG, TD = D / 16;
  constexpr int W = kHeadPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // [128, P] each
  float* k_s = q_s + kHeadRows * P;
  float* v_s = k_s + kHeadRows * P;
  float* do_s = v_s + kHeadRows * P;
  float* w_s = do_s + kHeadRows * P;             // [128, W]: P, then dS
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t head = ((size_t)b * nh + h) * (size_t)S * dh;
  const int len = live_len(kv_lens, b, S);
  if (len == 0) {                                // every P is 0
    flash_simt::zero_rows<kHeadThr>(dq + head, 0, S, dh);
    flash_simt::zero_rows<kHeadThr>(dk + head, 0, S, dh);
    flash_simt::zero_rows<kHeadThr>(dv + head, 0, S, dh);
    return;
  }
  const int halves = (len + kCols - 1) / kCols;  // halves with a live key
  stage_rows<D, kHeadThr>(q_s, q + head, 0, S, kHeadRows, dh);
  stage_rows<D, kHeadThr>(k_s, k + head, 0, len, kHeadRows, dh);
  flash_mma::cp_commit();
  stage_rows<D, kHeadThr>(v_s, v + head, 0, len, kHeadRows, dh);
  stage_rows<D, kHeadThr>(do_s, dout + head, 0, S, kHeadRows, dh);
  flash_mma::cp_commit();

  const float scale2 = sm_scale * kLog2e;
  float s[2][kTM][kTN], dp[2][kTM][kTN];         // [key half][row][column]
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[hf][i][j] = dp[hf][i][j] = 0.f;

  flash_mma::cp_wait<1>();
  __syncthreads();                               // Q and K landed
  // S = Q K^T, its full-row softmax P (in s)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    if (hf < halves) fma_abt<D, RG>(s[hf], q_s, k_s + hf * kCols * P, rg, cg);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = rg + RG * i;
    float mt = -INFINITY;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int key = hf * kCols + cg + 16 * j;
        const bool live = row < S && key < len && (!causal || key <= row);
        s[hf][i][j] = live ? s[hf][i][j] * scale2 : -INFINITY;
        mt = fmaxf(mt, s[hf][i][j]);
      }
    const float m = group_max(mt);
    float l = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        s[hf][i][j] = m == -INFINITY ? 0.f : exp2f(s[hf][i][j] - m);
        l += s[hf][i][j];
      }
    const float inv = 1.f / fmaxf(group_sum(l), 1e-30f);  // l == 0: a row past S
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[hf][i][j] *= inv;
  }
  flash_mma::cp_wait<0>();
  __syncthreads();                               // V and dO landed
  // dP = dO V^T; delta = rowsum(dP . P); dS = P (dP - delta) in dp, the
  // scale at the stores; P into the buffer
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    if (hf < halves) fma_abt<D, RG>(dp[hf], do_s, v_s + hf * kCols * P, rg, cg);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float part = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < kTN; ++j) part = fmaf(dp[hf][i][j], s[hf][i][j], part);
    const float delta = group_sum(part);
    float* wr = w_s + (rg + RG * i) * W + cg;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        wr[hf * kCols + 16 * j] = s[hf][i][j];
        dp[hf][i][j] = s[hf][i][j] * (dp[hf][i][j] - delta);
      }
  }
  __syncthreads();                               // P is whole

  // this thread's key rows r0..r0 + 7; the queries that may see them (from
  // r0 on, if causal); keys in a half past len have P = 0
  const int r0 = kTM * rg, qa = causal ? r0 : 0, qn = ((S + 3) & ~3) - qa;
  const bool keys_live = r0 < halves * kCols;
  float acc[kTM][TD];
  auto zero_acc = [&] {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int e = 0; e < TD; ++e) acc[i][e] = 0.f;
  };
  // dV = P^T dO
  zero_acc();
  if (keys_live) fma_atb<D, W>(acc, w_s + qa * W, do_s + qa * P, r0, cg, qn);
#pragma unroll
  for (int i = 0; i < kTM; ++i)
    if (r0 + i < S) store_dims<D>(dv + head, r0 + i, acc[i], 1.f, cg, dh);
  __syncthreads();                               // P is read
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        w_s[(rg + RG * i) * W + hf * kCols + cg + 16 * j] = dp[hf][i][j];
  __syncthreads();                               // dS is whole
  // dQ = dS K
  zero_acc();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    if (hf < halves)
      fma_ab<D, RG, W>(acc, w_s + hf * kCols, k_s + hf * kCols * P, rg, cg);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = rg + RG * i;
    if (row < S) store_dims<D>(dq + head, row, acc[i], sm_scale, cg, dh);
  }
  // dK = dS^T Q
  zero_acc();
  if (keys_live) fma_atb<D, W>(acc, w_s + qa * W, q_s + qa * P, r0, cg, qn);
#pragma unroll
  for (int i = 0; i < kTM; ++i)
    if (r0 + i < S) store_dims<D>(dk + head, r0 + i, acc[i], sm_scale, cg, dh);
}

// Past the head kernel (128 < S <= 512, or dh > 64): K11's two passes
// (attention_f32.cuh) by query tile and by key tile, the query pass first
// recomputing lse and delta into the [B, nh, S] scratch. Nine products for
// five, for having no [S, S] array and no atomics.
template <int D, int RG>
__global__ void __launch_bounds__(16 * RG)
attn_bwd_q_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const int* __restrict__ kv_lens,
                      float* __restrict__ dq, float* __restrict__ lse,
                      float* __restrict__ delta, int nh, int S, int dh,
                      int causal, float sm_scale) {
  attn_bwd_dq<D, RG, true>(q, k, v, nullptr, nullptr, dout, dq, lse, delta,
                           nh, S, dh, live_len(kv_lens, blockIdx.z, S), causal,
                           sm_scale);
}

template <int D, int RG>
__global__ void __launch_bounds__(16 * RG)
attn_bwd_kv_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const int* __restrict__ kv_lens,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int nh,
                       int S, int dh, int causal, float sm_scale) {
  attn_bwd_dkv<D, RG, true>(q, k, v, lse, delta, dout, dk, dv, nh, S, dh,
                            live_len(kv_lens, blockIdx.z, S), causal,
                            sm_scale);
}

// D = dh rounded up to 64 or 128; K11's rows a block (128 at D = 64, 64 at
// D = 128).
template <int D>
int launch_f32_pair(const float* q, const float* k, const float* v,
                    const float* dout, const int* kv_lens, float* dq,
                    float* dk, float* dv, float* lse, float* delta, int B,
                    int nh, int S, int dh, int causal, float sm_scale,
                    cudaStream_t st) {
  constexpr int RG = D == 64 ? 16 : 8, R = kTM * RG;
  constexpr int kSmemQ = bwd_dq_smem<D, RG>(), kSmemKV = bwd_dkv_smem<D, RG>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_q_f32_kernel<D, RG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemQ);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_kv_f32_kernel<D, RG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemKV);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + R - 1) / R, nh, B);
  attn_bwd_q_f32_kernel<D, RG><<<grid, 16 * RG, kSmemQ, st>>>(
      q, k, v, dout, kv_lens, dq, lse, delta, nh, S, dh, causal, sm_scale);
  attn_bwd_kv_f32_kernel<D, RG><<<grid, 16 * RG, kSmemKV, st>>>(
      q, k, v, dout, kv_lens, lse, delta, dk, dv, nh, S, dh, causal, sm_scale);
  return (int)cudaGetLastError();
}

// The head kernel where it takes the shape (unless `pair`), else the pair.
int launch_f32(const float* q, const float* k, const float* v,
               const float* dout, const int* kv_lens, float* dq, float* dk,
               float* dv, float* lse, float* delta, int B, int nh, int S,
               int dh, int causal, float sm_scale, bool pair,
               cudaStream_t st) {
  if (dh > 128) return (int)cudaErrorInvalidValue;
  if (!pair && S <= kHeadRows && dh <= 64) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_head_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kHeadSmem);
    if (e != cudaSuccess) return (int)e;
    attn_bwd_head_f32_kernel<<<dim3(nh, B), kHeadThr, kHeadSmem, st>>>(
        q, k, v, dout, kv_lens, dq, dk, dv, nh, S, dh, causal, sm_scale);
    return (int)cudaGetLastError();
  }
  return (dh <= 64 ? launch_f32_pair<64> : launch_f32_pair<128>)(
      q, k, v, dout, kv_lens, dq, dk, dv, lse, delta, B, nh, S, dh, causal,
      sm_scale, st);
}

// ---- bf16: tensor cores ------------------------------------------------------

using namespace flash_mma;

constexpr int kHead = 128;             // S up to this: one block a head
constexpr int kHeadThreads = 256;      // 8 warps, 16 query (key) rows each

// Rows [r0, r0 + n) of a [*, dh] bf16 slice zeroed (a kv_len 0 head, keys
// past kv_len) by `step` threads numbered from `i0`, 8 bytes a store.
__device__ __forceinline__ void zero_rows(bf16* slice, int r0, int n, int dh,
                                          int i0, int step) {
  uint2* p = reinterpret_cast<uint2*>(slice + (size_t)r0 * dh);
  for (int i = i0; i < n * dh / 4; i += step) p[i] = make_uint2(0u, 0u);
}

// This thread's part of a warp's 16 x D accumulator rounded to bf16, into
// rows r0 + g, r0 + g + 8 (those < S) and columns < dh of a [S, dh] slice.
template <int NT>
__device__ __forceinline__ void store_acc(bf16* slice, const float (&acc)[NT][4],
                                          int r0, int S, int dh) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= S) continue;
    bf16* row = slice + (size_t)r * dh + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j * 8 + 2 * t < dh)
        *reinterpret_cast<uint32_t*>(row + j * 8) =
            pack(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// acc (16 x D) += A B, A from registers (JT / 2 k-slices of 16, the first
// `kn` live), B = rows [0, 16 kn) of a [*, D + 8] bf16 tile (row-major over
// k).
template <int D, int KN>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&a)[KN][4],
                                       const bf16* b_t, int kn) {
  constexpr int P = D + 8;
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    if (kk >= kn) continue;
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t bv[4];
      frag_b_trans(bv, b_t, kk * 16, j * 8, P);
      mma(acc[j], a[kk], bv[0], bv[1]);
      mma(acc[j + 1], a[kk], bv[2], bv[3]);
    }
  }
}

// acc (16 x D) += A^T B over the query slices [qs0, qs1) of 16: A^T = the
// warp's 16 key columns c0.. of the [*, SP] bf16 buffer ps (ldmatrix
// .trans), B = rows of the [*, D + 8] tile b_t.
template <int D>
__device__ __forceinline__ void mma_atb(float (&acc)[D / 8][4], const bf16* ps,
                                        int SP, int c0, const bf16* b_t,
                                        int qs0, int qs1) {
  constexpr int P = D + 8;
  for (int qs = qs0; qs < qs1; ++qs) {
    uint32_t a[4];
    frag_a_trans(a, ps, qs * 16, c0, SP);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t bv[4];
      frag_b_trans(bv, b_t, qs * 16, j * 8, P);
      mma(acc[j], a, bv[0], bv[1]);
      mma(acc[j + 1], a, bv[2], bv[3]);
    }
  }
}

// S <= 128: one block a (b, h), everything in shared memory; D = dh rounded
// up to 16.
template <int D>
__global__ void __launch_bounds__(kHeadThreads)
attn_bwd_head_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const int* __restrict__ kv_lens, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int nh,
                     int S, int dh, int causal, float sm_scale) {
  constexpr int P = D + 8, NT = D / 8, JT = kHead / 8;
  const int Sr = (S + 15) & ~15;                 // rows staged, 16 a slice
  const int SP = Sr + 8;                         // pitch of the P / dS buffer
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + Sr * P;
  bf16* v_s = k_s + Sr * P;
  bf16* do_s = v_s + Sr * P;
  bf16* ps = do_s + Sr * P;                      // [Sr, SP]: P, then dS
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const size_t head = ((size_t)b * nh + h) * (size_t)S * dh;
  const int len = live_len(kv_lens, b, S);
  if (len == 0) {                                // every P is 0
    zero_rows(dq + head, 0, S, dh, threadIdx.x, kHeadThreads);
    zero_rows(dk + head, 0, S, dh, threadIdx.x, kHeadThreads);
    zero_rows(dv + head, 0, S, dh, threadIdx.x, kHeadThreads);
    return;
  }
  const int Kr = (len + 15) & ~15;               // key rows staged
  stage_async<D, kHeadThreads>(q_s, q + head, 0, S, Sr, dh);
  stage_async<D, kHeadThreads>(k_s, k + head, 0, len, Kr, dh);
  cp_commit();
  stage_async<D, kHeadThreads>(do_s, dout + head, 0, S, Sr, dh);
  stage_async<D, kHeadThreads>(v_s, v + head, 0, len, Kr, dh);
  cp_commit();

  // this warp's query rows, and the keys they see
  const int row0 = warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  const bool qwarp = row0 < S;
  const int wend = causal ? min(len, row0 + 16) : len;
  const float scale2 = sm_scale * kLog2e;
  float s[JT][4], dp[JT][4];
  uint32_t dsa[JT / 2][4];                       // dS as A fragments, bf16
  float delta[2] = {0.f, 0.f};

  cp_wait<1>();
  __syncthreads();
  if (qwarp) {
    // S = Q K^T, its full-row softmax P (fp32, in s)
#pragma unroll
    for (int j = 0; j < JT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<D>(s, q_s, row0, k_s, wend);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < JT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1), row = rows[e >> 1];
        const bool live = row < S && col < wend && (!causal || col <= row);
        s[j][e] = live ? s[j][e] * scale2 : -INFINITY;
        m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
#pragma unroll
    for (int j = 0; j < JT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mi = m[e >> 1];
        s[j][e] = mi == -INFINITY ? 0.f : exp2f(s[j][e] - mi);
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = 1.f / fmaxf(l[i], 1e-30f);          // l == 0: a row with no key
    }
#pragma unroll
    for (int j = 0; j < JT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= l[e >> 1];
    }
  }
  cp_wait<0>();
  __syncthreads();
  if (qwarp) {
    // dP = dO V^T, delta = rowsum(dP . P) with P unrounded
#pragma unroll
    for (int j = 0; j < JT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    mma_abt<D>(dp, do_s, row0, v_s, wend);
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      delta[0] += dp[j][0] * s[j][0] + dp[j][1] * s[j][1];
      delta[1] += dp[j][2] * s[j][2] + dp[j][3] * s[j][3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    }
    // P rounded into the buffer; dS = P (dP - delta) scale rounded into A
    // fragments (0 past the keys this warp sees)
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      if (j * 8 >= Kr) continue;
      bf16* pp = ps + rows[0] * SP + j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(pp) = pack(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(pp + 8 * SP) = pack(s[j][2], s[j][3]);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = s[j][e] * (dp[j][e] - delta[e >> 1]) * sm_scale;
      dsa[j >> 1][(j & 1) * 2] = pack(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack(ds[2], ds[3]);
    }
    // dQ = dS K
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    mma_ab<D>(acc, dsa, k_s, (wend + 15) / 16);
    store_acc(dq + head, acc, row0, S, dh);
  }
  __syncthreads();                               // P is whole

  // this warp's key rows: dV = P^T dO over the query slices that see them
  const int key0 = warp * 16;
  const int qs0 = causal ? warp : 0, qs1 = Sr / 16;
  if (key0 < Kr) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    mma_atb<D>(acc, ps, SP, key0, do_s, qs0, qs1);
    store_acc(dv + head, acc, key0, S, dh);
  } else if (key0 < S) {                         // keys past kv_len
    zero_rows(dv + head, key0, min(16, S - key0), dh, threadIdx.x & 31, 32);
  }
  __syncthreads();                               // P is read
  if (qwarp) {
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk) {
      if (kk * 16 >= Kr) continue;
      bf16* pp = ps + rows[0] * SP + kk * 16 + 2 * t;
      *reinterpret_cast<uint32_t*>(pp) = dsa[kk][0];
      *reinterpret_cast<uint32_t*>(pp + 8 * SP) = dsa[kk][1];
      *reinterpret_cast<uint32_t*>(pp + 8) = dsa[kk][2];
      *reinterpret_cast<uint32_t*>(pp + 8 * SP + 8) = dsa[kk][3];
    }
  }
  __syncthreads();                               // dS is whole
  // dK = dS^T Q
  if (key0 < Kr) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    mma_atb<D>(acc, ps, SP, key0, q_s, qs0, qs1);
    store_acc(dk + head, acc, key0, S, dh);
  } else if (key0 < S) {
    zero_rows(dk + head, key0, min(16, S - key0), dh, threadIdx.x & 31, 32);
  }
}

// 128 < S <= 512, by query tile (64 rows, a warp 16): pass 1 keeps the
// online max m, sum l and d = sum_j e^(s_j - m) dP_j over double-buffered
// 64-key tiles, so lse and delta = d / l come out of one visit; pass 2 forms
// dS and accumulates dQ. lse (base 2) and delta go to an fp32 [B, nh, S]
// scratch for the key kernel.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const int* __restrict__ kv_lens, bf16* __restrict__ dq,
                  float* __restrict__ lse_out, float* __restrict__ delta_out,
                  int nh, int S, int dh, int causal, float sm_scale) {
  constexpr int P = D + 8, NT = D / 8, JT = kMmaKeys / 8, TILE = kMmaKeys * P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kMmaRows * P;
  bf16* k_s = do_s + kMmaRows * P;               // two tiles
  bf16* v_s = k_s + 2 * TILE;                    // two tiles
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const size_t bh = (size_t)b * nh + h;
  const size_t head = bh * S * dh;
  const int q0 = qt * kMmaRows, row0 = q0 + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  const int len = live_len(kv_lens, b, S);
  const int key_end = causal ? min(len, q0 + kMmaRows) : len;
  const int wend = causal ? min(key_end, row0 + 16) : key_end;
  const int nc = (key_end + kMmaKeys - 1) / kMmaKeys;
  const float scale2 = sm_scale * kLog2e;

  auto stage_kv = [&](int c) {
    const int n = min(kMmaKeys, key_end - c * kMmaKeys);
    const int rows_ = (n + 15) & ~15;
    stage_async<D, kMmaThreads>(k_s + (c & 1) * TILE, k + head, c * kMmaKeys,
                                n, rows_, dh);
    stage_async<D, kMmaThreads>(v_s + (c & 1) * TILE, v + head, c * kMmaKeys,
                                n, rows_, dh);
  };
  // s, dp of tile c, s scaled to base 2 and masked
  auto tile_products = [&](float (&s)[JT][4], float (&dp)[JT][4], int c) {
    const int c0 = c * kMmaKeys, off = (c & 1) * TILE;
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<D>(s, q_s, warp * 16, k_s + off, wend - c0);
    mma_abt<D>(dp, do_s, warp * 16, v_s + off, wend - c0);
#pragma unroll
    for (int j = 0; j < JT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + j * 8 + 2 * t + (e & 1), row = rows[e >> 1];
        const bool live = row < S && col < wend && (!causal || col <= row);
        s[j][e] = live ? s[j][e] * scale2 : -INFINITY;
      }
    }
  };
  // waits for tile c after issuing tile c + 1
  auto next = [&](int c) {
    if (c + 1 < nc) {
      stage_kv(c + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
  };

  stage_async<D, kMmaThreads>(q_s, q + head, q0, min(kMmaRows, S - q0),
                              kMmaRows, dh);
  stage_async<D, kMmaThreads>(do_s, dout + head, q0, min(kMmaRows, S - q0),
                              kMmaRows, dh);
  if (nc > 0) stage_kv(0);
  cp_commit();
  float s[JT][4], dp[JT][4];

  // pass 1: online m, l and d
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    next(c);
    tile_products(s, dp, c);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
    }
    float mn[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      mn[i] = fmaxf(m[i], mt[i]);
      // a row with no live key yet keeps its zero sums
      const float alpha = mn[i] == -INFINITY ? 1.f : exp2f(m[i] - mn[i]);
      l[i] *= alpha;
      d[i] *= alpha;
      m[i] = mn[i];
    }
#pragma unroll
    for (int j = 0; j < JT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mi = m[e >> 1];
        const float ev = mi == -INFINITY ? 0.f : exp2f(s[j][e] - mi);
        l[e >> 1] += ev;
        d[e >> 1] += ev * dp[j][e];
      }
    }
    __syncthreads();                             // tile c & 1 is free
  }
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    d[i] += __shfl_xor_sync(0xffffffffu, d[i], 1);
    d[i] += __shfl_xor_sync(0xffffffffu, d[i], 2);
    // a row with no live key: lse = +inf makes its P 0 in both kernels
    const bool seen = l[i] > 0.f;
    lse2[i] = seen ? m[i] + log2f(l[i]) : INFINITY;
    delta[i] = seen ? d[i] / l[i] : 0.f;
  }

  // pass 2: dQ = dS K
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (nc > 0) stage_kv(0);
  cp_commit();
  for (int c = 0; c < nc; ++c) {
    next(c);
    tile_products(s, dp, c);
    uint32_t dsa[JT / 2][4];
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - lse2[e >> 1]);   // masked: 0
        ds[e] = p * (dp[j][e] - delta[e >> 1]) * sm_scale;
      }
      dsa[j >> 1][(j & 1) * 2] = pack(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack(ds[2], ds[3]);
    }
    mma_ab<D>(acc, dsa, k_s + (c & 1) * TILE,
              (wend - c * kMmaKeys + 15) / 16);
    __syncthreads();
  }
  cp_wait<0>();

  store_acc(dq + head, acc, row0, S, dh);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= S) continue;
      lse_out[bh * S + rows[i]] = lse2[i];
      delta_out[bh * S + rows[i]] = delta[i];
    }
  }
}

// 128 < S <= 512, by key tile (64 keys, a warp 16): dV += P^T dO and dK +=
// dS^T Q over double-buffered query tiles of QT rows with their rows' lse
// and delta, P^T and dS^T formed from K Q^T and V dO^T in registers.
template <int D, int QT>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const int* __restrict__ kv_lens,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int nh, int S,
                   int dh, int causal, float sm_scale) {
  constexpr int P = D + 8, NT = D / 8, JT = QT / 8, TILE = QT * P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kMmaKeys * P;
  bf16* q_s = v_s + kMmaKeys * P;                // two tiles
  bf16* do_s = q_s + 2 * TILE;                   // two tiles
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * TILE);   // two of QT
  float* dl_s = lse_s + 2 * QT;                  // two of QT
  const int k0 = blockIdx.x * kMmaKeys, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const size_t bh = (size_t)b * nh + h;
  const size_t head = bh * S * dh;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const int len = live_len(kv_lens, b, S);
  if (k0 >= len) {                               // every key past kv_len
    const int n = min(kMmaKeys, S - k0);
    zero_rows(dk + head, k0, n, dh, threadIdx.x, kMmaThreads);
    zero_rows(dv + head, k0, n, dh, threadIdx.x, kMmaThreads);
    return;
  }
  const float scale2 = sm_scale * kLog2e;
  // queries that may see a key of this tile: from the tile on, if causal
  const int qb = causal ? k0 : 0;
  const int nt = (S - qb + QT - 1) / QT;

  auto stage_q = [&](int it) {
    const int q0 = qb + it * QT, n = min(QT, S - q0), o = (it & 1);
    stage_async<D, kMmaThreads>(q_s + o * TILE, q + head, q0, n, QT, dh);
    stage_async<D, kMmaThreads>(do_s + o * TILE, dout + head, q0, n, QT, dh);
    for (int i = threadIdx.x; i < QT; i += kMmaThreads) {
      if (i < n) {
        cp_async4(lse_s + o * QT + i, lse + bh * S + q0 + i);
        cp_async4(dl_s + o * QT + i, delta + bh * S + q0 + i);
      } else {                                   // past S: P = 0
        lse_s[o * QT + i] = INFINITY;
        dl_s[o * QT + i] = 0.f;
      }
    }
  };

  stage_async<D, kMmaThreads>(k_s, k + head, k0, min(kMmaKeys, len - k0),
                              kMmaKeys, dh);
  stage_async<D, kMmaThreads>(v_s, v + head, k0, min(kMmaKeys, len - k0),
                              kMmaKeys, dh);
  stage_q(0);
  cp_commit();
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt) {
      stage_q(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = qb + it * QT, o = it & 1;
    const bf16* qt_s = q_s + o * TILE;
    const bf16* dt_s = do_s + o * TILE;
    float st[JT][4], dpt[JT][4];                 // S^T, dP^T: keys x queries
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    mma_abt<D>(st, k_s, warp * 16, qt_s, QT);
    mma_abt<D>(dpt, v_s, warp * 16, dt_s, QT);
    uint32_t pa[JT / 2][4], dsa[JT / 2][4];      // P^T, dS^T as A, bf16
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1), key = keys[e >> 1];
        const bool live = key < len && (!causal || key <= q0 + col);
        p[e] = live ? exp2f(st[j][e] * scale2 - lse_s[o * QT + col]) : 0.f;
        ds[e] = p[e] * (dpt[j][e] - dl_s[o * QT + col]) * sm_scale;
      }
      pa[j >> 1][(j & 1) * 2] = pack(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack(p[2], p[3]);
      dsa[j >> 1][(j & 1) * 2] = pack(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack(ds[2], ds[3]);
    }
    mma_ab<D>(dva, pa, dt_s, JT / 2);
    mma_ab<D>(dka, dsa, qt_s, JT / 2);
    __syncthreads();                             // tile it & 1 is free
  }

  store_acc(dk + head, dka, k0 + warp * 16, S, dh);
  store_acc(dv + head, dva, k0 + warp * 16, S, dh);
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                const int* kv_lens, bf16* dq, bf16* dk, bf16* dv, float* lse,
                float* delta, int B, int nh, int S, int dh, int causal,
                float sm_scale, cudaStream_t st) {
  constexpr int P = D + 8;
  if (S <= kHead) {
    const int Sr = (S + 15) & ~15;
    const int smem = (4 * Sr * P + Sr * (Sr + 8)) * (int)sizeof(bf16);
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_head_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attn_bwd_head_kernel<D><<<dim3(nh, B), kHeadThreads, smem, st>>>(
        q, k, v, dout, kv_lens, dq, dk, dv, nh, S, dh, causal, sm_scale);
    return (int)cudaGetLastError();
  }
  constexpr int QT = D <= 64 ? 64 : 32;          // registers at D > 64
  constexpr int kSmemQ = (2 * kMmaRows + 4 * kMmaKeys) * P * (int)sizeof(bf16);
  constexpr int kSmemKV =
      (2 * kMmaKeys + 4 * QT) * P * (int)sizeof(bf16) + 4 * QT * 4;
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_q_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_kv_kernel<D, QT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemKV);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kMmaRows - 1) / kMmaRows, nh, B);
  attn_bwd_q_kernel<D><<<grid, kMmaThreads, kSmemQ, st>>>(
      q, k, v, dout, kv_lens, dq, lse, delta, nh, S, dh, causal, sm_scale);
  attn_bwd_kv_kernel<D, QT><<<grid, kMmaThreads, kSmemKV, st>>>(
      q, k, v, dout, kv_lens, lse, delta, dk, dv, nh, S, dh, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [B, nh, S, dh] of the entry's type; kv_lens:
// [B] int32 or null; lse and delta: [B, nh, S] fp32 scratch the wrapper
// allocates (fp32, and bf16 past S = 128; the bf16 head kernel needs none).
extern "C" int attention_backward_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const int* kv_lens, float* dq, float* dk, float* dv, float* lse,
    float* delta, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  return launch_f32(q, k, v, dout, kv_lens, dq, dk, dv, lse, delta, B, nh, S,
                    dh, causal, sm_scale, false, (cudaStream_t)stream);
}

// The same, always through the query/key pair (to time it against the head
// kernel at the shapes the head kernel takes).
extern "C" int attention_backward_f32_pair(
    const float* q, const float* k, const float* v, const float* dout,
    const int* kv_lens, float* dq, float* dk, float* dv, float* lse,
    float* delta, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  return launch_f32(q, k, v, dout, kv_lens, dq, dk, dv, lse, delta, B, nh, S,
                    dh, causal, sm_scale, true, (cudaStream_t)stream);
}

extern "C" int attention_backward_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const int* kv_lens, bf16* dq, bf16* dk, bf16* dv, float* lse,
    float* delta, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // the head width rounded up to a multiple of 16, zero-filled in the tiles
#define ATTN_BWD_BF16(D)                                                      \
  case D:                                                                     \
    return launch_bf16<D>(q, k, v, dout, kv_lens, dq, dk, dv, lse, delta, B,  \
                          nh, S, dh, causal, sm_scale, st)
  switch ((dh + 15) & ~15) {
    ATTN_BWD_BF16(16);
    ATTN_BWD_BF16(32);
    ATTN_BWD_BF16(48);
    ATTN_BWD_BF16(64);
    ATTN_BWD_BF16(80);
    ATTN_BWD_BF16(96);
    ATTN_BWD_BF16(112);
    ATTN_BWD_BF16(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ATTN_BWD_BF16
}
