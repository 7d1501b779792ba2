// K10: flash-attention forward, fp32 and bf16, for sm_90a.
//
// Replaces the forward of the bundled TPU flash-attention kernel that
// paddle_tpu/ops/attention_ops.py:147 flash_attention calls at :176 (its
// "flash_bundled" arm, taken past S = 1024, or past S = 512 with
// use_pallas): jax/experimental/pallas/ops/tpu/flash_attention.py:589
// _flash_attention_impl (pallas_call :758, body
// _flash_attention_kernel_single_batch).
// out[b, h] = softmax(Q K^T * scale) V over [S, dh], causal or not, and the
// fp32 log-sum-exp lse = m + log l of every row, the statistics the
// backward (K11) reads in place of the TPU kernel's saved l and m. As there:
// the scores are fp32 products of the operands (:396) times the scale, the
// causal mask is applied to them and key tiles past a query tile's last row
// are skipped (below_or_on_diag :325), the online max and sum are fp32, the
// weights P are rounded to V's dtype before they multiply V (:471), and the
// output is rounded at its store (:477). The TPU kernel needs S % 128 == 0;
// this one masks the ragged edge itself and takes any S >= 1, for dh = 64
// or 128 (instantiated for those head widths only).
//
// What bounds it on this card: the operations (two products of 2 S^2 dh
// per head, halved by the causal mask): fp32 on the CUDA cores (67
// TFLOP/s), bf16 on the tensor cores (989 TFLOP/s); the bytes (q, k, v read,
// out written once) are far smaller at S > 512.
//
// What the design does about it: the [S, S] scores never exist; K and V
// stream through shared memory in key tiles, only up to the causal bound of
// the block's last row, under an online softmax in base 2 (scores
// pre-multiplied by log2 e, exp2f), so HBM sees q and out once and k, v once
// per query tile.
//   * fp32 (register micro-tiles on the CUDA cores, flash_tile.cuh
//     flash_simt): a block of 128 threads owns 64 query rows of one (b, h);
//     a thread holds an 8 x 4 tile of the scores (rows x keys) and an
//     8 x dh / 16 tile of the output in registers. The query tile and two
//     stages of 64-key K and V tiles sit in fp32 shared memory, the next
//     stage landing by cp.async while this one is used. Each shared float
//     feeds 4 or 8 FMAs, so the shared-memory pipe does not cap the FMA
//     rate; the row max is reduced by four shuffles a row once a tile, the
//     row sum once at the end; P passes through shared memory to the PV
//     product; O is scaled by 1 / l at its store. Only the tile on the
//     diagonal and the tile past S are masked (-inf), and rows and keys
//     past S are zero-filled in shared memory, so no NaN enters a product.
//     dh = 64: 168 registers a thread, no spill, 107,520 bytes of shared
//     memory, 2 blocks (8 warps) an SM; dh = 128: 218 registers, no spill,
//     189,440 bytes, 1 block (ptxas -v, sm_90a). What bounds it: latency.
//     By count of the product loops about 85% of its instructions are
//     FMAs, and it reaches about half the fp32 peak, so the rest is stalls
//     on shared loads and on the two barriers a tile, with 8 warps an SM.
//   * bf16 (mma.sync m16n8k16, fp32 accumulators): a block owns 64 query
//     rows, a warp 16, with Q as A fragments in registers; 64-key tiles of K
//     and V in bf16 shared memory; S = Q K^T and O += P V on the tensor
//     cores, P rounded to bf16 as it becomes the PV product's A fragment.
#include <cuda_runtime.h>
#include <math.h>

#include "attention_f32.cuh"

namespace {

using namespace flash_mma;
using namespace flash_simt;

// The fp32 kernel (register micro-tiles, attention_f32.cuh attn_fwd, K2's
// body too): a block of 16 RG threads owns 8 RG query rows; K and V stream
// in 64-key tiles, double-buffered by cp.async. Dynamic shared memory: the
// query tile, two stages of (K, V), and P.
template <int D, int RG>
__global__ void __launch_bounds__(16 * RG)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int nh, int S, int causal,
                     float sm_scale) {
  attn_fwd<D, RG>(q, k, v, out, lse, nh, S, D, S, causal, sm_scale);
}

// The bf16 kernel on the tensor cores: a block owns 64 query rows, a warp
// 16, Q in A fragments in registers; K and V tiles of 64 keys in shared
// memory; S = Q K^T and O += P V by mma.sync with fp32 accumulators, P
// rounded to bf16 as it becomes the A fragment of the PV product (the TPU
// kernel's cast at :471).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int nh, int S, int causal,
                     float sm_scale) {
  constexpr int P = D + 8, KS = D / 16, NT = D / 8, JT = kMmaKeys / 8;
  __shared__ __align__(16) bf16 k_s[kMmaKeys * P];
  __shared__ __align__(16) bf16 v_s[kMmaKeys * P];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * nh + h;
  const bf16* qh = q + bh * S * D;
  const bf16* kh = k + bh * S * D;
  const bf16* vh = v + bh * S * D;
  const int row0 = qt * kMmaRows + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};   // this thread's two rows

  uint32_t qa[KS][4];                            // zeros past S
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rows[i & 1];
      const size_t at = (size_t)r * D + kk * 16 + (i >> 1) * 8 + 2 * t;
      qa[kk][i] = r < S ? ld32(qh + at) : 0u;
    }
  }
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float scale2 = sm_scale * kLog2e;
  const int key_end = causal ? min(S, (qt + 1) * kMmaRows) : S;

  for (int k0 = 0; k0 < key_end; k0 += kMmaKeys) {
    const int nk = min(kMmaKeys, key_end - k0);
    __syncthreads();                             // the last tile is read
    stage_tile<D>(k_s, kh, k0, nk);
    stage_tile<D>(v_s, vh, k0, nk);
    __syncthreads();

    float s[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const bf16* kp = k_s + (j * 8 + g) * P + kk * 16 + 2 * t;
        mma(s[j], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < JT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1), row = rows[e >> 1];
        const bool live = col < key_end && (!causal || col <= row);
        s[j][e] = live ? s[j][e] * scale2 : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    }
    float mn[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      mn[i] = fmaxf(m[i], mt[i]);
      // a row with no live key yet keeps its zero sums (no exp of -inf - -inf)
      const float alpha = mn[i] == -INFINITY ? 1.f : exp2f(m[i] - mn[i]);
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
      m[i] = mn[i];
    }
    uint32_t pa[JT / 2][4];                      // P as A fragments, bf16
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mi = mn[e >> 1];
        p[e] = mi == -INFINITY ? 0.f : exp2f(s[j][e] - mi);
      }
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pa[j >> 1][(j & 1) * 2] = pack(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack(p[2], p[3]);
    }
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bv[4];
        frag_b_trans(bv, v_s, kk * 16, j * 8, P);
        mma(o[j], pa[kk], bv[0], bv[1]);
        mma(o[j + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = rows[i];
    if (r >= S) continue;
    const float inv = 1.f / l[i];
    bf16* orow = out + (bh * S + r) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    if (t == 0) lse[bh * S + r] = (m[i] + log2f(l[i])) * kLn2;
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* out,
               float* lse, int B, int nh, int S, int causal, float sm_scale,
               cudaStream_t st) {
  constexpr int RG = 8, BM = kTM * RG, kSmem = fwd_smem<D, RG>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D, RG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BM - 1) / BM, nh, B);
  flash_fwd_f32_kernel<D, RG><<<grid, 16 * RG, kSmem, st>>>(
      q, k, v, out, lse, nh, S, causal, sm_scale);
  return 0;
}

template <int D>
void launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                 float* lse, int B, int nh, int S, int causal, float sm_scale,
                 cudaStream_t st) {
  dim3 grid((S + kMmaRows - 1) / kMmaRows, nh, B);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, st>>>(
      q, k, v, out, lse, nh, S, causal, sm_scale);
}

}  // namespace

// q, k, v, out: [B, nh, S, dh] of the entry's type; lse: [B, nh, S] fp32.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, float* lse,
                                   int B, int nh, int S, int dh, int causal,
                                   float sm_scale, void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (dh == 64)
    rc = launch_f32<64>(q, k, v, out, lse, B, nh, S, causal, sm_scale, st);
  else if (dh == 128)
    rc = launch_f32<128>(q, k, v, out, lse, B, nh, S, causal, sm_scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return rc ? rc : (int)cudaGetLastError();
}

extern "C" int flash_attention_bf16(const bf16* q, const bf16* k,
                                    const bf16* v, bf16* out, float* lse,
                                    int B, int nh, int S, int dh, int causal,
                                    float sm_scale, void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64)
    launch_bf16<64>(q, k, v, out, lse, B, nh, S, causal, sm_scale, st);
  else if (dh == 128)
    launch_bf16<128>(q, k, v, out, lse, B, nh, S, causal, sm_scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
