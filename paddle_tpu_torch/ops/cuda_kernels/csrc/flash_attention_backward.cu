// K11: flash-attention backward (dQ, dK, dV), fp32 and bf16, for sm_90a.
//
// Replaces the backward of the bundled TPU flash-attention kernel (the
// "flash_bundled" arm of paddle_tpu/ops/attention_ops.py:147), in
// jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_bwd
// (:254, di = rowsum(O . dO) at :274), _flash_attention_bwd_dkv :941
// (pallas_call :1121) and _flash_attention_bwd_dq :1287 (pallas_call
// :1456). From q, k, v, the forward's output O and log-sum-exp (K10), and
// dO, all [B, nh, S, dh] but lse [B, nh, S], it writes
//   di = rowsum(O . dO)                      (fp32, from the rounded O)
//   P  = exp(Q K^T * scale - lse)            (causal mask as in K10)
//   dV = P^T dO,  dP = dO V^T,  dS = (dP - di) P * scale,
//   dQ = dS K,    dK = dS^T Q.
// di comes from O, not from a recomputed P (where K4 differs): the TPU
// kernel's formula. In bf16 P is rounded before it multiplies dO (:900)
// and dS before it multiplies Q (:918) and K (:1258), and the outputs at
// their stores; the sums are fp32. Any S >= 1, dh = 64 or 128.
//
// What bounds it on this card: the operations (five products of 2 S^2 dh
// per head, halved by the causal mask): fp32 on the CUDA cores (67
// TFLOP/s), bf16 on the tensor cores (989 TFLOP/s); the bytes (q, k, v, O,
// dO read, dq, dk, dv written once) are far smaller at S > 512.
//
// What the design does about it: two kernels, as the TPU kernel's two
// passes, with no [S, S] array and no atomics (K4's shape):
//   * by query tile: di from the rows' O and dO, then one pass over the key
//     and value tiles that rebuilds P and dS and accumulates dQ; di goes to
//     an fp32 [B, nh, S] scratch;
//   * by key tile: query and dO tiles stream through shared memory with
//     their rows' lse and di (only the tiles at or after the key tile under
//     the causal mask), rebuilding P and dS and accumulating dK and dV.
// That is seven products of work for the five the function needs (the
// scores and dP are formed in both kernels), bought for having no atomics
// and no [S, S] scratch. fp32 runs SIMT, four threads a row holding
// quarters of its vectors and sums, 32-row tiles (flash_tile.cuh, as K10);
// bf16 runs mma.sync m16n8k16 with fp32 accumulators, a warp owning 16 rows
// of a 64-row tile, P and dS rounded to bf16 as they become A fragments
// (the key pass's query tile is 32 rows at dh = 128, for registers).
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tile.cuh"

namespace {

using namespace flash;
using namespace flash_mma;

constexpr float kLog2e = 1.4426950408889634f;

// The fp32 kernels (SIMT); ND = dh / 4, the dims a thread holds. By query
// tile: di, then dQ.
template <int ND>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ lse, const float* __restrict__ dout,
                    float* __restrict__ dq, float* __restrict__ di_out, int nh,
                    int S, int causal, float sm_scale) {
  constexpr int dh = 4 * ND;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int qi = qt * kRows + (threadIdx.x >> 2);
  const bool row_live = qi < S;
  const size_t bh = (size_t)b * nh + h;
  const size_t head = bh * S * dh;

  __shared__ __align__(16) float k_s[Tile<ND>::kFloats];
  __shared__ __align__(16) float v_s[Tile<ND>::kFloats];

  const int key_end = causal ? min(S, (qt + 1) * kRows) : S;
  const int row_end = !row_live ? 0 : (causal ? qi + 1 : S);
  const float scale2 = sm_scale * kLog2e;

  float qr[ND], dor[ND], acc[ND];
  load_quarter<float, ND>(qr, o + head, qi, row_live);     // O first, for di
  load_quarter<float, ND>(dor, dout + head, qi, row_live);
  float di = 0.f;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    di += qr[i] * dor[i];
    acc[i] = 0.f;
  }
  di = quad_sum(di);
  load_quarter<float, ND>(qr, q + head, qi, row_live);
  const float lse2 = row_live ? lse[bh * S + qi] * kLog2e : 0.f;

  for (int k0 = 0; k0 < key_end; k0 += kTile) {
    const int nk = min(kTile, key_end - k0);
    stage<float, ND>(k_s, k + head, k0, nk);
    stage<float, ND>(v_s, v + head, k0, nk);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float* kq = quarter<ND>(k_s, j);
      const float s = quad_sum(dot<ND>(qr, kq));
      const float dp = quad_sum(dot<ND>(dor, quarter<ND>(v_s, j)));
      const float p = (k0 + j < row_end) ? exp2f(s * scale2 - lse2) : 0.f;
      const float ds = (dp - di) * p;            // the scale at the store
      axpy<ND>(acc, ds, kq);
    }
    __syncthreads();                             // next tile overwrites k_s, v_s
  }

  if (row_live) {
    store_quarter<float, ND>(dq + head, qi, acc, sm_scale);
    if ((threadIdx.x & 3) == 0) di_out[bh * S + qi] = di;
  }
}

// By key tile: dK and dV.
template <int ND>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lse,
                     const float* __restrict__ di, const float* __restrict__ dout,
                     float* __restrict__ dk, float* __restrict__ dv, int nh, int S,
                     int causal, float sm_scale) {
  constexpr int dh = 4 * ND;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int kj = kt * kRows + (tid >> 2);
  const bool key_live = kj < S;
  const size_t bh = (size_t)b * nh + h;
  const size_t head = bh * S * dh;
  const size_t stat = bh * S;

  __shared__ __align__(16) float q_s[Tile<ND>::kFloats];
  __shared__ __align__(16) float do_s[Tile<ND>::kFloats];
  __shared__ float lse_s[kTile];
  __shared__ float di_s[kTile];

  // queries that may see a key of this tile: from the tile on, if causal
  const int q_begin = causal ? kt * kRows : 0;
  const float scale2 = sm_scale * kLog2e;

  float kr[ND], vr[ND], dk_acc[ND], dv_acc[ND];
  load_quarter<float, ND>(kr, k + head, kj, key_live);
  load_quarter<float, ND>(vr, v + head, kj, key_live);
#pragma unroll
  for (int i = 0; i < ND; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int q0 = q_begin; q0 < S; q0 += kTile) {
    const int nq = min(kTile, S - q0);
    stage<float, ND>(q_s, q + head, q0, nq);
    stage<float, ND>(do_s, dout + head, q0, nq);
    if (tid < nq) {
      lse_s[tid] = lse[stat + q0 + tid] * kLog2e;
      di_s[tid] = di[stat + q0 + tid];
    }
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      const float* qq = quarter<ND>(q_s, r);
      const float* dq_row = quarter<ND>(do_s, r);
      const float s = quad_sum(dot<ND>(kr, qq));
      const float dp = quad_sum(dot<ND>(vr, dq_row));
      const bool live = key_live && (!causal || kj <= q0 + r);
      const float p = live ? exp2f(s * scale2 - lse_s[r]) : 0.f;
      const float ds = (dp - di_s[r]) * p;       // the scale at the store
      axpy<ND>(dv_acc, p, dq_row);
      axpy<ND>(dk_acc, ds, qq);
    }
    __syncthreads();                             // next tile overwrites q_s, do_s
  }

  if (key_live) {
    store_quarter<float, ND>(dk + head, kj, dk_acc, sm_scale);
    store_quarter<float, ND>(dv + head, kj, dv_acc, 1.f);
  }
}

// The bf16 kernels on the tensor cores. A 32-bit pair of bf16 as floats:
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// By query tile: di from O and dO, then dQ += dS K over the key tiles.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const float* __restrict__ lse,
                        const bf16* __restrict__ dout, bf16* __restrict__ dq,
                        float* __restrict__ di_out, int nh, int S, int causal,
                        float sm_scale) {
  constexpr int P = D + 8, KS = D / 16, NT = D / 8, JT = kMmaKeys / 8;
  __shared__ __align__(16) bf16 k_s[kMmaKeys * P];
  __shared__ __align__(16) bf16 v_s[kMmaKeys * P];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * nh + h;
  const size_t head = bh * S * D;
  const int row0 = qt * kMmaRows + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};   // this thread's two rows

  uint32_t qa[KS][4], da[KS][4];                 // Q and dO, zeros past S
  float di[2] = {0.f, 0.f}, lse2[2];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rows[i & 1];
      const size_t at = head + (size_t)r * D + kk * 16 + (i >> 1) * 8 + 2 * t;
      qa[kk][i] = da[kk][i] = 0u;
      if (r < S) {
        qa[kk][i] = ld32(q + at);
        da[kk][i] = ld32(dout + at);
        const uint32_t ov = ld32(o + at);
        di[i & 1] += lo_f(ov) * lo_f(da[kk][i]) + hi_f(ov) * hi_f(da[kk][i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    di[i] += __shfl_xor_sync(0xffffffffu, di[i], 1);
    di[i] += __shfl_xor_sync(0xffffffffu, di[i], 2);
    lse2[i] = rows[i] < S ? lse[bh * S + rows[i]] * kLog2e : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float scale2 = sm_scale * kLog2e;
  const int key_end = causal ? min(S, (qt + 1) * kMmaRows) : S;

  for (int k0 = 0; k0 < key_end; k0 += kMmaKeys) {
    const int nk = min(kMmaKeys, key_end - k0);
    __syncthreads();                             // the last tile is read
    stage_tile<D>(k_s, k + head, k0, nk);
    stage_tile<D>(v_s, v + head, k0, nk);
    __syncthreads();
    float s[JT][4], dp[JT][4];
#pragma unroll
    for (int j = 0; j < JT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const bf16* kp = k_s + (j * 8 + g) * P + kk * 16 + 2 * t;
        const bf16* vp = v_s + (j * 8 + g) * P + kk * 16 + 2 * t;
        mma(s[j], qa[kk], ld32(kp), ld32(kp + 8));
        mma(dp[j], da[kk], ld32(vp), ld32(vp + 8));
      }
    }
    uint32_t dsa[JT / 2][4];                     // dS as A fragments, bf16
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1), i = e >> 1;
        const bool live = rows[i] < S && col < key_end &&
                          (!causal || col <= rows[i]);
        const float p = live ? exp2f(s[j][e] * scale2 - lse2[i]) : 0.f;
        ds[e] = (dp[j][e] - di[i]) * p * sm_scale;
      }
      dsa[j >> 1][(j & 1) * 2] = pack(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];
        frag_b_trans(bk, k_s, kk * 16, j * 8, P);
        mma(acc[j], dsa[kk], bk[0], bk[1]);
        mma(acc[j + 1], dsa[kk], bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rows[i];
    if (r >= S) continue;
    bf16* row = dq + head + (size_t)r * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack(acc[j][2 * i], acc[j][2 * i + 1]);
    if (t == 0) di_out[bh * S + r] = di[i];
  }
}

// By key tile: dV += P^T dO and dK += dS^T Q over the query tiles of QT
// rows, the block's K and V tiles and the query tile in dynamic shared
// memory.
template <int D, int QT>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         const bf16* __restrict__ dout, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int nh, int S, int causal,
                         float sm_scale) {
  constexpr int P = D + 8, KS = D / 16, NT = D / 8, JT = QT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kMmaKeys * P;
  bf16* q_s = v_s + kMmaKeys * P;
  bf16* do_s = q_s + QT * P;
  float* lse_s = reinterpret_cast<float*>(do_s + QT * P);
  float* di_s = lse_s + QT;
  const int k0 = blockIdx.x * kMmaKeys, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * nh + h;
  const size_t head = bh * S * D;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float scale2 = sm_scale * kLog2e;

  stage_tile<D>(k_s, k + head, k0, min(kMmaKeys, S - k0));
  stage_tile<D>(v_s, v + head, k0, min(kMmaKeys, S - k0));
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  // queries that may see a key of this tile: from the tile on, if causal
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += QT) {
    const int nq = min(QT, S - q0);
    __syncthreads();                             // the last tile is read
    stage_tile<D>(q_s, q + head, q0, nq, QT);
    stage_tile<D>(do_s, dout + head, q0, nq, QT);
    for (int i = threadIdx.x; i < QT; i += kMmaThreads) {
      // a query past S: lse = +inf makes its P, and dS, zero
      lse_s[i] = i < nq ? lse[bh * S + q0 + i] * kLog2e : INFINITY;
      di_s[i] = i < nq ? di[bh * S + q0 + i] : 0.f;
    }
    __syncthreads();
    float st[JT][4], dpt[JT][4];                 // S^T, dP^T: keys x queries
#pragma unroll
    for (int j = 0; j < JT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, k_s, warp * 16, kk * 16, P);
      frag_a(av, v_s, warp * 16, kk * 16, P);
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const bf16* qp = q_s + (j * 8 + g) * P + kk * 16 + 2 * t;
        const bf16* dp = do_s + (j * 8 + g) * P + kk * 16 + 2 * t;
        mma(st[j], ak, ld32(qp), ld32(qp + 8));
        mma(dpt[j], av, ld32(dp), ld32(dp + 8));
      }
    }
    uint32_t pa[JT / 2][4], dsa[JT / 2][4];      // P^T, dS^T as A, bf16
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1), key = keys[e >> 1];
        const bool live = key < S && (!causal || key <= q0 + col);
        p[e] = live ? exp2f(st[j][e] * scale2 - lse_s[col]) : 0.f;
        ds[e] = (dpt[j][e] - di_s[col]) * p[e] * sm_scale;
      }
      pa[j >> 1][(j & 1) * 2] = pack(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack(p[2], p[3]);
      dsa[j >> 1][(j & 1) * 2] = pack(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < JT / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bd[4], bq[4];
        frag_b_trans(bd, do_s, kk * 16, j * 8, P);
        frag_b_trans(bq, q_s, kk * 16, j * 8, P);
        mma(dva[j], pa[kk], bd[0], bd[1]);
        mma(dva[j + 1], pa[kk], bd[2], bd[3]);
        mma(dka[j], dsa[kk], bq[0], bq[1]);
        mma(dka[j + 1], dsa[kk], bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = keys[i];
    if (key >= S) continue;
    const size_t at = head + (size_t)key * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + j * 8) =
          pack(dka[j][2 * i], dka[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + j * 8) =
          pack(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

template <int ND>
void launch_f32(const float* q, const float* k, const float* v, const float* o,
                const float* lse, const float* dout, float* dq, float* dk,
                float* dv, float* di, int B, int nh, int S, int causal,
                float sm_scale, cudaStream_t st) {
  dim3 grid((S + kRows - 1) / kRows, nh, B);
  flash_bwd_dq_kernel<ND><<<grid, kThreads, 0, st>>>(
      q, k, v, o, lse, dout, dq, di, nh, S, causal, sm_scale);
  flash_bwd_dkv_kernel<ND><<<grid, kThreads, 0, st>>>(
      q, k, v, lse, di, dout, dk, dv, nh, S, causal, sm_scale);
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                const float* lse, const bf16* dout, bf16* dq, bf16* dk,
                bf16* dv, float* di, int B, int nh, int S, int causal,
                float sm_scale, cudaStream_t st) {
  constexpr int QT = D == 64 ? 64 : 32;          // registers at D = 128
  constexpr int kSmem =
      (2 * kMmaKeys + 2 * QT) * (D + 8) * (int)sizeof(bf16) + 2 * QT * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D, QT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kMmaRows - 1) / kMmaRows, nh, B);
  flash_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, 0, st>>>(
      q, k, v, o, lse, dout, dq, di, nh, S, causal, sm_scale);
  flash_bwd_dkv_mma_kernel<D, QT><<<grid, kMmaThreads, kSmem, st>>>(
      q, k, v, lse, di, dout, dk, dv, nh, S, causal, sm_scale);
  return 0;
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: [B, nh, S, dh] of the entry's type; lse:
// [B, nh, S] fp32 from K10; di: [B, nh, S] fp32 scratch the wrapper
// allocates (written by the query pass, read by the key pass).
extern "C" int flash_attention_backward_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* lse, const float* dout, float* dq, float* dk, float* dv,
    float* di, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64)
    launch_f32<16>(q, k, v, o, lse, dout, dq, dk, dv, di, B, nh, S, causal,
                   sm_scale, st);
  else if (dh == 128)
    launch_f32<32>(q, k, v, o, lse, dout, dq, dk, dv, di, B, nh, S, causal,
                   sm_scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_backward_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* o,
    const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
    float* di, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (dh == 64)
    rc = launch_bf16<64>(q, k, v, o, lse, dout, dq, dk, dv, di, B, nh, S,
                         causal, sm_scale, st);
  else if (dh == 128)
    rc = launch_bf16<128>(q, k, v, o, lse, dout, dq, dk, dv, di, B, nh, S,
                          causal, sm_scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return rc ? rc : (int)cudaGetLastError();
}
