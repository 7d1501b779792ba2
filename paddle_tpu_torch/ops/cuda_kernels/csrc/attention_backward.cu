// K4: attention backward (dQ, dK, dV), fp32, for sm_90a.
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
// kv_len 0 row) gets zero gradients, matching K2's zero output. It takes
// any S in 1..512 and dh % 4 == 0, dh <= 128 (K2's domain).
//
// What bounds it on this card: the operations (5 products of 2 S^2 dh each
// per head, fp32 outside the tensor cores, 67 TFLOP/s); the bytes (q, k, v,
// dO read once, dq, dk, dv written once) are smaller at every S >= 16.
//
// What the design does about it: the TPU kernel holds whole fp32 [S, S]
// slabs in VMEM for a group of heads; at S = 512 one head's slab is 1 MB
// against 227 KB of shared memory, and blocks cannot carry sums across one
// another. So the work is split FlashAttention-2 style into two kernels
// that never form an [S, S] array and need no atomics:
//   * by query tile (32 rows, 4 threads a row, as K2): one pass over the
//     key/value tiles in shared memory keeps the online max m, sum l and
//     d = sum_j e^(s_j - m) dP_j, so lse = m + log l and delta = d / l come
//     out of one visit; a second pass forms dS row by row and accumulates
//     dQ in registers. lse and delta go to a [B, nh, S] fp32 scratch.
//   * by key tile (32 keys, 4 threads a key): each thread holds its key's
//     quarter of k and v and of the dK, dV sums in registers; query and dO
//     tiles stream through shared memory (only those at or after the tile
//     under the causal mask), with the tile rows' lse and delta, so P and dS
//     are rebuilt one (query, key) pair at a time.
// Every dot product is split over the 4 threads of a row and summed with
// two warp shuffles, and each shared-memory read is a broadcast of one row.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;          // query (or key) rows per block: 4 threads each
constexpr int kKeys = 32;          // rows per shared-memory tile
constexpr int kMaxDh = 128;

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ int live_len(const int* kv_lens, int b, int S) {
  return kv_lens == nullptr ? S : min(max(kv_lens[b], 0), S);
}

// Stage rows [r0, r0 + n) of two [S, dh] head slices into shared memory.
__device__ __forceinline__ void stage2(float* a_s, float* b_s, const float* a,
                                       const float* b, int r0, int n, int dh,
                                       int nd) {
  const float4* ag = reinterpret_cast<const float4*>(a + (size_t)r0 * dh);
  const float4* bg = reinterpret_cast<const float4*>(b + (size_t)r0 * dh);
  for (int i = threadIdx.x; i < n * nd; i += kThreads) {
    reinterpret_cast<float4*>(a_s)[i] = ag[i];
    reinterpret_cast<float4*>(b_s)[i] = bg[i];
  }
}

// ND = dims each thread holds (dh / 4); kGuard = true serves any other
// dh % 4 == 0 with ND = 32 and the dims past dh skipped (as in K2).
template <int ND, bool kGuard>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const int* __restrict__ kv_lens, float* __restrict__ dq,
                   float* __restrict__ lse_out, float* __restrict__ delta_out,
                   int nh, int S, int dh, int causal, float sm_scale) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, t4 = tid & 3;
  const int qi = qt * kRows + (tid >> 2);
  const bool row_live = qi < S;
  const int nd = kGuard ? (dh >> 2) : ND;
  const size_t head = ((size_t)b * nh + h) * (size_t)S * dh;

  __shared__ __align__(16) float k_s[kKeys * kMaxDh];
  __shared__ __align__(16) float v_s[kKeys * kMaxDh];

  const int len = live_len(kv_lens, b, S);
  int key_end = len;                             // keys any row here may see
  if (causal) key_end = min(key_end, min(S, (qt + 1) * kRows));
  int row_end = key_end;                         // keys this row may see
  if (causal) row_end = min(row_end, qi + 1);
  if (!row_live) row_end = 0;

  float qr[ND], dor[ND], acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const bool on = row_live && (!kGuard || i < nd);
    const size_t at = head + (size_t)qi * dh + 4 * i + t4;
    qr[i] = on ? q[at] * sm_scale : 0.f;
    dor[i] = on ? dout[at] : 0.f;
    acc[i] = 0.f;
  }

  // pass 1: online m, l and d = sum_j e^(s_j - m) dP_j
  float m = -INFINITY, l = 0.f, d = 0.f;
  for (int k0 = 0; k0 < key_end; k0 += kKeys) {
    const int nk = min(kKeys, key_end - k0);
    stage2(k_s, v_s, k + head, v + head, k0, nk, dh, nd);
    __syncthreads();
    float s[kKeys], dp[kKeys];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float ps = 0.f, pd = 0.f;
      if (j < nk) {
#pragma unroll
        for (int i = 0; i < ND; ++i)
          if (!kGuard || i < nd) {
            ps += qr[i] * k_s[j * dh + 4 * i + t4];
            pd += dor[i] * v_s[j * dh + 4 * i + t4];
          }
      }
      ps = quad_sum(ps);
      dp[j] = quad_sum(pd);
      s[j] = (k0 + j < row_end) ? ps : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    if (m_new != -INFINITY) {                    // the row saw a live key
      const float alpha = expf(m - m_new);       // 0 on the first live tile
      float l_tile = 0.f, d_tile = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float e = expf(s[j] - m_new);      // masked: exp(-inf) == 0
        l_tile += e;
        d_tile += e * dp[j];
      }
      l = l * alpha + l_tile;
      d = d * alpha + d_tile;
      m = m_new;
    }
    __syncthreads();                             // next tile overwrites k_s, v_s
  }
  // a fully masked row: lse = +inf makes every P of the row 0 in both passes
  const bool seen = l > 0.f;
  const float lse = seen ? m + logf(l) : INFINITY;
  const float delta = seen ? d / l : 0.f;

  // pass 2: dQ = sum_j P_j (dP_j - delta) k_j * scale
  for (int k0 = 0; k0 < key_end; k0 += kKeys) {
    const int nk = min(kKeys, key_end - k0);
    stage2(k_s, v_s, k + head, v + head, k0, nk, dh, nd);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (!kGuard || i < nd) {
          ps += qr[i] * k_s[j * dh + 4 * i + t4];
          pd += dor[i] * v_s[j * dh + 4 * i + t4];
        }
      ps = quad_sum(ps);
      pd = quad_sum(pd);
      const float p = (k0 + j < row_end) ? expf(ps - lse) : 0.f;
      const float ds = p * (pd - delta);
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (!kGuard || i < nd) acc[i] += ds * k_s[j * dh + 4 * i + t4];
    }
    __syncthreads();                             // next tile overwrites k_s, v_s
  }

  if (row_live) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (!kGuard || i < nd) dq[head + (size_t)qi * dh + 4 * i + t4] = acc[i] * sm_scale;
    if (t4 == 0) {
      const size_t r = ((size_t)b * nh + h) * S + qi;
      lse_out[r] = lse;
      delta_out[r] = delta;
    }
  }
}

template <int ND, bool kGuard>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const int* __restrict__ kv_lens,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv,
                    int nh, int S, int dh, int causal, float sm_scale) {
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, t4 = tid & 3;
  const int kj = kt * kRows + (tid >> 2);
  const int nd = kGuard ? (dh >> 2) : ND;
  const size_t head = ((size_t)b * nh + h) * (size_t)S * dh;
  const size_t stat = ((size_t)b * nh + h) * S;

  __shared__ __align__(16) float q_s[kKeys * kMaxDh];
  __shared__ __align__(16) float do_s[kKeys * kMaxDh];
  __shared__ float lse_s[kKeys];
  __shared__ float delta_s[kKeys];

  const int len = live_len(kv_lens, b, S);
  const bool key_live = kj < len;                // keys >= len get zero grads
  // queries that may see a key of this tile: from the tile on, if causal
  const int q_begin = causal ? kt * kRows : 0;
  const int q_end = (kt * kRows < len) ? S : q_begin;

  float kr[ND], vr[ND], dk_acc[ND], dv_acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const bool on = kj < S && (!kGuard || i < nd);
    const size_t at = head + (size_t)kj * dh + 4 * i + t4;
    kr[i] = on ? k[at] : 0.f;
    vr[i] = on ? v[at] : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int q0 = q_begin; q0 < q_end; q0 += kKeys) {
    const int nq = min(kKeys, q_end - q0);
    stage2(q_s, do_s, q + head, dout + head, q0, nq, dh, nd);
    if (tid < nq) {
      lse_s[tid] = lse[stat + q0 + tid];
      delta_s[tid] = delta[stat + q0 + tid];
    }
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (!kGuard || i < nd) {
          ps += kr[i] * q_s[r * dh + 4 * i + t4];
          pd += vr[i] * do_s[r * dh + 4 * i + t4];
        }
      ps = quad_sum(ps);
      pd = quad_sum(pd);
      const bool live = key_live && (!causal || kj <= q0 + r);
      const float p = live ? expf(ps * sm_scale - lse_s[r]) : 0.f;
      const float ds = p * (pd - delta_s[r]);
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (!kGuard || i < nd) {
          dv_acc[i] += p * do_s[r * dh + 4 * i + t4];
          dk_acc[i] += ds * q_s[r * dh + 4 * i + t4];
        }
    }
    __syncthreads();                             // next tile overwrites q_s, do_s
  }

  if (kj < S) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (!kGuard || i < nd) {
        const size_t at = head + (size_t)kj * dh + 4 * i + t4;
        dk[at] = dk_acc[i] * sm_scale;
        dv[at] = dv_acc[i];
      }
  }
}

}  // namespace

// lse and delta: [B, nh, S] fp32 scratch the wrapper allocates.
extern "C" int attention_backward_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const int* kv_lens, float* dq, float* dk, float* dv, float* lse,
    float* delta, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  dim3 grid((S + kRows - 1) / kRows, nh, B);
  cudaStream_t st = (cudaStream_t)stream;
#define ATTN_BWD_LAUNCH(ND, GUARD)                                            \
  attn_bwd_dq_kernel<ND, GUARD><<<grid, kThreads, 0, st>>>(                   \
      q, k, v, dout, kv_lens, dq, lse, delta, nh, S, dh, causal, sm_scale);   \
  attn_bwd_dkv_kernel<ND, GUARD><<<grid, kThreads, 0, st>>>(                  \
      q, k, v, dout, kv_lens, lse, delta, dk, dv, nh, S, dh, causal, sm_scale)
  switch (dh) {
    case 8: ATTN_BWD_LAUNCH(2, false); break;
    case 16: ATTN_BWD_LAUNCH(4, false); break;
    case 32: ATTN_BWD_LAUNCH(8, false); break;
    case 64: ATTN_BWD_LAUNCH(16, false); break;
    case 128: ATTN_BWD_LAUNCH(32, false); break;
    default: ATTN_BWD_LAUNCH(kMaxDh / 4, true); break;
  }
#undef ATTN_BWD_LAUNCH
  return (int)cudaGetLastError();
}
