// K2: causal prefill attention, fp32 and bf16, for sm_90a.
//
// Replaces the forward of two TPU kernels:
//   paddle_tpu/ops/pallas_kernels/short_attention.py:248 short128_attention
//     (_fwd :141 -> _fwd_kernel :87; S <= 128, optional ragged kv_lens), and
//   paddle_tpu/ops/pallas_kernels/attention.py:211 short_seq_attention
//     (_fwd :135 -> _fwd_kernel :85; S % 128 == 0, S <= 512).
// out[b, h] = softmax(Q K^T * scale) V over [S, dh], with an optional causal
// mask and key slots >= kv_lens[b] masked; a fully masked row emits zeros.
// It takes any S in 1..512 and dh % 4 == 0, dh <= 128. q, k, v and out are
// fp32 or bf16 (T), widened to fp32 on their way into registers and shared
// memory; the scores, the softmax statistics and the accumulator are fp32.
// In bf16 the softmax weights are rounded to bf16 before they multiply V
// and the output at its store, where the TPU kernel casts them
// (short_attention.py:97, :100); the row sum l is taken unrounded, as there.
//
// What bounds it on this card: at S = 512 the operations (4 S^2 dh / 2 per
// head under the causal mask, in fp32 with TF32 off: 67 TFLOP/s outside the
// tensor cores); at small S the bytes (q, k, v read once, out written once).
// The bf16 instantiation does the same fp32 arithmetic on the CUDA cores
// (no tensor-core path yet), so its bound by operations is the fp32 one.
//
// What the design does about it: the TPU kernels hold a whole [S, S] score
// slab in VMEM; a Hopper block has 227 KB of shared memory, so this kernel
// tiles instead, flash-style. A block owns 32 query rows of one (b, h); four
// threads share a row, each holding a quarter of q and of the fp32
// accumulator in registers (dims 4i + t). K and V stream through shared
// memory in tiles of 32 keys, only up to the causal bound of the block's
// last row (and kv_lens), so masked tiles are never read. The softmax runs
// online over tiles with fp32 (m, l) per row, the [S, S] scores never exist,
// and HBM sees q, k, v and out about once (k, v once per query tile).
#include <cuda_runtime.h>
#include <math.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;          // query rows per block: 4 threads each
constexpr int kKeys = 32;          // keys per shared-memory tile
constexpr int kMaxDh = 128;

// Four consecutive elements at p (aligned to them) widened to a float4.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  float f[4];
  load_vec<bf16, 4>(p, f);
  return make_float4(f[0], f[1], f[2], f[3]);
}

// ND = dims each thread holds (dh / 4). Instantiated exactly for the power
// of two head widths, so q and acc take only the registers they need and
// the dim loops carry no guard; kGuard = true is the one instantiation for
// any other dh % 4 == 0 (ND = 32, dims past dh skipped).
template <typename T, int ND, bool kGuard>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ kv_lens,
                         T* __restrict__ out,
                         int nh, int S, int dh, int causal, float sm_scale) {
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t4 = tid & 3;
  const int qi = qt * kRows + (tid >> 2);
  const bool row_live = qi < S;
  const int nd = kGuard ? (dh >> 2) : ND;        // dims per thread
  const size_t head = ((size_t)b * nh + h) * (size_t)S * dh;

  __shared__ __align__(16) float k_s[kKeys * kMaxDh];
  __shared__ __align__(16) float v_s[kKeys * kMaxDh];

  int len = S;
  if (kv_lens != nullptr) len = min(max(kv_lens[b], 0), S);
  int key_end = len;                             // keys any row here may see
  if (causal) key_end = min(key_end, min(S, (qt + 1) * kRows));
  int row_end = key_end;                         // keys this row may see
  if (causal) row_end = min(row_end, qi + 1);
  if (!row_live) row_end = 0;

  float qr[ND];
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    acc[i] = 0.f;
    qr[i] = (row_live && (!kGuard || i < nd))
                ? to_f(q[head + (size_t)qi * dh + 4 * i + t4]) * sm_scale
                : 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < key_end; k0 += kKeys) {
    const int nk = min(kKeys, key_end - k0);
    const T* kg = k + head + (size_t)k0 * dh;
    const T* vg = v + head + (size_t)k0 * dh;
    for (int i = tid; i < nk * nd; i += kThreads) {
      reinterpret_cast<float4*>(k_s)[i] = load4(kg + 4 * i);
      reinterpret_cast<float4*>(v_s)[i] = load4(vg + 4 * i);
    }
    __syncthreads();

    float s[kKeys];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
      if (j < nk) {
#pragma unroll
        for (int i = 0; i < ND; ++i)
          if (!kGuard || i < nd) part += qr[i] * k_s[j * dh + 4 * i + t4];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = (k0 + j < row_end) ? part : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    if (m_new != -INFINITY) {                    // the row saw a live key
      const float alpha = expf(m - m_new);       // 0 on the first live tile
      float l_tile = 0.f;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        if (j < nk) {
          const float p = expf(s[j] - m_new);    // masked: exp(-inf) == 0
          l_tile += p;
          const float pv = round_to<T>(p);       // P in V's dtype
#pragma unroll
          for (int i = 0; i < ND; ++i)
            if (!kGuard || i < nd) acc[i] += pv * v_s[j * dh + 4 * i + t4];
        }
      }
      l = l * alpha + l_tile;
      m = m_new;
    }
    __syncthreads();                             // next tile overwrites k_s, v_s
  }

  if (row_live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);    // l == 0: a fully masked row
#pragma unroll
    for (int i = 0; i < ND; ++i)
      if (!kGuard || i < nd)
        out[head + (size_t)qi * dh + 4 * i + t4] = from_f<T>(acc[i] * inv);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* kv_lens, T* out,
           int B, int nh, int S, int dh, int causal, float sm_scale,
           void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  dim3 grid((S + kRows - 1) / kRows, nh, B);
  cudaStream_t st = (cudaStream_t)stream;
#define PREFILL_LAUNCH(ND, GUARD)                                        \
  prefill_attention_kernel<T, ND, GUARD><<<grid, kThreads, 0, st>>>(     \
      q, k, v, kv_lens, out, nh, S, dh, causal, sm_scale)
  switch (dh) {
    case 8: PREFILL_LAUNCH(2, false); break;
    case 16: PREFILL_LAUNCH(4, false); break;
    case 32: PREFILL_LAUNCH(8, false); break;
    case 64: PREFILL_LAUNCH(16, false); break;
    case 128: PREFILL_LAUNCH(32, false); break;
    default: PREFILL_LAUNCH(kMaxDh / 4, true); break;
  }
#undef PREFILL_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, nh, S, dh] of the entry's type; kv_lens: [B] int32 or
// null.
extern "C" int causal_prefill_attention_f32(
    const float* q, const float* k, const float* v, const int* kv_lens,
    float* out, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  return launch<float>(q, k, v, kv_lens, out, B, nh, S, dh, causal, sm_scale,
                       stream);
}

extern "C" int causal_prefill_attention_bf16(
    const bf16* q, const bf16* k, const bf16* v, const int* kv_lens,
    bf16* out, int B, int nh, int S, int dh, int causal, float sm_scale,
    void* stream) {
  return launch<bf16>(q, k, v, kv_lens, out, B, nh, S, dh, causal, sm_scale,
                      stream);
}
