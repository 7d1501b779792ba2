// K12: the attention stage probe, bf16, for sm_90a.
//
// Replaces the TPU kernels of tools/_attn_probe.py: `make` (:29, its
// pallas_call :30) over the bodies k_copy :106, k_qk :41, k_qk_max :49,
// k_softmax :57, k_full :67, k_full_bf16sm :94 and k_full_perhead :80.
// Each writes, for q, k, v [B, nh, S, dh] bf16 and s = Q K^T * sm (fp32
// products of the bf16 operands, non-causal), an [B, nh, S, dh] bf16 output:
//   copy          q + v
//   qk            s[:, :dh], the first dh key columns
//   qk_max        (s - rowmax s)[:, :dh]
//   softmax       (p / l)[:, :dh], p = exp(s - rowmax s), l = rowsum p
//   full          (bf16(p) V) / l
//   full_bf16sm   (p' V) / l', p' = bf16(exp(bf16(s - rowmax s))), l' =
//                 rowsum p' in fp32
//   full_perhead  full, mapped one head a block where the others map the
//                 tool's 12 heads (gh) a block.
// The tool times these stages one against another on the TPU; the port
// keeps its block mapping (a block owns every row of a group of heads of
// one batch item) so that the same table can be read on this card.
// qk computes only the dh key columns it writes; the TPU body formed all S
// on its matrix unit and sliced.
//
// What bounds it on this card: at the tool's shape the bytes for copy and
// qk, the operations for the others (2 S^2 dh per head for each product,
// here fp32 on the CUDA cores: no tensor-core path).
//
// What the design does about it: four threads a query row, 128 rows a pass
// (512 threads), each thread holding a quarter of q and of the fp32
// accumulator (flash_tile.cuh); key and value tiles of 32 rows stream
// through padded fp32 shared memory. The row max is a first pass over the
// keys and the exponentials a second, so every variant takes its max over
// the whole row before any exp, as the TPU body does (no online rescaling
// to round differently); softmax writes in a third pass, once l is known.
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tile.cuh"

namespace {

using namespace flash;

constexpr int kProbeThreads = 512;
constexpr int kProbeRows = kProbeThreads / 4;   // query rows a pass

enum Variant { kCopy = 0, kQk, kQkMax, kSoftmax, kFull, kFullBf16Sm };

template <int V, int ND>
__global__ void __launch_bounds__(kProbeThreads)
attn_probe_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int nh,
                  int S, int heads_per_block, float sm) {
  constexpr int dh = 4 * ND;
  const int b = blockIdx.y;
  const int t4 = threadIdx.x & 3;

  __shared__ __align__(16) float k_s[Tile<ND>::kFloats];
  __shared__ __align__(16) float v_s[Tile<ND>::kFloats];

  for (int g = 0; g < heads_per_block; ++g) {
    const size_t head =
        ((size_t)b * nh + blockIdx.x * heads_per_block + g) * S * dh;
    const bf16* qh = q + head;
    const bf16* kh = k + head;
    const bf16* vh = v + head;
    for (int r0 = 0; r0 < S; r0 += kProbeRows) {
      const int qi = r0 + (threadIdx.x >> 2);
      const bool live = qi < S;
      float qr[ND], acc[ND];
      load_quarter<bf16, ND>(qr, qh, qi, live);
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = 0.f;

      if (V == kCopy) {
        load_quarter<bf16, ND>(acc, vh, qi, live);
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] += qr[i];
        if (live) store_quarter<bf16, ND>(out + head, qi, acc, 1.f);
        continue;
      }

      // pass A: the row max of s over every key (the variants that need it)
      float m = 0.f;
      if (V != kQk) {
        m = -INFINITY;
        for (int k0 = 0; k0 < S; k0 += kTile) {
          const int nk = min(kTile, S - k0);
          __syncthreads();
          stage<bf16, ND, kProbeThreads>(k_s, kh, k0, nk);
          __syncthreads();
          for (int j = 0; j < nk; ++j)
            m = fmaxf(m, quad_sum(dot<ND>(qr, quarter<ND>(k_s, j))) * sm);
        }
      }

      // pass B: exponentials, their sum and the PV product (qk and qk_max:
      // the first dh columns of s or s - m, written from this pass)
      const int b_end = (V == kQk || V == kQkMax) ? min(S, dh) : S;
      float l = 0.f;
      for (int k0 = 0; k0 < b_end; k0 += kTile) {
        const int nk = min(kTile, b_end - k0);
        __syncthreads();
        stage<bf16, ND, kProbeThreads>(k_s, kh, k0, nk);
        if (V == kFull || V == kFullBf16Sm)
          stage<bf16, ND, kProbeThreads>(v_s, vh, k0, nk);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          if (j >= nk) break;
          const float s = quad_sum(dot<ND>(qr, quarter<ND>(k_s, j))) * sm;
          if (V == kQk || V == kQkMax) {
            // key column c = k0 + j is held by thread c / ND at c % ND
            // (kTile is a multiple of ND, so c % ND == j % ND)
            if (t4 == (k0 + j) / ND) acc[j % ND] = V == kQk ? s : s - m;
          } else if (V == kFullBf16Sm) {
            const float p = round_to<bf16>(expf(round_to<bf16>(s - m)));
            l += p;
            axpy<ND>(acc, p, quarter<ND>(v_s, j));
          } else {
            const float p = expf(s - m);
            l += p;
            if (V == kFull)
              axpy<ND>(acc, round_to<bf16>(p), quarter<ND>(v_s, j));
          }
        }
      }

      // pass C (softmax): the first dh columns of p / l
      if (V == kSoftmax) {
        for (int k0 = 0; k0 < min(S, dh); k0 += kTile) {
          const int nk = min(kTile, min(S, dh) - k0);
          __syncthreads();
          stage<bf16, ND, kProbeThreads>(k_s, kh, k0, nk);
          __syncthreads();
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            if (j >= nk) break;
            const float s = quad_sum(dot<ND>(qr, quarter<ND>(k_s, j))) * sm;
            if (t4 == (k0 + j) / ND) acc[j % ND] = expf(s - m) / l;
          }
        }
      }

      if (live) {
        if (V == kFull || V == kFullBf16Sm) {
#pragma unroll
          for (int i = 0; i < ND; ++i) acc[i] = acc[i] / l;
        }
        store_quarter<bf16, ND>(out + head, qi, acc, 1.f);
      }
    }
  }
}

template <int V>
int launch_v(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
             int nh, int S, int heads_per_block, float sm,
             cudaStream_t st) {
  dim3 grid(nh / heads_per_block, B);
  attn_probe_kernel<V, 16><<<grid, kProbeThreads, 0, st>>>(
      q, k, v, out, nh, S, heads_per_block, sm);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, nh, S, 64] bf16; variant: 0 copy, 1 qk, 2 qk_max,
// 3 softmax, 4 full, 5 full_bf16sm; heads_per_block divides nh.
extern "C" int attn_probe_bf16(const bf16* q, const bf16* k, const bf16* v,
                               bf16* out, int B, int nh, int S, int dh,
                               int variant, int heads_per_block, float sm,
                               void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  if (dh != 64 || heads_per_block < 1 || nh % heads_per_block)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PROBE_LAUNCH(V) \
  launch_v<V>(q, k, v, out, B, nh, S, heads_per_block, sm, st)
  switch (variant) {
    case kCopy: return PROBE_LAUNCH(kCopy);
    case kQk: return PROBE_LAUNCH(kQk);
    case kQkMax: return PROBE_LAUNCH(kQkMax);
    case kSoftmax: return PROBE_LAUNCH(kSoftmax);
    case kFull: return PROBE_LAUNCH(kFull);
    case kFullBf16Sm: return PROBE_LAUNCH(kFullBf16Sm);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PROBE_LAUNCH
}
