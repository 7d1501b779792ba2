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
//   * bf16 (warpgroup products, wgmma, and TMA copies; flash_wgmma.cuh):
//     bound by the tensor cores' 989 TFLOP/s, which only wgmma reaches, and
//     only while its operands keep arriving and the softmax between the two
//     products does not leave it idle. So:
//     - a block owns 64 NWG query rows of one (b, h), NWG consumer
//       warpgroups of 64 rows (three at dh = 64, two at dh = 128, for
//       registers), and a producer warpgroup whose first thread issues the
//       TMA copies: Q once, then 128-key tiles of K and V into a ring of
//       three stages, each with a "full" and an "empty" mbarrier. Each K/V
//       tile serves all 64 NWG rows, so L2 sends K and V once per 192 (128)
//       rows. setmaxnreg moves registers from the producer (24, 40) to the
//       consumers (160, 232);
//     - S = Q K^T is wgmma m64n128k16 with Q and K read from shared memory
//       through K-major descriptors (128-byte swizzle, as TMA wrote them);
//       O += P V is m64nDk16 with P from registers, the S accumulator
//       rounded to bf16 in place (the FA3 arrangement), and V read through
//       the MN-major descriptor: no transposed copy;
//     - within a warpgroup, S_j = Q K_j^T and O += P_{j-1} V_{j-1} are
//       issued together; the softmax of tile j (one FFMA and one ex2 a
//       score) runs while the second product is in flight, and O is
//       rescaled once it has landed. The warpgroups run apart, so one's
//       softmax overlaps another's products;
//     - rows and keys past S are zero-filled by the copy engine (a 3-D map
//       over [B nh, S, dh], so the edge is per head); only the tile at the
//       causal bound and the tile at S are masked, and a warpgroup skips
//       the key tiles past its last row.
//     No spill (ptxas -v, sm_90a; chip_smoke prints the registers at
//     launch, before setmaxnreg). Dynamic shared memory: dh = 64, 123,904
//     bytes, dh = 128, 230,400 (the 1,024 bytes of alignment slack
//     included); one block an SM (512 and 384 threads).
#include <cuda_runtime.h>
#include <math.h>

#include "attention_f32.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace flash_simt;
using namespace flash_wg;

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

// The online softmax of one tile of scores s (the m64nKN accumulator of this
// thread, keys k0..k0 + KN), in base 2: m is the running max of s * scale2
// and moves to the new one, alpha is the factor of the old sums, l = l alpha
// + rowsum(P), and s becomes P = 2^(s scale2 - m) (one FFMA and one ex2 an
// element). MASK: the tile crosses the causal bound or key_end, so keys at
// or past key_end, and past the row if causal, get -inf first.
template <int KN, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[KN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const int (&rows)[2], int k0,
                                             int key_end, int causal,
                                             float scale2, int t) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < KN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int col = k0 + 8 * i + 2 * t + (e & 1);
        if (col >= key_end || (causal && col > rows[e >> 1]))
          s[4 * i + e] = -INFINITY;
      }
      mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * i + e]);
    }
  }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float mn = fmaxf(m[r], mt[r] * scale2);
    // a row with no live key yet keeps its zero sums (no -inf - -inf)
    alpha[r] = mn == -INFINITY ? 1.f : ex2(m[r] - mn);
    neg[r] = mn == -INFINITY ? 0.f : -mn;
    l[r] *= alpha[r];
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < KN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * i + e] = ex2(fmaf(s[4 * i + e], scale2, neg[e >> 1]));
    l[0] += s[4 * i] + s[4 * i + 1];
    l[1] += s[4 * i + 2] + s[4 * i + 3];
  }
}

// The bf16 kernel on wgmma: a block owns BM = 64 NWG query rows of one (b, h),
// its consumer warpgroup wg the rows [64 wg, 64 wg + 64). The producer
// warpgroup lands Q once and streams KN-key tiles of K and V through a ring of
// ST stages by TMA. S = Q K^T reads Q and K from shared memory (K-major); O +=
// P V takes P from registers (the S accumulator rounded to bf16, the TPU
// kernel's cast at :471) and V MN-major. Within a warpgroup the products
// overlap the softmax: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued
// together, the softmax of tile j runs while the second is in flight, and O is
// rescaled after it. A warpgroup multiplies only the tiles that hold a key at
// or before its last row; only the tiles at the causal bound and at S are
// masked.
template <int D, int KN, int ST, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    bf16* __restrict__ out, float* __restrict__ lse, int nh,
                    int S, int causal, float sm_scale) {
  constexpr int NT = D / 8, TILE = KN * D, BM = 64 * NWG;
  constexpr uint32_t kKvBytes = 2u * TILE * 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* kv_s = q_s + BM * D;          // stage s: K at 2 s TILE, V after it
  __shared__ uint64_t bars[1 + 2 * ST];         // Q; full[s]; empty[s]
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, wid = warp_id(), wg = wid >> 2,
            warp = wid & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * nh + h;
  const int q0 = blockIdx.x * BM, w0 = q0 + 64 * wg;
  const int key_end = causal ? min(S, q0 + BM) : S;
  const int ntiles = (key_end + KN - 1) / KN;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wid >= 4 * NWG) {                // the producer warpgroup
    producer_regs<NWG == 2 ? 40 : 24>();
    if (tid == 128 * NWG) {
      mbar_expect(&bars[0], BM * D * 2);
      tma_tile<D, BM>(q_s, &qmap, &bars[0], q0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % ST;
        if (j >= ST) mbar_wait(&empty[st], (j / ST - 1) & 1);
        bf16* k_t = kv_s + st * 2 * TILE;
        mbar_expect(&full[st], kKvBytes);
        tma_tile<D, KN>(k_t, &kmap, &full[st], j * KN, bh);
        tma_tile<D, KN>(k_t + TILE, &vmap, &full[st], j * KN, bh);
      }
    }
  } else {                             // the consumer warpgroups
    consumer_regs<NWG == 2 ? 232 : 160>();
    const int rows[2] = {w0 + 16 * warp + g, w0 + 16 * warp + g + 8};
    // the tiles this warpgroup multiplies: those with a key <= its last row
    const int mine = causal ? min(ntiles, (w0 + 63) / KN + 1) : ntiles;
    const float scale2 = sm_scale * kLog2e;
    float o[D / 2], s[KN / 2];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pa[KN / 16][4];             // P of the last tile as A operands
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    mbar_wait(&bars[0], 0);
    __syncwarp();

    for (int j = 0; j < mine; ++j) {
      const int st = j % ST, k0 = j * KN;
      const bf16* k_t = kv_s + st * 2 * TILE;
      mbar_wait(&full[st], (j / ST) & 1);
      __syncwarp();
      reg_fence(o);
      reg_fence(s);
      reg_fence(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0>(s, desc_k<BM>(q_s, 64 * wg, kk), desc_k<KN>(k_t, 0, kk),
                    kk > 0);
      wg_commit();
      if (j > 0) {                       // O += P_{j-1} V_{j-1}, in flight
        const bf16* v_p = kv_s + ((j - 1) % ST) * 2 * TILE + TILE;
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk)
          wgmma_rs<1>(o, pa[kk], desc_mn<KN>(v_p, kk));
        wg_commit();
      }
      if (j > 0)                         // S_j has landed
        wg_wait<1>();
      else
        wg_wait<0>();
      reg_fence(s);
      if (k0 + KN > key_end || (causal && k0 + KN - 1 > w0))
        softmax_tile<KN, true>(s, m, l, alpha, rows, k0, key_end, causal,
                               scale2, t);
      else
        softmax_tile<KN, false>(s, m, l, alpha, rows, k0, key_end, causal,
                                scale2, t);
      wg_wait<0>();
      reg_fence(o);
      if (j > 0 && (tid & 127) == 0) mbar_arrive(&empty[(j - 1) % ST]);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) pack_a(pa[kk], s, kk);
    }
    {                                    // O += P V of the last tile
      const int st = (mine - 1) % ST;
      const bf16* v_p = kv_s + st * 2 * TILE + TILE;
      reg_fence(o);
      reg_fence(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        wgmma_rs<1>(o, pa[kk], desc_mn<KN>(v_p, kk));
      wg_commit();
      wg_wait<0>();
      reg_fence(o);
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);
    }
    // tiles past this warpgroup's last row: released once they have landed
    for (int j = mine; j < ntiles; ++j) {
      mbar_wait(&full[j % ST], (j / ST) & 1);
      if ((tid & 127) == 0) mbar_arrive(&empty[j % ST]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = rows[r];
      if (row >= S) continue;
      const float inv = 1.f / l[r];
      bf16* orow = out + ((size_t)bh * S + row) * D + 2 * t;
#pragma unroll
      for (int i = 0; i < NT; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      if (t == 0) lse[(size_t)bh * S + row] = (m[r] + log2f(l[r])) * kLn2;
    }
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
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                float* lse, int B, int nh, int S, int causal, float sm_scale,
                cudaStream_t st) {
  // dh = 64: three consumer warpgroups (192 query rows a block, so each K
  // and V tile serves 192 rows); dh = 128: two, for registers
  constexpr int KN = 128, ST = 3, NWG = D == 64 ? 3 : 2, BM = 64 * NWG;
  constexpr int kSmem = 1024 + (BM * D + 2 * ST * KN * D) * 2;
  CUtensorMap qm, km, vm;
  int rc = map_heads(&qm, q, B * nh, S, D, BM);
  if (!rc) rc = map_heads(&km, k, B * nh, S, D, KN);
  if (!rc) rc = map_heads(&vm, v, B * nh, S, D, KN);
  if (!rc)
    rc = (int)cudaFuncSetAttribute(flash_fwd_wg_kernel<D, KN, ST, NWG>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmem);
  if (rc) return rc;
  dim3 grid((S + BM - 1) / BM, nh, B);
  flash_fwd_wg_kernel<D, KN, ST, NWG><<<grid, 128 * (NWG + 1), kSmem, st>>>(
      qm, km, vm, out, lse, nh, S, causal, sm_scale);
  return 0;
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
  int rc;
  if (dh == 64)
    rc = launch_bf16<64>(q, k, v, out, lse, B, nh, S, causal, sm_scale, st);
  else if (dh == 128)
    rc = launch_bf16<128>(q, k, v, out, lse, B, nh, S, causal, sm_scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return rc ? rc : (int)cudaGetLastError();
}
