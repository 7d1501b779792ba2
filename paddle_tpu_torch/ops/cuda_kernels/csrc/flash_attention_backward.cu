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
// and no [S, S] scratch: both outputs are bit-repeatable. dQ by fp32
// atomics from the key pass would save two products and lose that.
//   * fp32 (register micro-tiles on the CUDA cores, flash_tile.cuh
//     flash_simt, as K10): a thread forms 8 x 4 micro-tiles of the scores
//     and dP (S^T and dP^T in the key pass) and holds 8 x dh / 16 tiles of
//     its outputs in registers; P = exp2(s log2 e scale - lse log2 e) needs
//     no row reduction, di one per row. dS (P^T, then dS^T in one buffer)
//     passes through shared memory to the output products. The query pass
//     streams K and V tiles, the key pass Q and dO tiles with their rows'
//     lse and di, double-buffered by cp.async. dh = 64: 256 threads own
//     128 rows (query pass 204 registers and 180,224 bytes of shared
//     memory, key pass 216 and 181,248); dh = 128: 128 threads own 64 rows
//     (254 and 223,232; 255 and 224,256); one block (8 or 4 warps) an SM,
//     no spill (ptxas -v, sm_90a). What bounds it: latency, as K10's
//     (about half the fp32 peak), plus the key pass's four barriers a tile.
//   * bf16 (warpgroup products, wgmma, and TMA copies; flash_wgmma.cuh, as
//     K10): bound by the tensor cores' 989 TFLOP/s for its seven products.
//     Both passes are blocks of two consumer warpgroups and a producer
//     warpgroup that feeds a ring of three stages by TMA (setmaxnreg: 40
//     registers to the producer, 232 to each consumer thread):
//     - the query pass owns 128 query rows (64 a warpgroup) with Q and dO
//       resident, and streams K and V in tiles of 128 keys at dh = 64, 64
//       at dh = 128; S = Q K^T and dP = dO V^T read every operand from
//       shared memory (K-major), dQ += dS K takes dS from registers and K
//       through the MN-major descriptor;
//     - the key pass owns 128 keys (64 a warpgroup) with K and V resident,
//       and streams 64-query tiles of Q and dO, with their lse and di
//       (stored beside them by the producer's lanes); S^T = K Q^T and
//       dP^T = V dO^T read K and V as A from shared memory, dV += P^T dO
//       and dK += dS^T Q take P^T and dS^T from registers and dO and Q
//       MN-major. At dh = 128 its 64 x 128 dK and dV accumulators are 128
//       registers a thread, so the query tile is 32 rows there (64 spills);
//     - in both, tile j's first products are issued beside tile j - 1's
//       output products, which run while P and dS of tile j are formed
//       (one FFMA and one ex2 a P; masks only on the tiles at the causal
//       bound and at S);
//     No spill (ptxas -v, sm_90a). Dynamic shared memory: query pass dh =
//     64 132,096 bytes, dh = 128 164,864; key pass 86,016 and 118,784; one
//     block (384 threads) an SM.
#include <cuda_runtime.h>
#include <math.h>

#include "attention_f32.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace flash_simt;
using namespace flash_wg;

// The fp32 kernels (register micro-tiles, attention_f32.cuh, K4's pair
// too): a block of 16 RG threads owns 8 RG rows. By query tile: di from the
// rows' O and dO, then dQ += dS K over 64-key tiles of K and V,
// double-buffered by cp.async. Dynamic shared memory: Q, dO, two stages of
// (K, V), dS.
template <int D, int RG>
__global__ void __launch_bounds__(16 * RG)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ di_out,
                        int nh, int S, int causal, float sm_scale) {
  attn_bwd_dq<D, RG, false>(q, k, v, o, lse, dout, dq, nullptr, di_out, nh, S,
                            D, S, causal, sm_scale);
}

// By key tile: dV += P^T dO and dK += dS^T Q over 64-query tiles of Q and
// dO, with their rows' lse and di, double-buffered by cp.async (only the
// tiles at or after the key tile under the causal mask). Dynamic shared
// memory: K, V, two stages of (Q, dO, lse, di), and one buffer that holds
// P^T, then dS^T.
template <int D, int RG>
__global__ void __launch_bounds__(16 * RG)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         const float* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int nh, int S, int causal, float sm_scale) {
  attn_bwd_dkv<D, RG, false>(q, k, v, lse, di, dout, dk, dv, nh, S, D, S,
                             causal, sm_scale);
}

// dS of one tile in the query pass, in place of the scores s: P = 2^(s
// scale2 - lse2) (lse2 = lse log2 e of the row), dS = (dP - di) P scale.
// MASK: the tile crosses the causal bound, key_end or S (rows past S), so
// P = 0 at a dead (row, key).
template <int KN, bool MASK>
__device__ __forceinline__ void ds_tile(float (&s)[KN / 2],
                                        const float (&dp)[KN / 2],
                                        const float (&lse2)[2],
                                        const float (&di)[2],
                                        const int (&rows)[2], int k0,
                                        int key_end, int S, int causal,
                                        float scale2, float sm_scale, int t) {
#pragma unroll
  for (int i = 0; i < KN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = ex2(fmaf(s[4 * i + e], scale2, -lse2[r]));
      if (MASK) {
        const int col = k0 + 8 * i + 2 * t + (e & 1);
        if (rows[r] >= S || col >= key_end || (causal && col > rows[r]))
          p = 0.f;
      }
      s[4 * i + e] = (dp[4 * i + e] - di[r]) * p * sm_scale;
    }
  }
}

// P^T and dS^T of one tile in the key pass, in place of S^T and dP^T (keys
// x queries q0..q0 + QM; lse2_t, di_t the queries' lse log2 e and di).
// MASK: the tile crosses S (keys or queries) or the causal bound.
template <int QM, bool MASK>
__device__ __forceinline__ void pds_tile(float (&sT)[QM / 2],
                                         float (&dpT)[QM / 2],
                                         const float* lse2_t,
                                         const float* di_t,
                                         const int (&keys)[2], int q0, int S,
                                         int causal, float scale2,
                                         float sm_scale, int t) {
#pragma unroll
  for (int i = 0; i < QM / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + 2 * t + (e & 1);
      float p = ex2(fmaf(sT[4 * i + e], scale2, -lse2_t[col]));
      if (MASK) {
        const int key = keys[e >> 1], qi = q0 + col;
        if (qi >= S || key >= S || (causal && key > qi)) p = 0.f;
      }
      sT[4 * i + e] = p;
      dpT[4 * i + e] = (dpT[4 * i + e] - di_t[col]) * p * sm_scale;
    }
  }
}

// The bf16 kernels on wgmma; a block is two consumer warpgroups and a
// producer warpgroup that feeds a ring of ST stages by TMA (flash_wgmma.cuh).
// Query pass: a block owns 128 query rows, warpgroup wg the rows [64 wg,
// 64 wg + 64); Q and dO land once, K and V stream in KN-key tiles. di =
// rowsum(O . dO) of the thread's two rows comes from device memory (a
// quarter row a thread, four threads a row). S = Q K^T and dP = dO V^T read
// their operands from shared memory (K-major); dQ += dS K takes dS from
// registers (rounded to bf16, :1258) and K MN-major. The products of tile
// j are issued beside tile j - 1's dQ product, which runs while dS_j is
// formed.
template <int D, int KN, int ST>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap dmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse, bf16* __restrict__ dq,
                       float* __restrict__ di_out, int nh, int S, int causal,
                       float sm_scale) {
  constexpr int JT = KN / 8, NT = D / 8, TILE = KN * D;
  constexpr uint32_t kKvBytes = 2u * TILE * 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* do_s = q_s + 128 * D;
  bf16* kv_s = do_s + 128 * D;         // stage s: K at 2 s TILE, V after it
  __shared__ uint64_t bars[1 + 2 * ST];         // Q and dO; full; empty
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, wid = warp_id(), wg = wid >> 2,
            warp = wid & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * nh + h;
  const int q0 = blockIdx.x * 128, w0 = q0 + 64 * wg;
  const int key_end = causal ? min(S, q0 + 128) : S;
  const int ntiles = (key_end + KN - 1) / KN;
  const size_t head = (size_t)bh * S * D;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wid >= kConsumers / 32) {        // the producer warpgroup
    producer_regs();
    if (tid == kConsumers) {
      mbar_expect(&bars[0], 2 * 128 * D * 2);
      tma_tile<D, 128>(q_s, &qmap, &bars[0], q0, bh);
      tma_tile<D, 128>(do_s, &dmap, &bars[0], q0, bh);
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
    consumer_regs();
    const int rows[2] = {w0 + 16 * warp + g, w0 + 16 * warp + g + 8};
    // di of this thread's rows: columns [t D / 4, (t + 1) D / 4) of O . dO
    float di[2], lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
      if (rows[r] < S) {
        const size_t at = head + (size_t)rows[r] * D + t * (D / 4);
#pragma unroll
        for (int c = 0; c < D / 4; c += 8) {
          float ov[8], dv[8];
          load_vec<bf16, 8>(o + at + c, ov);
          load_vec<bf16, 8>(dout + at + c, dv);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += ov[e] * dv[e];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      di[r] = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
      lse2[r] = rows[r] < S ? lse[(size_t)bh * S + rows[r]] * kLog2e : 0.f;
    }
    // the tiles this warpgroup multiplies: those with a key <= its last row
    const int mine = causal ? min(ntiles, (w0 + 63) / KN + 1) : ntiles;
    const float scale2 = sm_scale * kLog2e;
    float acc[D / 2], s[KN / 2], dp[KN / 2];
    uint32_t dsa[KN / 16][4];            // dS of the last tile as A operands
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(&bars[0], 0);
    __syncwarp();

    for (int j = 0; j < mine; ++j) {
      const int st = j % ST, k0 = j * KN;
      const bf16* k_t = kv_s + st * 2 * TILE;
      mbar_wait(&full[st], (j / ST) & 1);
      __syncwarp();
      reg_fence(acc);
      reg_fence(s);
      reg_fence(dp);
      reg_fence(dsa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0>(s, desc_k<128>(q_s, 64 * wg, kk), desc_k<KN>(k_t, 0, kk),
                    kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0>(dp, desc_k<128>(do_s, 64 * wg, kk),
                    desc_k<KN>(k_t + TILE, 0, kk), kk > 0);
      wg_commit();
      if (j > 0) {                       // dQ += dS_{j-1} K_{j-1}, in flight
        const bf16* k_p = kv_s + ((j - 1) % ST) * 2 * TILE;
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk)
          wgmma_rs<1>(acc, dsa[kk], desc_mn<KN>(k_p, kk));
        wg_commit();
        wg_wait<1>();                    // S_j and dP_j have landed
      } else {
        wg_wait<0>();
      }
      reg_fence(s);
      reg_fence(dp);
      if (k0 + KN <= key_end && w0 + 64 <= S && (!causal || k0 + KN - 1 <= w0))
        ds_tile<KN, false>(s, dp, lse2, di, rows, k0, key_end, S, causal,
                           scale2, sm_scale, t);
      else
        ds_tile<KN, true>(s, dp, lse2, di, rows, k0, key_end, S, causal,
                          scale2, sm_scale, t);
      wg_wait<0>();
      reg_fence(acc);
      if (j > 0 && (tid & 127) == 0) mbar_arrive(&empty[(j - 1) % ST]);
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) pack_a(dsa[kk], s, kk);
    }
    {                                    // dQ += dS K of the last tile
      const int st = (mine - 1) % ST;
      reg_fence(acc);
      reg_fence(dsa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        wgmma_rs<1>(acc, dsa[kk], desc_mn<KN>(kv_s + st * 2 * TILE, kk));
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);
    }
    for (int j = mine; j < ntiles; ++j) {   // past the last row: released
      mbar_wait(&full[j % ST], (j / ST) & 1);
      if ((tid & 127) == 0) mbar_arrive(&empty[j % ST]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rows[r];
      if (row >= S) continue;
      bf16* out = dq + head + (size_t)row * D + 2 * t;
#pragma unroll
      for (int i = 0; i < NT; ++i)
        *reinterpret_cast<uint32_t*>(out + 8 * i) =
            pack2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
      if (t == 0) di_out[(size_t)bh * S + row] = di[r];
    }
  }
}

// Key pass: a block owns 128 keys, warpgroup wg the keys [64 wg, 64 wg + 64); K
// and V land once and stay; QM-row tiles of Q and dO stream in by TMA, their
// rows' lse and di beside them, stored by the lanes of the first producer warp
// (a 1-D copy would need 16-byte-aligned rows, S % 4 == 0). Under the causal
// mask only the tiles from the block's first key on are loaded, and a warpgroup
// multiplies those from its own first key on. S^T = K Q^T and dP^T = V dO^T
// read K and V as A and Q and dO as B from shared memory (K-major); dV += P^T
// dO and dK += dS^T Q take P^T and dS^T from registers (rounded to bf16, :900
// and :918) and dO and Q MN-major, in flight while the next tile's P^T and dS^T
// are formed. A query past S gets P = 0, and so dS = 0.
template <int D, int QM, int ST>
struct DkvLayout {
  static constexpr int kTile = QM * D;                       // elements
  // a stage: Q, dO, lse, di, rounded up to the 1024-byte atom alignment
  static constexpr int kStage =
      (2 * kTile * 2 + 2 * QM * 4 + 1023) / 1024 * 1024;
  static constexpr int kSmem = 1024 + 2 * 128 * D * 2 + ST * kStage;
};

template <int D, int QM, int ST>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int nh, int S, int causal,
                        float sm_scale) {
  using L = DkvLayout<D, QM, ST>;
  constexpr int JT = QM / 8, NT = D / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(base);
  bf16* v_s = k_s + 128 * D;
  unsigned char* stages = base + 2 * 128 * D * 2;
  __shared__ uint64_t bars[1 + 2 * ST];         // K and V; full; empty
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, wid = warp_id(), wg = wid >> 2,
            warp = wid & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * nh + h;
  const int k0 = blockIdx.x * 128, w0 = k0 + 64 * wg;
  // queries that may see a key of this block: from its first key on, if causal
  const int qfirst = causal ? k0 : 0;
  const int ntiles = (S - qfirst + QM - 1) / QM;
  const size_t head = (size_t)bh * S * D;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 33);         // the copies' arrival, and 32 lanes
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wid >= kConsumers / 32) {        // the producer warpgroup
    producer_regs();
    const int lane = tid & 31;
    if (tid == kConsumers) {
      mbar_expect(&bars[0], 2 * 128 * D * 2);
      tma_tile<D, 128>(k_s, &kmap, &bars[0], k0, bh);
      tma_tile<D, 128>(v_s, &vmap, &bars[0], k0, bh);
    }
    for (int j = 0; j < ntiles && wid == kConsumers / 32; ++j) {
      const int st = j % ST, q0 = qfirst + j * QM;
      if (j >= ST) mbar_wait(&empty[st], (j / ST - 1) & 1);
      bf16* q_t = reinterpret_cast<bf16*>(stages + st * L::kStage);
      if (lane == 0) {
        mbar_expect(&full[st], 2u * L::kTile * 2);
        tma_tile<D, QM>(q_t, &qmap, &full[st], q0, bh);
        tma_tile<D, QM>(q_t + L::kTile, &dmap, &full[st], q0, bh);
      }
      float* f = reinterpret_cast<float*>(q_t + 2 * L::kTile);
      for (int i = lane; i < QM; i += 32) {
        const bool live = q0 + i < S;
        f[i] = live ? lse[(size_t)bh * S + q0 + i] * kLog2e : 0.f;
        f[QM + i] = live ? di[(size_t)bh * S + q0 + i] : 0.f;
      }
      mbar_arrive(&full[st]);
    }
  } else {                             // the consumer warpgroups
    consumer_regs();
    const int keys[2] = {w0 + 16 * warp + g, w0 + 16 * warp + g + 8};
    // under the causal mask a warpgroup starts at the tile of its first key
    const int first = causal ? min(ntiles, 64 * wg / QM) : 0;
    const float scale2 = sm_scale * kLog2e;
    // dK, dV; S^T, dP^T (keys x queries)
    float dka[D / 2], dva[D / 2], sT[QM / 2], dpT[QM / 2];
    uint32_t pa[QM / 16][4], dsa[QM / 16][4];   // P^T, dS^T of the last tile
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    for (int j = 0; j < first; ++j) {    // before this warpgroup's keys
      mbar_wait(&full[j % ST], (j / ST) & 1);
      if ((tid & 127) == 0) mbar_arrive(&empty[j % ST]);
    }
    mbar_wait(&bars[0], 0);
    __syncwarp();

    for (int j = first; j < ntiles; ++j) {
      const int st = j % ST, q0 = qfirst + j * QM;
      const bf16* q_t = reinterpret_cast<const bf16*>(stages + st * L::kStage);
      const bf16* do_t = q_t + L::kTile;
      const float* lse_t = reinterpret_cast<const float*>(do_t + L::kTile);
      const float* di_t = lse_t + QM;
      mbar_wait(&full[st], (j / ST) & 1);
      __syncwarp();
      reg_fence(dka);
      reg_fence(dva);
      reg_fence(sT);
      reg_fence(dpT);
      reg_fence(pa);
      reg_fence(dsa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0>(sT, desc_k<128>(k_s, 64 * wg, kk),
                    desc_k<QM>(q_t, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0>(dpT, desc_k<128>(v_s, 64 * wg, kk),
                    desc_k<QM>(do_t, 0, kk), kk > 0);
      wg_commit();
      if (j > first) {                   // the last tile's dV, dK in flight
        const bf16* q_p =
            reinterpret_cast<const bf16*>(stages + ((j - 1) % ST) * L::kStage);
#pragma unroll
        for (int kk = 0; kk < QM / 16; ++kk) {
          wgmma_rs<1>(dva, pa[kk], desc_mn<QM>(q_p + L::kTile, kk));
          wgmma_rs<1>(dka, dsa[kk], desc_mn<QM>(q_p, kk));
        }
        wg_commit();
        wg_wait<1>();                    // S^T_j and dP^T_j have landed
      } else {
        wg_wait<0>();
      }
      reg_fence(sT);
      reg_fence(dpT);
      if (q0 + QM <= S && w0 + 64 <= S && (!causal || w0 + 63 <= q0))
        pds_tile<QM, false>(sT, dpT, lse_t, di_t, keys, q0, S, causal,
                            scale2, sm_scale, t);
      else
        pds_tile<QM, true>(sT, dpT, lse_t, di_t, keys, q0, S, causal, scale2,
                           sm_scale, t);
      wg_wait<0>();
      reg_fence(dka);
      reg_fence(dva);
      if (j > first && (tid & 127) == 0) mbar_arrive(&empty[(j - 1) % ST]);
#pragma unroll
      for (int kk = 0; kk < QM / 16; ++kk) {
        pack_a(pa[kk], sT, kk);
        pack_a(dsa[kk], dpT, kk);
      }
    }
    if (first < ntiles) {                // dV, dK of the last tile
      const int st = (ntiles - 1) % ST;
      const bf16* q_p = reinterpret_cast<const bf16*>(stages + st * L::kStage);
      reg_fence(dka);
      reg_fence(dva);
      reg_fence(pa);
      reg_fence(dsa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QM / 16; ++kk) {
        wgmma_rs<1>(dva, pa[kk], desc_mn<QM>(q_p + L::kTile, kk));
        wgmma_rs<1>(dka, dsa[kk], desc_mn<QM>(q_p, kk));
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(dka);
      reg_fence(dva);
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = keys[r];
      if (key >= S) continue;
      const size_t at = head + (size_t)key * D + 2 * t;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * i) =
            pack2(dka[4 * i + 2 * r], dka[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * i) =
            pack2(dva[4 * i + 2 * r], dva[4 * i + 2 * r + 1]);
      }
    }
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, const float* o,
               const float* lse, const float* dout, float* dq, float* dk,
               float* dv, float* di, int B, int nh, int S, int causal,
               float sm_scale, cudaStream_t st) {
  constexpr int RG = D == 64 ? 16 : 8, R = kTM * RG;
  constexpr int kSmemDq = bwd_dq_smem<D, RG>(), kSmemDkv = bwd_dkv_smem<D, RG>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D, RG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D, RG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemDkv);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + R - 1) / R, nh, B);
  flash_bwd_dq_f32_kernel<D, RG><<<grid, 16 * RG, kSmemDq, st>>>(
      q, k, v, o, lse, dout, dq, di, nh, S, causal, sm_scale);
  flash_bwd_dkv_f32_kernel<D, RG><<<grid, 16 * RG, kSmemDkv, st>>>(
      q, k, v, lse, di, dout, dk, dv, nh, S, causal, sm_scale);
  return 0;
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                const float* lse, const bf16* dout, bf16* dq, bf16* dk,
                bf16* dv, float* di, int B, int nh, int S, int causal,
                float sm_scale, cudaStream_t st) {
  // the query pass's key tile and the key pass's query tile: at dh = 128
  // the larger accumulators (dQ; dK and dV) leave registers for less
  constexpr int KN = D == 64 ? 128 : 64, QM = D == 64 ? 64 : 32, ST = 3;
  constexpr int kSmemDq = 1024 + (2 * 128 * D + 2 * ST * KN * D) * 2;
  constexpr int kSmemDkv = DkvLayout<D, QM, ST>::kSmem;
  const int BH = B * nh;
  CUtensorMap q128, d128, kkn, vkn, k128, v128, qqm, dqm;
  int rc = map_heads(&q128, q, BH, S, D, 128);
  if (!rc) rc = map_heads(&d128, dout, BH, S, D, 128);
  if (!rc) rc = map_heads(&kkn, k, BH, S, D, KN);
  if (!rc) rc = map_heads(&vkn, v, BH, S, D, KN);
  if (!rc) rc = map_heads(&k128, k, BH, S, D, 128);
  if (!rc) rc = map_heads(&v128, v, BH, S, D, 128);
  if (!rc) rc = map_heads(&qqm, q, BH, S, D, QM);
  if (!rc) rc = map_heads(&dqm, dout, BH, S, D, QM);
  if (!rc)
    rc = (int)cudaFuncSetAttribute(flash_bwd_dq_wg_kernel<D, KN, ST>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmemDq);
  if (!rc)
    rc = (int)cudaFuncSetAttribute(flash_bwd_dkv_wg_kernel<D, QM, ST>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmemDkv);
  if (rc) return rc;
  dim3 grid((S + 127) / 128, nh, B);
  flash_bwd_dq_wg_kernel<D, KN, ST><<<grid, kBlockThreads, kSmemDq, st>>>(
      q128, d128, kkn, vkn, o, dout, lse, dq, di, nh, S, causal, sm_scale);
  flash_bwd_dkv_wg_kernel<D, QM, ST><<<grid, kBlockThreads, kSmemDkv, st>>>(
      k128, v128, qqm, dqm, lse, di, dk, dv, nh, S, causal, sm_scale);
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
  int rc;
  if (dh == 64)
    rc = launch_f32<64>(q, k, v, o, lse, dout, dq, dk, dv, di, B, nh, S,
                        causal, sm_scale, st);
  else if (dh == 128)
    rc = launch_f32<128>(q, k, v, o, lse, dout, dq, dk, dv, di, B, nh, S,
                         causal, sm_scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return rc ? rc : (int)cudaGetLastError();
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
