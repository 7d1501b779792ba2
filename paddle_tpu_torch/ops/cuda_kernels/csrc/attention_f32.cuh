// The bodies of the register-tiled fp32 attention kernels (flash_tile.cuh
// flash_simt), shared by two pairs of sources:
//   * the forward: K10 (flash_attention.cu; dh = D, every key of S live,
//     lse written) and K2 (prefill_attention.cu; dh <= D zero-filled to D,
//     keys past kv_len masked, no lse);
//   * the backward's query pass and key pass: K11
//     (flash_attention_backward.cu; lse from K10, di = rowsum(O . dO)) and
//     K4 (attention_backward.cu, past its head kernel; the query pass first
//     recomputes the online max, sum and delta = rowsum(dP . P) itself and
//     writes lse and delta for the key pass).
// Each source wraps a body in a __global__ kernel of its own name, so a
// trace tells the kernels apart; where a caller passes dh = D the stores'
// column guards fold away.
//
// The masks, in every body: keys at or past key_end (kv_len, and the causal
// bound of the block's last row) are neither loaded nor multiplied, except
// inside the one tile that holds the bound, where they are -inf (or P = 0);
// rows and keys past S, and columns past dh, are zero in shared memory, so
// no NaN enters a product. A row with no live key (kv_len 0) keeps m = -inf
// and l = 0 and is emitted as zeros; a key past kv_len gets zero gradients.
#pragma once
#include <math.h>

#include "flash_tile.cuh"

namespace flash_simt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of the bodies (bytes), for RG row groups.
template <int D, int RG>
constexpr int fwd_smem() {       // Q, two stages of (K, V), P
  return (kTM * RG * kPitch<D> + 4 * kCols * kPitch<D> +
          kTM * RG * kPitchS) * 4;
}
template <int D, int RG>
constexpr int bwd_dq_smem() {    // Q, dO, two stages of (K, V), dS
  return (2 * kTM * RG * kPitch<D> + 4 * kCols * kPitch<D> +
          kTM * RG * kPitchS) * 4;
}
template <int D, int RG>
constexpr int bwd_dkv_smem() {   // K, V, two stages of (Q, dO, lse, di), P^T
  return (2 * kTM * RG * kPitch<D> + 2 * (2 * kCols * kPitch<D> + 2 * kCols) +
          kTM * RG * kPitchS) * 4;
}

// out = softmax(Q K^T * scale) V for the 8 RG query rows of block
// blockIdx.x of head (blockIdx.z, blockIdx.y): K and V stream in 64-key
// tiles, double-buffered by cp.async, under an online softmax in base 2; P
// passes through shared memory to the PV product; O is scaled by 1 / l at
// its store. lse (natural log, [B, nh, S]) is written where not null.
template <int D, int RG>
__device__ __forceinline__ void attn_fwd(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int nh, int S, int dh, int len, int causal,
    float sm_scale) {
  constexpr int kThr = 16 * RG, BM = kTM * RG, P = kPitch<D>, TD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // [BM, P]
  float* kv_s = q_s + BM * P;                    // 2 x (K, V) [kCols, P]
  float* p_s = kv_s + 4 * kCols * P;             // [BM, kPitchS]
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * nh + h;
  const float* kh = k + bh * S * dh;
  const float* vh = v + bh * S * dh;
  // keys any row of the block sees: up to its last row, if causal
  const int key_end = causal ? min(len, q0 + BM) : len;
  const int tiles = (key_end + kCols - 1) / kCols;
  const float scale2 = sm_scale * kLog2e;
  if (tiles == 0) {                              // kv_len 0: zeros
    zero_rows<kThr>(out + bh * S * dh, q0, min(BM, S - q0), dh);
    return;
  }

  stage_rows<D, kThr>(q_s, q + bh * S * dh, q0, min(BM, S - q0), BM, dh);
  stage_rows<D, kThr>(kv_s, kh, 0, min(kCols, key_end), kCols, dh);
  stage_rows<D, kThr>(kv_s + kCols * P, vh, 0, min(kCols, key_end), kCols,
                      dh);
  flash_mma::cp_commit();

  float o[kTM][TD], m[kTM], l[kTM];              // l: this thread's keys
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < TD; ++e) o[i][e] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kCols;
    const float* k_s = kv_s + (t & 1) * 2 * kCols * P;
    const float* v_s = k_s + kCols * P;
    flash_mma::cp_wait<0>();
    __syncthreads();              // tile t landed; tile t - 1 and P are read
    if (t + 1 < tiles) {          // the next tile lands while this one is used
      float* nk_s = kv_s + ((t + 1) & 1) * 2 * kCols * P;
      const int n = min(kCols, key_end - k0 - kCols);
      stage_rows<D, kThr>(nk_s, kh, k0 + kCols, n, kCols, dh);
      stage_rows<D, kThr>(nk_s + kCols * P, vh, k0 + kCols, n, kCols, dh);
      flash_mma::cp_commit();
    }

    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
    fma_abt<D, RG>(s, q_s, k_s, rg, cg);
    // only the tile past key_end and the tile on the diagonal hold masked keys
    const bool edge = k0 + kCols > key_end || (causal && k0 + kCols - 1 > q0);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int key = k0 + cg + 16 * j;
        const bool dead =
            edge && (key >= key_end || (causal && key > q0 + rg + RG * i));
        s[i][j] = dead ? -INFINITY : s[i][j] * scale2;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], group_max(mt));
      // a row with no live key yet keeps its zero sums (no exp of -inf - -inf)
      const float alpha = mn == -INFINITY ? 1.f : exp2f(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < TD; ++e) o[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = mn == -INFINITY ? 0.f : exp2f(s[i][j] - mn);
        l[i] += p;
        p_s[(rg + RG * i) * kPitchS + cg + 16 * j] = p;
      }
    }
    __syncthreads();                             // P is written
    fma_ab<D, RG>(o, p_s, v_s, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float li = group_sum(l[i]);
    const int row = q0 + rg + RG * i;
    if (row < S) {
      // l == 0: a row with no live key, emitted as zeros
      store_dims<D>(out + bh * S * dh, row, o[i], 1.f / fmaxf(li, 1e-30f), cg,
                    dh);
      if (lse != nullptr && cg == 0)
        lse[bh * S + row] = (m[i] + log2f(li)) * kLn2;
    }
  }
}

// The query pass of the backward: dQ = dS K * scale for the 8 RG query
// rows of block blockIdx.x, over double-buffered 64-key tiles of K and V,
// dS = (dP - di) P, P = exp2(s - lse2) (base 2), a row past S or with no
// live key having lse2 = +inf, so P = 0. kRecompute = false (K11): lse is
// given and di = rowsum(O . dO) from the rows' O, written to di_out.
// kRecompute = true (K4): a first visit of the key tiles keeps the online
// max m, sum l and d = sum_j e^(s_j - m) dP_j, so lse = m + log l and delta
// = d / l come out of one visit (delta from the unrounded recomputed P);
// they are written to lse_out (natural log, +inf for a row with no live
// key) and di_out for the key pass.
template <int D, int RG, bool kRecompute>
__device__ __forceinline__ void attn_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ lse_out,
    float* __restrict__ di_out, int nh, int S, int dh, int len, int causal,
    float sm_scale) {
  constexpr int kThr = 16 * RG, BM = kTM * RG, P = kPitch<D>, TD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // [BM, P]
  float* do_s = q_s + BM * P;                    // [BM, P]
  float* kv_s = do_s + BM * P;                   // 2 x (K, V) [kCols, P]
  float* ds_s = kv_s + 4 * kCols * P;            // [BM, kPitchS]
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * nh + h;
  const size_t head = bh * S * dh;
  const int key_end = causal ? min(len, q0 + BM) : len;
  const int tiles = (key_end + kCols - 1) / kCols;
  const float scale2 = sm_scale * kLog2e;
  const int nq = min(BM, S - q0);
  if (kRecompute && tiles == 0) {                // kv_len 0: dQ = 0
    zero_rows<kThr>(dq + head, q0, nq, dh);
    return;
  }

  stage_rows<D, kThr>(q_s, q + head, q0, nq, BM, dh);
  stage_rows<D, kThr>(do_s, dout + head, q0, nq, BM, dh);
  auto stage_kv = [&](float* st, int k0) {
    const int n = min(kCols, key_end - k0);
    stage_rows<D, kThr>(st, k + head, k0, n, kCols, dh);
    stage_rows<D, kThr>(st + kCols * P, v + head, k0, n, kCols, dh);
  };
  stage_kv(kv_s, 0);
  flash_mma::cp_commit();
  // only the tile past key_end and the tile on the diagonal hold masked keys
  auto edge = [&](int k0) {
    return k0 + kCols > key_end || (causal && k0 + kCols - 1 > q0);
  };
  auto dead = [&](bool edge_tile, int k0, int i, int j) {
    const int key = k0 + cg + 16 * j;
    return edge_tile &&
           (key >= key_end || (causal && key > q0 + rg + RG * i));
  };

  float di[kTM], lse2[kTM], acc[kTM][TD];
  if constexpr (!kRecompute) {
    // di = rowsum(O . dO) while the tiles land; a row past S: lse = +inf
    // makes its P, and dS, zero
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = q0 + rg + RG * i;
      float part = 0.f;
      if (row < S) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          const size_t at = head + (size_t)row * D + 64 * c + 4 * cg;
          const float4 ov = ld4(o + at), dv = ld4(dout + at);
          part += ov.x * dv.x + ov.y * dv.y + ov.z * dv.z + ov.w * dv.w;
        }
      }
      di[i] = group_sum(part);
      lse2[i] = row < S ? lse[bh * S + row] * kLog2e : INFINITY;
    }
  } else {
    // the online m, l and d (l, d: this thread's keys)
    float m[kTM], l[kTM], d[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      m[i] = -INFINITY;
      l[i] = d[i] = 0.f;
    }
    for (int t = 0; t < tiles; ++t) {
      const int k0 = t * kCols;
      const float* k_s = kv_s + (t & 1) * 2 * kCols * P;
      flash_mma::cp_wait<0>();
      __syncthreads();            // tile t landed; tile t - 1 is read
      if (t + 1 < tiles) {
        stage_kv(kv_s + ((t + 1) & 1) * 2 * kCols * P, k0 + kCols);
        flash_mma::cp_commit();
      }
      float s[kTM][kTN], dp[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) s[i][j] = dp[i][j] = 0.f;
      fma_abt<D, RG>(s, q_s, k_s, rg, cg);
      fma_abt<D, RG>(dp, do_s, k_s + kCols * P, rg, cg);
      const bool e_t = edge(k0);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          s[i][j] = dead(e_t, k0, i, j) ? -INFINITY : s[i][j] * scale2;
          mt = fmaxf(mt, s[i][j]);
        }
        const float mn = fmaxf(m[i], group_max(mt));
        // a row with no live key yet keeps its zero sums
        const float alpha = mn == -INFINITY ? 1.f : exp2f(m[i] - mn);
        m[i] = mn;
        l[i] *= alpha;
        d[i] *= alpha;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const float e = mn == -INFINITY ? 0.f : exp2f(s[i][j] - mn);
          l[i] += e;
          d[i] = fmaf(e, dp[i][j], d[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float li = group_sum(l[i]), d_i = group_sum(d[i]);
      const bool seen = li > 0.f;
      lse2[i] = seen ? m[i] + log2f(li) : INFINITY;
      di[i] = seen ? d_i / li : 0.f;
    }
    __syncthreads();                             // the last tile is read
    stage_kv(kv_s, 0);
    flash_mma::cp_commit();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int e = 0; e < TD; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kCols;
    const float* k_s = kv_s + (t & 1) * 2 * kCols * P;
    const float* v_s = k_s + kCols * P;
    flash_mma::cp_wait<0>();
    __syncthreads();              // tile t landed; tile t - 1 and dS are read
    if (t + 1 < tiles) {          // the next tile lands while this one is used
      stage_kv(kv_s + ((t + 1) & 1) * 2 * kCols * P, k0 + kCols);
      flash_mma::cp_commit();
    }
    float s[kTM][kTN], dp[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = dp[i][j] = 0.f;
    fma_abt<D, RG>(s, q_s, k_s, rg, cg);
    fma_abt<D, RG>(dp, do_s, v_s, rg, cg);
    const bool e_t = edge(k0);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p =
            dead(e_t, k0, i, j) ? 0.f : exp2f(s[i][j] * scale2 - lse2[i]);
        // the scale at the store
        ds_s[(rg + RG * i) * kPitchS + cg + 16 * j] = (dp[i][j] - di[i]) * p;
      }
    }
    __syncthreads();                             // dS is written
    fma_ab<D, RG>(acc, ds_s, k_s, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + rg + RG * i;
    if (row < S) {
      store_dims<D>(dq + head, row, acc[i], sm_scale, cg, dh);
      if (cg == 0) {
        di_out[bh * S + row] = di[i];
        if (kRecompute) lse_out[bh * S + row] = lse2[i] * kLn2;
      }
    }
  }
}

// The key pass of the backward: dV = P^T dO and dK = dS^T Q * scale for
// the 8 RG keys of block blockIdx.x, over 64-query tiles of Q and dO with
// their rows' lse (natural log) and di, double-buffered by cp.async (only
// the tiles at or after the key tile under the causal mask). One buffer
// holds P^T, then dS^T. kRagged (K4): keys at or past len get P = 0, so
// zero gradients, and a block whose keys are all past len stores zeros and
// returns; without it (K11) every key of S is live.
template <int D, int RG, bool kRagged>
__device__ __forceinline__ void attn_bwd_dkv(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ di, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, int nh, int S, int dh,
    int len, int causal, float sm_scale) {
  constexpr int kThr = 16 * RG, BK = kTM * RG, P = kPitch<D>, TD = D / 16;
  constexpr int kStage = 2 * kCols * P + 2 * kCols;   // Q, dO, lse, di
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);   // [BK, P]
  float* v_s = k_s + BK * P;                     // [BK, P]
  float* qd_s = v_s + BK * P;                    // 2 stages
  float* w_s = qd_s + 2 * kStage;                // [BK, kPitchS]
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * nh + h;
  const size_t head = bh * S * dh;
  const float scale2 = sm_scale * kLog2e;
  const int nk = min(BK, S - k0);
  if (kRagged && k0 >= len) {                    // every key past kv_len
    zero_rows<kThr>(dk + head, k0, nk, dh);
    zero_rows<kThr>(dv + head, k0, nk, dh);
    return;
  }
  // queries that may see a key of this tile: from the tile on, if causal
  const int q_begin = causal ? k0 / kCols * kCols : 0;
  const int tiles = (S - q_begin + kCols - 1) / kCols;

  // Query tile q0 into a stage: rows past S get zeros, lse = +inf (their P
  // and dS are zero) and di = 0.
  auto stage = [&](float* st, int q0) {
    const int n = min(kCols, S - q0);
    stage_rows<D, kThr>(st, q + head, q0, n, kCols, dh);
    stage_rows<D, kThr>(st + kCols * P, dout + head, q0, n, kCols, dh);
    float* stat = st + 2 * kCols * P;
    for (int i = tid; i < 2 * kCols; i += kThr) {
      const int r = i % kCols;
      const float* src = (i < kCols ? lse : di) + bh * S + q0 + r;
      if (r < n) flash_mma::cp_async4(stat + i, src);
      else stat[i] = i < kCols ? INFINITY : 0.f;
    }
  };
  const int live = kRagged ? min(nk, len - k0) : nk;   // keys staged
  stage_rows<D, kThr>(k_s, k + head, k0, live, BK, dh);
  stage_rows<D, kThr>(v_s, v + head, k0, live, BK, dh);
  stage(qd_s, q_begin);
  flash_mma::cp_commit();

  float dka[kTM][TD], dva[kTM][TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int e = 0; e < TD; ++e) dka[i][e] = dva[i][e] = 0.f;
  // only a tile past len holds keys past it
  const bool ragged = kRagged && k0 + BK > len;

  for (int t = 0; t < tiles; ++t) {
    const int q0 = q_begin + t * kCols;
    const float* q_t = qd_s + (t & 1) * kStage;
    const float* do_t = q_t + kCols * P;
    const float* lse_t = do_t + kCols * P;
    const float* di_t = lse_t + kCols;
    flash_mma::cp_wait<0>();
    __syncthreads();          // tile t landed; tile t - 1 and dS^T are read
    if (t + 1 < tiles) {      // the next tile lands while this one is used
      stage(qd_s + ((t + 1) & 1) * kStage, q0 + kCols);
      flash_mma::cp_commit();
    }
    // only tiles that reach below the diagonal hold masked pairs
    const bool edge = causal && q0 < k0 + BK - 1;
    float st[kTM][kTN];                          // S^T: keys x queries
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) st[i][j] = 0.f;
    fma_abt<D, RG>(st, k_s, q_t, rg, cg);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int key = k0 + rg + RG * i;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = cg + 16 * j;
        const bool dead = (edge && key > q0 + c) || (ragged && key >= len);
        w_s[(rg + RG * i) * kPitchS + c] =
            dead ? 0.f : exp2f(st[i][j] * scale2 - lse_t[c] * kLog2e);
      }
    }
    float dpt[kTM][kTN];                         // dP^T, then dS^T
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) dpt[i][j] = 0.f;
    fma_abt<D, RG>(dpt, v_s, do_t, rg, cg);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = cg + 16 * j;             // P from this thread's store
        dpt[i][j] = (dpt[i][j] - di_t[c]) * w_s[(rg + RG * i) * kPitchS + c];
      }
    __syncthreads();                             // P^T is written
    fma_ab<D, RG>(dva, w_s, do_t, rg, cg);
    __syncthreads();                             // P^T is read
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        w_s[(rg + RG * i) * kPitchS + cg + 16 * j] = dpt[i][j];
    __syncthreads();                             // dS^T is written
    fma_ab<D, RG>(dka, w_s, q_t, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int key = k0 + rg + RG * i;
    if (key < S) {                               // the scale at the store
      store_dims<D>(dk + head, key, dka[i], sm_scale, cg, dh);
      store_dims<D>(dv + head, key, dva[i], 1.f, cg, dh);
    }
  }
}

}  // namespace flash_simt
