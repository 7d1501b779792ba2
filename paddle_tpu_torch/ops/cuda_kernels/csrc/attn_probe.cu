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
// one batch item) so that the same table can be read on this card. The max
// of a row is taken over all of its keys before any exponential, as the
// TPU body does (no online rescaling). qk reads only the first dh keys of
// a head and computes only the dh key columns it writes; the TPU body
// formed all S on its matrix unit and sliced.
//
// What bounds it on this card: at the tool's shape [128, 12, 128, 64] the
// bytes (3 or 4 tensors of 25 MB: 0.0225 and 0.0300 ms at 3.35 TB/s; qk's
// Q, output and half of K: 0.0188 ms); the
// products (2 S^2 dh a head each) take a tenth of that on the tensor cores,
// which only wgmma reaches, and the exponentials (S^2 a head on the
// special-function unit) about a third.
//
// What the design does about it (dh = 64; csrc/flash_wgmma.cuh):
//   * a block of NWG consumer warpgroups and a producer warpgroup walks its
//     heads' items, an item being 64 NWG query rows of one head (a consumer
//     warpgroup's 64 each): NWG = 2 where the grid gives an SM one block
//     (the tool's 12 heads a block: 128 blocks), NWG = 1 where it gives two
//     or more (full_perhead: 1536), so that two blocks share an SM and one's
//     copies and stores overlap the other's products (each layout on the
//     other's grid was 12-31% slower). The producer's first thread copies
//     each item's Q tile into a ring of 2 stages and its K and V tiles (128
//     keys each; qk's K tile: the first 64) into a ring of 10 (NWG = 1: 5),
//     by TMA into 128-byte-swizzled shared memory, each stage with a "full"
//     and an "empty" mbarrier, so the copies of the next item's tiles run
//     ahead of the current item's products (a ring of 3 Q stages was no
//     faster). A tile read once is copied under an evict-first L2 policy
//     (without it full was 2% slower);
//   * S = Q K^T is wgmma m64n128k16 (m64n64k16 for qk: only the first dh
//     keys) from shared memory through K-major descriptors; O += P V is
//     m64n64k16 with P in registers (pack_a of the fp32 accumulator, the
//     TPU body's cast) and V through the MN-major descriptor;
//   * at S <= 128 a warpgroup's rows fit one m64n128 accumulator: the max,
//     the exponentials (one FFMA and one ex2.approx a score, in base 2) and
//     P V come out of one product. Past 128 keys a row takes two passes
//     over the key tiles: the max, then the exponentials (qk_max and
//     softmax keep the first dh columns of the first tile from the first
//     pass). Keys past S are zero-filled by the copy engine and masked to
//     -inf before the max;
//   * full: l sums the unrounded p, P enters the product rounded to bf16;
//     full_bf16sm: p' = bf16(2^(bf16((s - m) sm) log2 e)), l' sums p';
//   * a warpgroup's 64 output rows go through a swizzled shared tile (each
//     thread's 4-byte pairs on distinct banks) and one TMA store: stored
//     from registers, 4 bytes a thread and 16 a row segment, they made qk
//     0.042 ms against 0.029 and full 0.054 against 0.046;
//   * copy is its own kernel: 16-byte loads of q and v, eight of each in
//     flight a thread, an fp32 sum rounded once (as torch's q + v).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace {

using namespace flash_wg;

constexpr int kDh = 64;
constexpr int kKeys = 128;                // keys a K or V tile
constexpr int kTile = kKeys * kDh;        // elements of a K or V tile
constexpr int kCopyThreads = 512;

// A block of NWG consumer warpgroups, 64 query rows each (an item: 64 NWG
// rows of one head), and a producer warpgroup. NWG = 2 (384 threads, one
// block an SM) for grids of fewer than two blocks an SM, as the tool's 12
// heads a block give; NWG = 1 (256 threads, 128 registers each at launch)
// lets two blocks share an SM, so that one's copies and stores overlap the
// other's products. setmaxnreg moves registers from the producer to the
// consumers (128 x 40 + 256 x 232, or 128 x 24 + 128 x 232): without it
// full_perhead and full_bf16sm were 2-5% slower. Three blocks an SM (80
// registers at launch) do not compile: an m64n128 product needs 90.
// (Times: the H100 at 700 W, chip_smoke's timer; `flash_ab.py --kernels
// variants` builds such alternatives, text edits of this source, beside
// it.)
template <int NWG>
struct Layout {
  static constexpr int kRows = 64 * NWG;
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kQStages = 2, kKvStages = NWG == 2 ? 10 : 5;
  // the rings, then a 64-row output tile for each consumer warpgroup
  static constexpr int kSmem =
      1024 + 2 * kDh * (kQStages * kRows + kKvStages * kKeys + 64 * NWG);
};
constexpr float kLog2e = 1.4426950408889634f;

enum Variant { kCopy = 0, kQk, kQkMax, kSoftmax, kFull, kFullBf16Sm };

// The producer's copy of the n-th tile of a ring of ROWS-row tiles (rows
// [r0, r0 + ROWS) of head bh, under L2 policy `policy`), once every
// consumer warpgroup has released its stage.
template <int ROWS>
__device__ __forceinline__ void put(bf16* ring, uint64_t* full,
                                    uint64_t* empty, int stages, int& n,
                                    const CUtensorMap* map, int r0, int bh,
                                    uint64_t policy) {
  const int st = n % stages;
  if (n >= stages) mbar_wait(&empty[st], (n / stages - 1) & 1);
  mbar_expect(&full[st], ROWS * kDh * 2);
  tma_load3(ring + st * ROWS * kDh, map, &full[st], 0, r0, bh, policy);
  ++n;
}

// A consumer's n-th tile of a ring of ROWS-row tiles, once it has landed.
template <int ROWS>
__device__ __forceinline__ const bf16* take(const bf16* ring, uint64_t* full,
                                            int stages, int n) {
  const int st = n % stages;
  mbar_wait(&full[st], (n / stages) & 1);
  __syncwarp();
  return ring + st * ROWS * kDh;
}

// This warpgroup is done with the n-th tile of a ring.
__device__ __forceinline__ void give(uint64_t* empty, int stages, int n) {
  if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[n % stages]);
}

// s (m64nN) = the warpgroup's 64 rows of the QROWS-row Q tile times the
// KROWS-row K tile's first N keys, transposed.
template <int QROWS, int KROWS = kKeys, int R>
__device__ __forceinline__ void scores(float (&s)[R], const bf16* q_t,
                                       const bf16* k_t, int wg) {
  reg_fence(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_ss<0>(s, desc_k<QROWS>(q_t, 64 * wg, kk), desc_k<KROWS>(k_t, 0, kk),
                kk > 0);
  wg_commit();
  wg_wait<0>();
  reg_fence(s);
}

// Keys at or past S of the tile from k0 get -inf.
__device__ __forceinline__ void mask(float (&s)[64], int k0, int S, int t) {
  if (k0 + kKeys <= S) return;
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * i + 2 * t + (e & 1) >= S) s[4 * i + e] = -INFINITY;
}

// m = max(m, the tile's row max) for this thread's two rows.
__device__ __forceinline__ void row_max(const float (&s)[64], float (&m)[2]) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * i + e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    m[r] = fmaxf(m[r], mt[r]);
  }
}

// l += the tile's row sums of 2^(s scale2 + nm), the exponentials of the
// scaled scores less the row max.
__device__ __forceinline__ void row_sum_exp(const float (&s)[64], float scale2,
                                            const float (&nm)[2], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e >> 1] += ex2(fmaf(s[4 * i + e], scale2, nm[e >> 1]));
}

// ---- the output: TMA stores from a swizzled tile ----
__device__ __forceinline__ void wg_sync(int wg) {     // this warpgroup only
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The warpgroup's 64 rows of an m64n64 accumulator layout `v` (row r of
// this thread times mul[r]) rounded to bf16 into the swizzled tile o_t,
// then stored by TMA to rows [r0, r0 + 64) of head bh. Every thread writes
// its 4-byte pairs to distinct banks; the warpgroup's first thread issues
// the copy once the last one has read o_t.
__device__ __forceinline__ void store(const CUtensorMap* omap, bf16* o_t,
                                      int r0, int bh, int wg, int warp, int g,
                                      int t, const float (&v)[32],
                                      const float (&mul)[2]) {
  const bool lead = (threadIdx.x & 127) == 0;
  if (lead) stores_read();
  wg_sync(wg);
  unsigned char* base = reinterpret_cast<unsigned char*>(o_t);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = 16 * warp + g + 8 * r;
#pragma unroll
    for (int i = 0; i < kDh / 8; ++i)
      *reinterpret_cast<uint32_t*>(base + lr * 128 + ((i ^ (lr & 7)) << 4)
                                   + 4 * t) =
          pack2(v[4 * i + 2 * r] * mul[r], v[4 * i + 2 * r + 1] * mul[r]);
  }
  fence_async_smem();
  wg_sync(wg);
  if (lead) tma_store3(omap, o_t, 0, r0, bh);   // rows past S not written
}

// Block (x, b) owns heads [x gh, x gh + gh) of batch item b; its items are
// (head, 128-row tile) in that order. The producer's tile order below is
// the order in which the consumers take them.
template <int VAR, int NWG>
__global__ void __launch_bounds__(Layout<NWG>::kThreads, 3 - NWG)
attn_probe_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap, int nh, int S,
                     int gh, float sm) {
  using L = Layout<NWG>;
  constexpr int kRows = L::kRows, kQStages = L::kQStages,
                kKvStages = L::kKvStages;
  constexpr bool kFullish = VAR == kFull || VAR == kFullBf16Sm;
  extern __shared__ unsigned char smem_raw[];
  bf16* q_ring = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* kv_ring = q_ring + kQStages * kRows * kDh;
  bf16* o_tiles = kv_ring + kKvStages * kTile;   // 64 rows a warpgroup
  __shared__ uint64_t bars[2 * (kQStages + kKvStages)];
  uint64_t* q_full = bars;
  uint64_t* q_empty = q_full + kQStages;
  uint64_t* kv_full = q_empty + kQStages;
  uint64_t* kv_empty = kv_full + kKvStages;
  const int tid = threadIdx.x, wid = warp_id(), wg = wid >> 2,
            warp = wid & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int head0 = blockIdx.y * nh + blockIdx.x * gh;
  const int nrt = (S + kRows - 1) / kRows, nkt = (S + kKeys - 1) / kKeys;
  const int items = gh * nrt;
  // the variants that take the row max in a pass of its own
  const bool pass_a = VAR == kQkMax || VAR == kSoftmax || (kFullish && nkt > 1);
  if (tid == 0) {
    for (int i = 0; i < kQStages; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], NWG);
    }
    for (int i = 0; i < kKvStages; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {                     // the producer warpgroup
    producer_regs<NWG == 2 ? 40 : 24>();
    if (tid != 128 * NWG) return;
    // Q is read once; K and V once only if one item holds every query row
    // and one key tile every key (else again from L2)
    const uint64_t q_pol = l2_policy(true),
                   kv_pol = l2_policy(nrt == 1 && nkt == 1);
    int qn = 0, kn = 0;
    auto kv = [&](const CUtensorMap* map, int j, int bh) {
      put<kKeys>(kv_ring, kv_full, kv_empty, kKvStages, kn, map, j * kKeys, bh,
                 kv_pol);
    };
    for (int it = 0; it < items; ++it) {
      const int bh = head0 + it / nrt;
      put<kRows>(q_ring, q_full, q_empty, kQStages, qn, &qmap,
                 (it % nrt) * kRows, bh, q_pol);
      if (VAR == kQk) {                // the first dh keys (kmap's box)
        put<kDh>(kv_ring, kv_full, kv_empty, kKvStages, kn, &kmap, 0, bh,
                 kv_pol);
        continue;
      }
      if (pass_a)
        for (int j = 0; j < nkt; ++j) kv(&kmap, j, bh);
      if (VAR == kSoftmax && nkt > 1)
        for (int j = 0; j < nkt; ++j) kv(&kmap, j, bh);
      if (kFullish)
        for (int j = 0; j < nkt; ++j) {
          kv(&kmap, j, bh);
          kv(&vmap, j, bh);
        }
    }
    return;
  }

  // the consumer warpgroups
  consumer_regs<232>();
  const float scale2 = sm * kLog2e;
  bf16* o_t = o_tiles + wg * (kTile / 2);
  int qn = 0, kn = 0;
  for (int it = 0; it < items; ++it) {
    const int bh = head0 + it / nrt, r0 = (it % nrt) * kRows + 64 * wg;
    const bf16* q_t = take<kRows>(q_ring, q_full, kQStages, qn);

    if (VAR == kQk) {
      float s[32];
      scores<kRows, kDh>(s, q_t, take<kDh>(kv_ring, kv_full, kKvStages, kn),
                         wg);
      give(kv_empty, kKvStages, kn++);
      give(q_empty, kQStages, qn++);
      store(&omap, o_t, r0, bh, wg, warp, g, t, s, {sm, sm});
      continue;
    }

    float s[64], keep[32];
    float m[2] = {-INFINITY, -INFINITY};       // row max of Q K^T (unscaled)
    if (pass_a) {
      for (int j = 0; j < nkt; ++j) {
        scores<kRows>(s, q_t, take<kKeys>(kv_ring, kv_full, kKvStages, kn), wg);
        give(kv_empty, kKvStages, kn++);
        mask(s, j * kKeys, S, t);
        row_max(s, m);
        if ((VAR == kQkMax || VAR == kSoftmax) && j == 0) {
#pragma unroll
          for (int i = 0; i < 32; ++i) keep[i] = s[i];   // keys [0, 64)
        }
      }
    }

    if (VAR == kQkMax) {
      give(q_empty, kQStages, qn++);
#pragma unroll
      for (int i = 0; i < 32; ++i) keep[i] -= m[(i >> 1) & 1];
      store(&omap, o_t, r0, bh, wg, warp, g, t, keep, {sm, sm});
      continue;
    }

    if (VAR == kSoftmax) {
      const float nm[2] = {-m[0] * scale2, -m[1] * scale2};
      float l[2] = {0.f, 0.f};
      if (nkt == 1) {
        row_sum_exp(s, scale2, nm, l);
      } else {
        for (int j = 0; j < nkt; ++j) {
          scores<kRows>(s, q_t, take<kKeys>(kv_ring, kv_full, kKvStages, kn), wg);
          give(kv_empty, kKvStages, kn++);
          mask(s, j * kKeys, S, t);
          row_sum_exp(s, scale2, nm, l);
        }
      }
      give(q_empty, kQStages, qn++);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        keep[i] = ex2(fmaf(keep[i], scale2, nm[(i >> 1) & 1]));
      store(&omap, o_t, r0, bh, wg, warp, g, t, keep, {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])});
      continue;
    }

    // full, full_bf16sm: O = P V over the key tiles, then O / l
    float o[32], l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    for (int j = 0; j < nkt; ++j) {
      const bf16* k_t = take<kKeys>(kv_ring, kv_full, kKvStages, kn);
      const bf16* v_t = take<kKeys>(kv_ring, kv_full, kKvStages, kn + 1);
      scores<kRows>(s, q_t, k_t, wg);
      give(kv_empty, kKvStages, kn);
      mask(s, j * kKeys, S, t);
      if (!pass_a) row_max(s, m);
      uint32_t pa[kKeys / 16][4];
      if (VAR == kFull) {
        const float nm[2] = {-m[0] * scale2, -m[1] * scale2};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          s[i] = ex2(fmaf(s[i], scale2, nm[(i >> 1) & 1]));
          l[(i >> 1) & 1] += s[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float d = round_to<bf16>((s[i] - m[(i >> 1) & 1]) * sm);
          s[i] = round_to<bf16>(ex2(d * kLog2e));
          l[(i >> 1) & 1] += s[i];
        }
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) pack_a(pa[kk], s, kk);
      reg_fence(o);
      reg_fence(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs<1>(o, pa[kk], desc_mn<kKeys>(v_t, kk));
      wg_commit();
      wg_wait<0>();
      reg_fence(o);
      give(kv_empty, kKvStages, kn + 1);
      kn += 2;
    }
    give(q_empty, kQStages, qn++);
    store(&omap, o_t, r0, bh, wg, warp, g, t, o,
          {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])});
  }
  if ((tid & 127) == 0) stores_done();
}

// copy: out = q + v over the block's heads, one contiguous run of `chunks`
// 16-byte chunks.
__global__ void __launch_bounds__(kCopyThreads)
attn_probe_copy_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
                       bf16* __restrict__ out, int chunks) {
  constexpr int U = 8;
  const size_t base = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * chunks;
  const uint4* qc = reinterpret_cast<const uint4*>(q) + base;
  const uint4* vc = reinterpret_cast<const uint4*>(v) + base;
  uint4* oc = reinterpret_cast<uint4*>(out) + base;
  for (int c0 = threadIdx.x; c0 < chunks; c0 += U * kCopyThreads) {
    uint4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * kCopyThreads;
      if (c < chunks) {
        a[u] = __ldcs(qc + c);       // read once: evicted first
        b[u] = __ldcs(vc + c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * kCopyThreads;
      if (c >= chunks) continue;
      const uint32_t x[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
      const uint32_t y[4] = {b[u].x, b[u].y, b[u].z, b[u].w};
      uint32_t r[4];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        r[w] = pack2(__uint_as_float(x[w] << 16) + __uint_as_float(y[w] << 16),
                     __uint_as_float(x[w] & 0xffff0000u)
                         + __uint_as_float(y[w] & 0xffff0000u));
      oc[c] = make_uint4(r[0], r[1], r[2], r[3]);
    }
  }
}

template <int VAR, int NWG>
int launch_nwg(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
               int nh, int S, int gh, float sm, cudaStream_t st) {
  using L = Layout<NWG>;
  CUtensorMap qm, km, vm, om;
  int rc = map_heads(&qm, q, B * nh, S, kDh, L::kRows);
  // qk reads a 64-row K tile: the keys of the columns it writes
  if (!rc) rc = map_heads(&km, k, B * nh, S, kDh, VAR == kQk ? kDh : kKeys);
  if (!rc) rc = map_heads(&vm, v, B * nh, S, kDh, kKeys);
  if (!rc) rc = map_heads(&om, out, B * nh, S, kDh, 64);
  if (!rc)
    rc = (int)cudaFuncSetAttribute(attn_probe_wg_kernel<VAR, NWG>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   L::kSmem);
  if (rc) return rc;
  attn_probe_wg_kernel<VAR, NWG>
      <<<dim3(nh / gh, B), L::kThreads, L::kSmem, st>>>(qm, km, vm, om, nh, S,
                                                        gh, sm);
  return 0;
}

// Two consumer warpgroups a block unless the grid gives every SM two blocks.
template <int VAR>
int launch_wg(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
              int nh, int S, int gh, float sm, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  return (long long)(nh / gh) * B >= 2LL * sms
             ? launch_nwg<VAR, 1>(q, k, v, out, B, nh, S, gh, sm, st)
             : launch_nwg<VAR, 2>(q, k, v, out, B, nh, S, gh, sm, st);
}

}  // namespace

// q, k, v, out: [B, nh, S, 64] bf16, 16-byte aligned; variant: 0 copy, 1 qk,
// 2 qk_max, 3 softmax, 4 full, 5 full_bf16sm; heads_per_block divides nh;
// S >= 64.
extern "C" int attn_probe_bf16(const bf16* q, const bf16* k, const bf16* v,
                               bf16* out, int B, int nh, int S, int dh,
                               int variant, int heads_per_block, float sm,
                               void* stream) {
  if (B == 0 || nh == 0 || S == 0) return 0;
  if (dh != kDh || S < kDh || heads_per_block < 1 || nh % heads_per_block)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(nh / heads_per_block, B);
  int rc;
  switch (variant) {
    case kCopy:
      attn_probe_copy_kernel<<<grid, kCopyThreads, 0, st>>>(
          q, v, out, heads_per_block * S * kDh / 8);
      rc = 0;
      break;
    case kQk: rc = launch_wg<kQk>(q, k, v, out, B, nh, S, heads_per_block, sm, st); break;
    case kQkMax: rc = launch_wg<kQkMax>(q, k, v, out, B, nh, S, heads_per_block, sm, st); break;
    case kSoftmax: rc = launch_wg<kSoftmax>(q, k, v, out, B, nh, S, heads_per_block, sm, st); break;
    case kFull: rc = launch_wg<kFull>(q, k, v, out, B, nh, S, heads_per_block, sm, st); break;
    case kFullBf16Sm: rc = launch_wg<kFullBf16Sm>(q, k, v, out, B, nh, S, heads_per_block, sm, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return rc ? rc : (int)cudaGetLastError();
}
