// K1: ragged paged decode attention, fp32 and bf16, split over the KV
// slots, for sm_90a.
//
// Replaces paddle_tpu/ops/pallas_kernels/paged_attention.py:164
// paged_decode_attention (_decode_kernel :62, pallas_call :130). Each request
// row b has one query token per head; its context lives in pages
// page_table[b, 0..] of the [num_pages, page_size, nh, dh] K and V pools.
// out[b, h] = softmax(q[b, h] . K^T * scale) V over slots 0..kv_lens[b]-1.
//
// q, the pools and out are fp32 or bf16 (T); the arithmetic, the (m, l,
// acc) partials and their merge are fp32 in both, and a bf16 out is rounded
// once. The TPU kernel widens whatever dtype it is given the same way.
//
// What bounds it on this card: HBM bytes. Every live slot of K and V is read
// once (sum of kv_lens x nh x dh x sizeof(T) x 2); the arithmetic is about 1
// flop per 4 bytes of fp32, far below the card's balance, so bf16 pools halve
// the bound. At serving batch sizes the bytes
// are few (a 500-slot row is 3 MB at BERT-base width), so what shows is how
// many SMs share the longest row and how many of its loads are in flight.
//
// What the design does about it. One cooperative launch, two phases:
//  1. split-KV: a row's live slots are cut into spans of `span` slots (a
//     multiple of the staging chunk, chosen by the host so that B rows x
//     the table's spans cover the resident blocks, 16 to 128 slots), and one
//     block takes a (row, span) item for all nh heads at once (for a row
//     too wide for a chunk of at least kMinChunk slots in shared memory, a
//     (row, span, head group) item for the most heads that a full chunk
//     fits, each group's slice of a slot still one contiguous run): kv_len, the
//     span's page ids and q arrive in one round trip (cp.async into shared
//     memory, the ids clamped into [0, num_pages) after), then a chunk of up
//     to 16 slots of K and of V, each slot one contiguous nh x dh row, in a
//     second (16-byte cp.async, all of a chunk's copies in flight
//     together); a per-head online softmax (m, l) and the [nh, dh]
//     accumulator follow, the scores in log2 units (scale * log2 e, exp2f).
//     A row of one span writes its output here; a longer row leaves its
//     spans' (m, l, acc) in an fp32 scratch. Items that start past kv_len
//     read no K or V;
//  2. after a grid-wide barrier, a block per (row, head) of the rows with
//     more than one span merges their partials in one more round trip:
//     each warp four spans at a time, all their loads in flight, then the
//     warps' results in warp order.
// No atomics: the spans, the chunks, the heads' sums and the merge all run
// in a fixed order, so the output repeats bit for bit. A kv_len 0 row reads
// nothing and writes zeros (finite, nobody reads it).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 16;               // slots staged at once
constexpr int kMinChunk = 4;                // else the heads split in groups
constexpr int kMaxSpanChunks = 8;           // chunks a span: spans <= 128 slots
constexpr int kSmemBudget = 112 * 1024;     // bytes a block: two an SM
constexpr int kSmemMax = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Args {
  const T* q;
  const T* k_pool;
  const T* v_pool;
  const int* page_table;
  const int* kv_lens;
  T* out;
  float* part;      // [B, NS, E] accumulators, then [B, NS, nh, 2] (m, l)
  int B, nh, dh, num_pages, ps, P, chunk, span, NS;
  int hg, NG;       // heads an item, head groups (NG = ceil(nh / hg))
  float scale2;     // sm_scale * log2 e
};

__device__ __forceinline__ void cp_async16(void* smem, const void* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g));
}

// One element of the scalar path: a 4-byte cp.async for fp32; bf16 has no
// 2-byte cp.async, so a plain load and store (seen after the block's next
// __syncthreads, as the copies are after their wait).
__device__ __forceinline__ void stage1(float* smem, const float* g) {
  cp_async4(smem, g);
}
__device__ __forceinline__ void stage1(bf16* smem, const bf16* g) {
  *smem = *g;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

template <typename T>
__device__ __forceinline__ int live_len(const Args<T>& a, int b) {
  return min(max(a.kv_lens[b], 0), a.P * a.ps);
}

constexpr int kWarps = kThreads / 32;

// Shared memory of a block for items of hg heads, in bytes, each region
// starting on 16 bytes: q (T), acc (fp32), the K and V chunks (T), the
// chunk's scores, per-head m, l and alpha (fp32), then the span's page ids;
// the merge reuses it for its warps' (m, l, acc) of one head and the kv_lens
// of the block's next kThreads merge items. esize is sizeof(T): a bf16 stage
// is half as wide, so the plan that sizes chunk, span and head groups from
// these bytes needs it.
__host__ __device__ inline size_t pad16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

struct Layout {
  size_t acc, k, v, sc, stats, pg, items;
};

__host__ __device__ inline Layout smem_layout(int esize, int hg, int dh,
                                              int chunk) {
  const size_t W = (size_t)hg * dh;
  Layout L;
  L.acc = pad16(W * esize);                  // q at 0
  L.k = L.acc + pad16(W * 4);
  L.v = L.k + pad16((size_t)chunk * W * esize);
  L.sc = L.v + pad16((size_t)chunk * W * esize);
  L.stats = L.sc + pad16((size_t)chunk * hg * 4);
  L.pg = L.stats + pad16((size_t)3 * hg * 4);
  L.items = L.pg;
  return L;
}

__host__ __device__ inline size_t merge_bytes(int dh) {
  return 4 * ((size_t)kWarps * (2 + dh) + kThreads);
}

__host__ __device__ inline int span_pages(int span, int ps) {
  return span / ps + 2;
}

// Phase 1 for item (b, s) of head group g: heads h0 .. h0 + nh - 1, the
// columns off .. off + W - 1 of a slot's nh x dh row of E.
template <typename T>
__device__ void span_item(const Args<T>& a, int b, int s, int g,
                          unsigned char* sm, bool vec) {
  constexpr int N = 16 / sizeof(T);           // elements a 16-byte copy
  const int E = a.nh * a.dh, dh = a.dh, ps = a.ps;
  const int h0 = g * a.hg, nh = min(a.hg, a.nh - h0), W = nh * dh;
  const size_t off = (size_t)h0 * dh;
  const int a0 = s * a.span;
  const Layout L = smem_layout(sizeof(T), a.hg, dh, a.chunk);
  T* q_s = reinterpret_cast<T*>(sm);
  float* acc_s = reinterpret_cast<float*>(sm + L.acc);
  T* k_s = reinterpret_cast<T*>(sm + L.k);
  T* v_s = reinterpret_cast<T*>(sm + L.v);
  float* sc = reinterpret_cast<float*>(sm + L.sc);
  float* m_s = reinterpret_cast<float*>(sm + L.stats);
  float* l_s = m_s + nh;
  float* al_s = l_s + nh;
  int* pg = reinterpret_cast<int*>(sm + L.pg);

  // one round trip: kv_len, the span's page-table entries (whatever kv_len
  // turns out to be) and q, all in flight together
  const int len_raw = a.kv_lens[b];
  const int p0 = a0 / ps;    // < P: a0 < P ps
  const int np = min((a0 + a.span - 1) / ps - p0 + 1, a.P - p0);
  const int* table = a.page_table + (size_t)b * a.P + p0;
  for (int t = threadIdx.x; t < np; t += kThreads) cp_async4(pg + t, table + t);
  const T* qb = a.q + (size_t)b * E + off;
  if (vec) {
    for (int e = threadIdx.x * N; e < W; e += kThreads * N)
      cp_async16(q_s + e, qb + e);
  } else {
    for (int e = threadIdx.x; e < W; e += kThreads) stage1(q_s + e, qb + e);
  }
  cp_async_wait_all();
  const int len = min(max(len_raw, 0), a.P * ps);
  T* out = a.out + (size_t)b * E + off;
  if (len == 0) {                      // span 0 of an empty row: zeros
    if (s == 0)
      for (int e = threadIdx.x; e < W; e += kThreads) out[e] = from_f<T>(0.f);
    return;
  }
  if (a0 >= len) return;               // past the row's live slots
  const int a1 = min(len, a0 + a.span);
  const int spans = (len + a.span - 1) / a.span;
  for (int t = threadIdx.x; t < np; t += kThreads)   // its own copies
    pg[t] = min(max(pg[t], 0), a.num_pages - 1);
  for (int e = threadIdx.x; e < W; e += kThreads) acc_s[e] = 0.f;
  for (int h = threadIdx.x; h < nh; h += kThreads) {
    m_s[h] = kNegInf;
    l_s[h] = 0.f;
  }
  __syncthreads();

  for (int c0 = a0; c0 < a1; c0 += a.chunk) {
    const int n = min(a.chunk, a1 - c0);
    // the chunk's K and V rows, every copy in flight before any wait
    if (vec) {
      const int rv = W / N;
      for (int j = threadIdx.x; j < n * rv; j += kThreads) {
        const int i = j / rv, col = (j - i * rv) * N, slot = c0 + i;
        const size_t src =
            ((size_t)pg[slot / ps - p0] * ps + slot % ps) * E + off + col;
        cp_async16(k_s + (size_t)i * W + col, a.k_pool + src);
        cp_async16(v_s + (size_t)i * W + col, a.v_pool + src);
      }
    } else {
      for (int j = threadIdx.x; j < n * W; j += kThreads) {
        const int i = j / W, col = j - i * W, slot = c0 + i;
        const size_t src =
            ((size_t)pg[slot / ps - p0] * ps + slot % ps) * E + off + col;
        stage1(k_s + (size_t)i * W + col, a.k_pool + src);
        stage1(v_s + (size_t)i * W + col, a.v_pool + src);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // scores of (slot i, head h), a thread each; each starts its walk over
    // dh at its own offset, so a warp's shared-memory reads fall in
    // distinct banks (16-byte reads of N elements, widened, and four sums
    // when dh % N == 0)
    for (int pr = threadIdx.x; pr < n * nh; pr += kThreads) {
      const int i = pr / nh, h = pr - i * nh;
      const T* kr = k_s + (size_t)i * W + h * dh;
      const T* qr = q_s + h * dh;
      float dot;
      if (dh % N == 0) {
        const int dq = dh / N;
        int c = pr % dq;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        // 16 elements an unrolled step in both types (bf16 spilled at 4)
#pragma unroll(16 / N)
        for (int t = 0; t < dq; ++t) {
          float kv[N], qv[N];
          load_vec<T, N>(kr + c * N, kv);
          load_vec<T, N>(qr + c * N, qv);
#pragma unroll
          for (int j = 0; j < N; ++j) d[j % 4] = fmaf(qv[j], kv[j], d[j % 4]);
          c = c + 1 == dq ? 0 : c + 1;
        }
        dot = ((d[0] + d[1]) + (d[2] + d[3])) * a.scale2;
      } else {
        int d = pr % dh;
        dot = 0.f;
        for (int t = 0; t < dh; ++t) {
          dot = fmaf(to_f(qr[d]), to_f(kr[d]), dot);
          d = d + 1 == dh ? 0 : d + 1;
        }
        dot *= a.scale2;
      }
      sc[i * nh + h] = dot;
    }
    __syncthreads();
    // the online softmax, a warp a head, a lane a slot (chunk <= 32)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int h = warp; h < nh; h += kThreads / 32) {
      const float v = lane < n ? sc[lane * nh + h] : kNegInf;
      float mx = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[h];
      mx = fmaxf(mx, m_old);               // slot c0 is live: mx is real
      const float pe = lane < n ? exp2f(v - mx) : 0.f;
      float sum = pe;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < n) sc[lane * nh + h] = pe;
      if (lane == 0) {
        const float al = exp2f(m_old - mx);
        al_s[h] = al;
        l_s[h] = l_s[h] * al + sum;
        m_s[h] = mx;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < W; e += kThreads) {
      const int h = e / dh;
      float acc = acc_s[e] * al_s[h];
#pragma unroll 4
      for (int i = 0; i < n; ++i)
        acc = fmaf(sc[i * nh + h], to_f(v_s[(size_t)i * W + e]), acc);
      acc_s[e] = acc;
    }
    __syncthreads();   // the next chunk's copies overwrite K, V and scores
  }

  if (spans == 1) {
    for (int e = threadIdx.x; e < W; e += kThreads)
      out[e] = from_f<T>(acc_s[e] / l_s[e / dh]);
  } else {
    const size_t item = (size_t)b * a.NS + s;
    float* pa = a.part + item * E + off;
    float* pml = a.part + (size_t)a.B * a.NS * E + (item * a.nh + h0) * 2;
    for (int e = threadIdx.x; e < W; e += kThreads) pa[e] = acc_s[e];
    for (int h = threadIdx.x; h < nh; h += kThreads) {
      pml[2 * h] = m_s[h];
      pml[2 * h + 1] = l_s[h];
    }
  }
  __syncthreads();     // the next item stages into the same shared memory
}

// Phase 2: a block merges the spans of one (row, head). Warp w takes spans
// 4w..4w+3, then 4w+32.., four at a time with every load in flight (an
// online rescale across its batches), a lane a dimension; the warps' (m, l,
// acc) then meet in shared memory in warp order.
template <typename T>
__device__ void merge(const Args<T>& a, int b, int h, int len, float* sm) {
  const int spans = (len + a.span - 1) / a.span;
  if (spans < 2) return;                 // the block leaves together
  const int E = a.nh * a.dh, dh = a.dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* pa = a.part + (size_t)b * a.NS * E + h * dh;
  const float* pml = a.part + (size_t)a.B * a.NS * E +
                     ((size_t)b * a.NS * a.nh + h) * 2;
  const size_t ml_stride = (size_t)a.nh * 2;
  float mx = kNegInf, l = 0.f;
  float o[4] = {0.f, 0.f, 0.f, 0.f};     // dh <= 128: 4 dims a lane
  for (int s0 = warp * 4; s0 < spans; s0 += kWarps * 4) {
    float m[4], lv[4], v[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int sp = s0 + k;
      const bool ok = sp < spans;
      m[k] = ok ? __ldcg(pml + sp * ml_stride) : kNegInf;
      lv[k] = ok ? __ldcg(pml + sp * ml_stride + 1) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = lane + 32 * j;
        v[k][j] = ok && d < dh ? __ldcg(pa + (size_t)sp * E + d) : 0.f;
      }
    }
    float mb = mx;
#pragma unroll
    for (int k = 0; k < 4; ++k) mb = fmaxf(mb, m[k]);
    const float r = exp2f(mx - mb);
    l *= r;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] *= r;
    mx = mb;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = exp2f(m[k] - mx);
      l = fmaf(lv[k], w, l);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = fmaf(v[k][j], w, o[j]);
    }
  }
  float* wm = sm;
  float* wl = wm + kWarps;
  float* wo = wl + kWarps;               // [kWarps, dh]
  if (lane == 0) {
    wm[warp] = mx;
    wl[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = lane + 32 * j;
    if (d < dh) wo[warp * dh + d] = o[j];
  }
  __syncthreads();
  float M = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w]);
  T* out = a.out + (size_t)b * E + h * dh;
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(wm[w] - M);
      num = fmaf(wo[w * dh + d], e, num);
      den = fmaf(wl[w], e, den);
    }
    out[d] = from_f<T>(num / den);
  }
  __syncthreads();     // the next merge writes the same shared memory
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(Args<T> a, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int items = a.B * a.NS * a.NG;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int r = it / a.B;
    span_item(a, it % a.B, r / a.NG, r % a.NG, smem_raw, vec);
  }
  grid.sync();
  // the merge items of this block, their rows' kv_lens kThreads at a time
  // in one round trip
  const int merges = a.B * a.nh;
  int* lens_s = reinterpret_cast<int*>(sm + kWarps * (2 + a.dh));
  for (int base = blockIdx.x; base < merges; base += gridDim.x * kThreads) {
    const int mine = base + threadIdx.x * gridDim.x;
    if (mine < merges) lens_s[threadIdx.x] = live_len(a, mine / a.nh);
    __syncthreads();
    for (int k = 0; k < kThreads; ++k) {
      const int it = base + k * gridDim.x;
      if (it >= merges) break;
      merge(a, it / a.nh, it % a.nh, lens_s[k], sm);
    }
    __syncthreads();   // the next kv_lens overwrite these
  }
}

// Dynamic shared memory bytes of a block for items of hg heads of T.
size_t smem_bytes(int esize, int hg, int dh, int ps, int chunk) {
  const size_t items = smem_layout(esize, hg, dh, chunk).items +
                       4 * span_pages(chunk * kMaxSpanChunks, ps);
  const size_t merge = merge_bytes(dh);
  return items > merge ? items : merge;
}

// The largest chunk (slots) whose items of hg heads fit `budget` bytes, or 0.
int fit_chunk(int esize, int hg, int dh, int ps, int budget) {
  for (int c = kMaxChunk; c >= 1; --c)
    if (smem_bytes(esize, hg, dh, ps, c) <= (size_t)budget) return c;
  return 0;
}

// chunk, span, grid, dynamic shared memory bytes, heads an item and the
// resident blocks an SM for a call's shape. A whole row (all nh heads) when
// a chunk of kMinChunk slots or more fits two blocks an SM, else one;
// otherwise head groups of the most heads whose full chunk fits two blocks
// an SM. The grid is sized by the occupancy of T's own instantiation at
// these bytes: a bf16 block is about half as large, so more of them fit.
template <typename T>
int plan(int B, int nh, int dh, int ps, int P, int* out) {
  const int es = sizeof(T);
  int hg = nh, chunk = fit_chunk(es, nh, dh, ps, kSmemBudget);
  if (chunk == 0) chunk = fit_chunk(es, nh, dh, ps, kSmemMax);
  if (chunk < kMinChunk) {
    chunk = kMaxChunk;
    while (hg > 1 && smem_bytes(es, hg, dh, ps, chunk) > (size_t)kSmemBudget)
      --hg;
  }
  const size_t bytes = smem_bytes(es, hg, dh, ps, chunk);
  static bool attr = [] {
    return cudaFuncSetAttribute(paged_decode_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemMax) == cudaSuccess;
  }();
  if (!attr || bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, paged_decode_kernel<T>,
                                                kThreads, bytes);
  const int resident = sms * (occ > 0 ? occ : 1);
  // spans of whole chunks, as few chunks as still give every resident
  // block an item when the rows fill the table
  const long long groups = (nh + hg - 1) / hg;
  const long long slots = (long long)B * P * ps * groups;
  const long long per_wave = (long long)chunk * resident;
  long long k = (slots + per_wave - 1) / per_wave;
  k = k < 1 ? 1 : (k > kMaxSpanChunks ? kMaxSpanChunks : k);
  const int span = chunk * (int)k;
  const long long items = (long long)B * groups * ((P * ps + span - 1) / span);
  out[0] = chunk;
  out[1] = span;
  out[2] = (int)(items < resident ? items : resident);
  out[3] = (int)bytes;
  out[4] = hg;
  out[5] = occ;
  return 0;
}

template <typename T>
int run(const T* q, const T* k_pool, const T* v_pool, const int* page_table,
        const int* kv_lens, T* out, float* part, int B, int nh, int dh,
        int num_pages, int ps, int P, int chunk, int span, int grid, int smem,
        int hg, float sm_scale, void* stream) {
  if (B == 0 || nh == 0) return 0;
  if (P == 0) {     // no slots at all: every row is a kv_len 0 row
    return (int)cudaMemsetAsync(out, 0, sizeof(T) * B * nh * dh,
                                (cudaStream_t)stream);
  }
  constexpr int N = 16 / sizeof(T);
  const int E = nh * dh;
  // 16-byte copies when every group's slice starts and ends on 16 bytes
  int vec = E % N == 0 && hg * dh % N == 0 && ((uintptr_t)q & 15u) == 0 &&
            ((uintptr_t)k_pool & 15u) == 0 &&
            ((uintptr_t)v_pool & 15u) == 0;
  Args<T> a{q, k_pool, v_pool, page_table, kv_lens, out, part, B, nh, dh,
            num_pages, ps, P, chunk, span, (P * ps + span - 1) / span,
            hg, (nh + hg - 1) / hg, sm_scale * kLog2e};
  void* args[] = {&a, &vec};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)paged_decode_kernel<T>, grid, kThreads, args, smem,
      (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// plan: 6 ints out, the staging chunk (slots), the span (slots an item), the
// cooperative grid, the dynamic shared memory bytes, the heads an item and
// the resident blocks an SM (the occupancy calculator's, at those bytes) for
// B rows of nh heads of dh, page size ps and P table entries a row. The
// caller sizes the fp32 scratch by them: B x ceil(P ps / span) spans of
// nh x dh + 2 nh floats.
extern "C" int paged_decode_attention_plan_f32(int B, int nh, int dh, int ps,
                                               int P, int* plan_out) {
  return plan<float>(B, nh, dh, ps, P, plan_out);
}

extern "C" int paged_decode_attention_plan_bf16(int B, int nh, int dh, int ps,
                                                int P, int* plan_out) {
  return plan<bf16>(B, nh, dh, ps, P, plan_out);
}

extern "C" int paged_decode_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* page_table, const int* kv_lens, float* out, float* part,
    int B, int nh, int dh, int num_pages, int ps, int P, int chunk, int span,
    int grid, int smem, int hg, float sm_scale, void* stream) {
  return run<float>(q, k_pool, v_pool, page_table, kv_lens, out, part, B, nh,
                    dh, num_pages, ps, P, chunk, span, grid, smem, hg,
                    sm_scale, stream);
}

extern "C" int paged_decode_attention_bf16(
    const bf16* q, const bf16* k_pool, const bf16* v_pool,
    const int* page_table, const int* kv_lens, bf16* out, float* part,
    int B, int nh, int dh, int num_pages, int ps, int P, int chunk, int span,
    int grid, int smem, int hg, float sm_scale, void* stream) {
  return run<bf16>(q, k_pool, v_pool, page_table, kv_lens, out, part, B, nh,
                   dh, num_pages, ps, P, chunk, span, grid, smem, hg,
                   sm_scale, stream);
}
