// K9: batch-norm apply epilogue, backward, fp32 and bf16, for sm_90a.
//
// Replaces the backward of paddle_tpu/ops/pallas_kernels/epilogue.py
// bn_apply_act (:280; _apply_call_bwd :166 -> pallas_call :182, body
// _apply_bwd_kernel :101, fold _bwd_shared :207-224). It recomputes
// z = (x - mean) * (inv * scale) + bias [+ residual] (nothing is saved by the
// forward), and from dy
//   dz = dy * act'(z)          (identity, or relu: z > 0)
//   P1 = sum dz,  P2 = sum dz * (x - mean)   per channel,
// folds the two sums per channel into (the JAX op's algebra, epilogue.py:
// 221-224, and the chain of its batch statistics, nn_ops.py:564, var =
// E[x^2] - mean^2, inv = (var + eps)^-1/2, M rows a channel)
//   dscale = P2 inv,  dbias = P1,
//   dmean = -P1 inv scale,  dinv = P2 scale,  dvar = -inv^3 dinv / 2,
//   ca = (dmean - 2 mean dvar) / M,  cb = 2 dvar / M    (the chain mode)
// and writes
//   dx = dz * inv * scale [+ ca + cb * x],   dres = dz (with a residual),
// dx in fp32 registers, rounded once at the store (bf16 needs the chain
// unrounded: most of a training dx cancels in it; the TPU kernel casts at
// epilogue.py:115-117). x, the residual, dy, dx and dres are fp32 or bf16
// (T); the parameters, dz, the sums and the fold are fp32.
//   "cl" (NHWC): x [R = N*H*W, C];
//   "cr" (NCHW): x [R = N*C, HW], a row's channel is row % C.
//
// One cooperative launch a call, three phases split by grid-wide barriers:
//   1. the sums: every block walks a strip of rows ("cl") or its warps walk
//      whole rows ("cr") and writes one [C] row of partial P1 and P2 (a row
//      of [N, C] for "cr"); without the chain it writes dx here too;
//   2. the fold: the partials summed per column in a fixed order and the
//      algebra above, into one [6, C] buffer: P1, P2, dscale, dbias, ca, cb;
//   3. the chain mode only: dx (and dres) from ca and cb, the rows walked in
//      the reverse order of phase 1, so that the rows read last there are
//      still in the 50 MB L2.
// A single launch rather than a kernel a phase: the step that runs it is
// host-bound, and the torch launches the fold used to take (two sums and
// about 20 elementwise ops on [C] vectors a batch norm) are what made the
// chain lose to the library's training backward. No atomics in any sum: the
// order is fixed by the grid (the resident blocks, at most two an SM) and
// the tree, so dx, P1, P2, dscale and dbias repeat bit for bit.
//
// What bounds it on this card: HBM bytes, x and dy read once (twice in the
// chain mode, the second time partly from L2), the residual read for relu,
// dx and dres written once, plus 2 [grid, C] fp32 partial rows.
//
// What the design does about it. "cl": a block of 256 threads is TX column
// groups of VEC channels by TY rows (TX the power of two covering C / VEC,
// at most 256); a thread keeps its columns in every row it visits, so its
// partial sums stay in registers, and starts the loads of 4 rows (2 of
// 8-wide bf16 vectors) before it uses any (16-byte accesses, 4 fp32 or 8
// bf16, when C allows; one element otherwise). The TY partials of a column
// meet in shared memory in a fixed tree. "cr": one warp per row, the two
// sums by warp shuffles. The fold: 32 columns a block, 8 row slices summed
// in order, then a fixed tree. Values written in one phase and read in a
// later one (partials, ca, cb) are read through L2 (ld.global.cg), never
// through the non-coherent cache.
//
// The split mode, for a batch norm whose statistics are taken over several
// ranks (a sync batch norm): a collective must sit between the sums and the
// fold, and none can run inside a launch. `phase` 1 (the sums) runs phases 1
// and 2 without the chain: it writes P1, P2, dscale and dbias of this rank's
// rows and no dx. The caller sums [P1; P2] over the ranks. `phase` 2 (the
// chain from given sums) folds the summed [2, C] rows, passed as the
// partials with one partial row, with M the global count, and runs phase 3.
// Both reuse the walks of the one-launch mode, so with one rank the split's
// dx, dscale and dbias are the one launch's bit for bit (a fold over one
// partial row adds it to 0). `extra` ([2, C] or null) adds cotangents of the
// statistics outputs to dmean and dvar in the fold, in every mode.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows a thread loads before it computes: 4, or 2 of 8-wide bf16 vectors
// (4 spilled at the 128 registers two blocks an SM allow)
template <int VEC>
constexpr int kUnroll = VEC == 8 ? 2 : 4;
constexpr int kBlocksPerSm = 2;     // bounds the partials: [2 * SMs, C]
constexpr int kMinRowsPerBlock = 16;
constexpr int kFoldCols = 32;
constexpr int kFoldSlices = kThreads / kFoldCols;

template <typename T>
struct Args {
  const T* x;
  const T* res;
  const T* dy;
  const float* scale;
  const float* bias;
  const float* mean;
  const float* inv;
  T* dx;
  T* dres;
  float* part;        // [2, prow, C]: the partial P1 rows, then the P2 rows
  float* out;         // [6, C]: P1, P2, dscale, dbias, ca, cb
  long long* stamps;  // null, or 4 clock64 readings of block 0
  const float* extra; // null, or [2, C]: added to dmean, then to dvar
  int R, row, C, mode, relu, TX;
  float count;        // M; 0: one pass, no chain
  int phase;          // 0: the one launch; 1: the sums; 2: chain from sums
};

template <typename T, int VEC>
struct Raw {
  Vec<T, VEC> x, dy, res;
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> ld(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void widen(const Vec<T, VEC>& t, float* out) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = to_f(t.v[k]);
}

// dz of VEC elements (act' applied), xc = x - mean, and x itself.
template <typename T, int VEC>
__device__ __forceinline__ void grad_z(const Raw<T, VEC>& raw, const float* a,
                                       const float* b, const float* m,
                                       bool relu, bool has_res, float* xv,
                                       float* xc, float* dz) {
  widen<T, VEC>(raw.x, xv);
  widen<T, VEC>(raw.dy, dz);
#pragma unroll
  for (int k = 0; k < VEC; ++k) xc[k] = xv[k] - m[k];
  if (relu) {
    float z[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) z[k] = xc[k] * a[k] + b[k];
    if (has_res) {
      float rv[VEC];
      widen<T, VEC>(raw.res, rv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) z[k] += rv[k];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (!(z[k] > 0.f)) dz[k] = 0.f;
  }
}

// dx = dz a [+ c1 + c2 x] rounded once, and dres = dz.
template <typename T, int VEC>
__device__ __forceinline__ void store_grads(const Args<T>& p, size_t off,
                                            const float* dz, const float* a,
                                            const float* xv, const float* c1,
                                            const float* c2, bool chain) {
  float gx[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) gx[k] = dz[k] * a[k];
  if (chain) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) gx[k] += c1[k] + c2[k] * xv[k];
  }
  store_vec<T, VEC>(p.dx + off, gx);
  if (p.dres != nullptr) store_vec<T, VEC>(p.dres + off, dz);
}

// "cl", phases 1 (SUMS: the partials, and dx when `write`) and 3 (dx from
// ca and cb, rows and column rounds in reverse).
template <typename T, int VEC, bool SUMS>
__device__ void cl_walk(const Args<T>& p, bool write, float* sm1, float* sm2) {
  const int C = p.C, TX = p.TX, TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int groups = C / VEC;
  const int rpb = (p.R + gridDim.x - 1) / gridDim.x;
  const int r0 = min(p.R, (int)blockIdx.x * rpb), r1 = min(p.R, r0 + rpb);
  const int step = TY * kUnroll<VEC>;
  const int tiles = (r1 - r0 + step - 1) / step;
  const int rounds = (groups + TX - 1) / TX;
  const bool has_res = p.res != nullptr;
  for (int k = 0; k < rounds; ++k) {
    const int g = (SUMS ? k : rounds - 1 - k) * TX + tx;
    const bool live = g < groups;
    const int c = g * VEC;
    float acc1[VEC], acc2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc1[j] = acc2[j] = 0.f;
    if (live) {
      float a[VEC], b[VEC], m[VEC], c1[VEC], c2[VEC];
      {
        float s[VEC], v[VEC];
        load_vec<float, VEC>(p.scale + c, s);
        load_vec<float, VEC>(p.inv + c, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) a[j] = v[j] * s[j];
      }
      load_vec<float, VEC>(p.bias + c, b);
      load_vec<float, VEC>(p.mean + c, m);
      if (!SUMS) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          c1[j] = __ldcg(p.out + 4 * C + c + j);
          c2[j] = __ldcg(p.out + 5 * C + c + j);
        }
      }
      for (int i = 0; i < tiles; ++i) {
        const int base = r0 + (SUMS ? i : tiles - 1 - i) * step + ty;
        Raw<T, VEC> raw[kUnroll<VEC>];
#pragma unroll
        for (int u = 0; u < kUnroll<VEC>; ++u) {
          const int r = base + u * TY;
          if (r < r1) {
            const size_t off = (size_t)r * C + c;
            raw[u].x = ld<T, VEC>(p.x + off);
            raw[u].dy = ld<T, VEC>(p.dy + off);
            if (p.relu && has_res) raw[u].res = ld<T, VEC>(p.res + off);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll<VEC>; ++u) {
          const int r = base + u * TY;
          if (r >= r1) continue;
          float xv[VEC], xc[VEC], dz[VEC];
          grad_z<T, VEC>(raw[u], a, b, m, p.relu, has_res, xv, xc, dz);
          if (write)
            store_grads<T, VEC>(p, (size_t)r * C + c, dz, a, xv, c1, c2, !SUMS);
          if (SUMS) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              acc1[j] += dz[j];
              acc2[j] += dz[j] * xc[j];
            }
          }
        }
      }
    }
    if constexpr (SUMS) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sm1[threadIdx.x * VEC + j] = acc1[j];
        sm2[threadIdx.x * VEC + j] = acc2[j];
      }
      __syncthreads();
      for (int s = TY >> 1; s > 0; s >>= 1) {
        if (ty < s) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            sm1[threadIdx.x * VEC + j] += sm1[(threadIdx.x + s * TX) * VEC + j];
            sm2[threadIdx.x * VEC + j] += sm2[(threadIdx.x + s * TX) * VEC + j];
          }
        }
        __syncthreads();
      }
      if (ty == 0 && live) {
        const size_t o = (size_t)blockIdx.x * C + c;
        const size_t o2 = ((size_t)gridDim.x + blockIdx.x) * C + c;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          p.part[o + j] = sm1[threadIdx.x * VEC + j];
          p.part[o2 + j] = sm2[threadIdx.x * VEC + j];
        }
      }
      __syncthreads();   // the next round writes the shared sums again
    }
  }
}

// "cr", phases 1 and 3: a warp a row, rows strided over the grid's warps
// (phase 3 walks its rows from the last).
template <typename T, int VEC, bool SUMS>
__device__ void cr_walk(const Args<T>& p, bool write) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (first >= p.R) return;      // whole warps leave together
  const long long n = (p.R - 1 - first) / stride + 1;
  const bool has_res = p.res != nullptr;
  for (long long i = 0; i < n; ++i) {
    const long long row = first + (SUMS ? i : n - 1 - i) * stride;
    const int c = (int)(row % p.C);
    float a[VEC], b[VEC], m[VEC], c1[VEC], c2[VEC];
    const float av = p.inv[c] * p.scale[c], bv = p.bias[c], mv = p.mean[c];
    const float c1v = SUMS ? 0.f : __ldcg(p.out + 4 * p.C + c);
    const float c2v = SUMS ? 0.f : __ldcg(p.out + 5 * p.C + c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a[k] = av; b[k] = bv; m[k] = mv; c1[k] = c1v; c2[k] = c2v;
    }
    const size_t base = (size_t)row * p.row;
    float acc1 = 0.f, acc2 = 0.f;
    for (int e = lane * VEC; e < p.row; e += 32 * VEC) {
      Raw<T, VEC> raw;
      raw.x = ld<T, VEC>(p.x + base + e);
      raw.dy = ld<T, VEC>(p.dy + base + e);
      if (p.relu && has_res) raw.res = ld<T, VEC>(p.res + base + e);
      float xv[VEC], xc[VEC], dz[VEC];
      grad_z<T, VEC>(raw, a, b, m, p.relu, has_res, xv, xc, dz);
      if (write) store_grads<T, VEC>(p, base + e, dz, a, xv, c1, c2, !SUMS);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        acc1 += dz[k];
        acc2 += dz[k] * xc[k];
      }
    }
    if constexpr (SUMS) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
        acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
      }
      if (lane == 0) {
        p.part[row] = acc1;
        p.part[p.R + row] = acc2;
      }
    }
  }
}

// Phase 2: the partial rows [prow, C] of each sum folded per column (8
// slices in order, then a fixed tree), and the per-channel algebra.
template <typename T>
__device__ void fold(const Args<T>& p, int prow, float* sm1, float* sm2) {
  const int C = p.C;
  const int fx = threadIdx.x % kFoldCols, fy = threadIdx.x / kFoldCols;
  const float* p1 = p.part;
  const float* p2 = p.part + (size_t)prow * C;
  for (int cb0 = blockIdx.x * kFoldCols; cb0 < C;
       cb0 += gridDim.x * kFoldCols) {
    const int c = cb0 + fx;
    float s1 = 0.f, s2 = 0.f;
    if (c < C) {
#pragma unroll 8
      for (int r = fy; r < prow; r += kFoldSlices) {
        s1 += __ldcg(p1 + (size_t)r * C + c);
        s2 += __ldcg(p2 + (size_t)r * C + c);
      }
    }
    sm1[threadIdx.x] = s1;
    sm2[threadIdx.x] = s2;
    __syncthreads();
    for (int s = kFoldSlices >> 1; s > 0; s >>= 1) {
      if (fy < s) {
        sm1[threadIdx.x] += sm1[threadIdx.x + s * kFoldCols];
        sm2[threadIdx.x] += sm2[threadIdx.x + s * kFoldCols];
      }
      __syncthreads();
    }
    if (fy == 0 && c < C) {
      const float P1 = sm1[fx], P2 = sm2[fx];
      const float v = p.inv[c], s = p.scale[c];
      float ca = 0.f, cbv = 0.f;
      if (p.count > 0.f) {
        float dmean = -P1 * v * s;
        const float dinv = P2 * s;
        float dvar = -0.5f * v * v * v * dinv;
        if (p.extra != nullptr) {
          dmean += p.extra[c];
          dvar += p.extra[C + c];
        }
        ca = (dmean - 2.f * p.mean[c] * dvar) / p.count;
        cbv = 2.f * dvar / p.count;
      }
      p.out[c] = P1;
      p.out[C + c] = P2;
      p.out[2 * C + c] = P2 * v;
      p.out[3 * C + c] = P1;
      p.out[4 * C + c] = ca;
      p.out[5 * C + c] = cbv;
    }
    __syncthreads();   // the next columns write the shared sums again
  }
}

__device__ __forceinline__ void stamp(long long* stamps, int i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    stamps[i] = clock64();
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_apply_bwd_kernel(Args<T> p) {
  __shared__ float sm1[kThreads * VEC];
  __shared__ float sm2[kThreads * VEC];
  cg::grid_group grid = cg::this_grid();
  const bool chain = p.count > 0.f;
  stamp(p.stamps, 0);
  if (p.phase != 2) {
    if (p.mode == 0)
      cl_walk<T, VEC, true>(p, !chain && p.phase == 0, sm1, sm2);
    else
      cr_walk<T, VEC, true>(p, !chain && p.phase == 0);
    grid.sync();
  }
  stamp(p.stamps, 1);
  fold(p, p.phase == 2 ? 1 : p.mode == 0 ? (int)gridDim.x : p.R / p.C, sm1,
       sm2);
  if (chain && p.phase != 1) {
    grid.sync();
    stamp(p.stamps, 2);
    if (p.mode == 0)
      cl_walk<T, VEC, false>(p, true, sm1, sm2);
    else
      cr_walk<T, VEC, false>(p, true);
  }
  stamp(p.stamps, 3);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int pow2_cover(int n, int cap) {
  int t = 1;
  while (t < n && t < cap) t <<= 1;
  return t;
}

// The blocks the card holds at once of one instantiation (at most
// kBlocksPerSm an SM): the cooperative grid's ceiling.
template <typename T, int VEC>
int resident() {
  static const int n = [] {
    int dev = 0, sms = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, bn_apply_bwd_kernel<T, VEC>, kThreads, 0);
    return sms * max(1, min(occ, kBlocksPerSm));
  }();
  return n;
}

template <typename T>
int grid_for(int R, int C, int mode) {
  constexpr int VEC = 16 / sizeof(T);
  const int cap = min(resident<T, VEC>(), resident<T, 1>());
  const int want = mode == 0 ? (R + kMinRowsPerBlock - 1) / kMinRowsPerBlock
                             : (R + kWarps - 1) / kWarps;
  return max(1, min(cap, want));
}

template <typename T>
int launch(Args<T> p, int grid, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (p.R == 0 || p.row == 0) return 0;
  if (grid != grid_for<T>(p.R, p.C, p.mode)) return (int)cudaErrorInvalidValue;
  const bool vec = p.row % VEC == 0 && aligned16(p.x) && aligned16(p.dy) &&
                   aligned16(p.dx) && (p.res == nullptr || aligned16(p.res)) &&
                   (p.dres == nullptr || aligned16(p.dres)) &&
                   (p.mode == 1 || (aligned16(p.scale) && aligned16(p.bias) &&
                                    aligned16(p.mean) && aligned16(p.inv)));
  if (p.mode == 0) p.TX = pow2_cover(vec ? p.C / VEC : p.C, kThreads);
  void* args[] = {&p};
  const void* kernel = vec ? (const void*)bn_apply_bwd_kernel<T, VEC>
                           : (const void*)bn_apply_bwd_kernel<T, 1>;
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, grid, kThreads, args, 0,
                                              (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int entry(const T* x, const float* scale, const float* bias, const float* mean,
          const float* inv, const T* res, const T* dy, T* dx, T* dres,
          float* out, float* part, long long* stamps, int R, int row, int C,
          int mode, int act, float count, int phase, const float* extra,
          int grid, void* stream) {
  if (phase < 0 || phase > 2 || (phase == 1 && count > 0.f) ||
      (phase == 2 && !(count > 0.f)))
    return (int)cudaErrorInvalidValue;
  Args<T> p{x,   res,  dy,   scale, bias, mean,  inv,   dx,  dres, part, out,
            stamps, extra, R, row, C, mode, act, 1, count, phase};
  return launch<T>(p, grid, stream);
}

}  // namespace

// The cooperative grid of a call over R rows of C channels in `mode` (0
// "cl", 1 "cr"): the caller sizes the partials by it ([2, grid, C] for "cl",
// [2, R] for "cr") and passes it back.
extern "C" int bn_apply_act_backward_grid_f32(int R, int C, int mode) {
  return grid_for<float>(R, C, mode);
}

extern "C" int bn_apply_act_backward_grid_bf16(int R, int C, int mode) {
  return grid_for<bf16>(R, C, mode);
}

// x, dy, dx (and res, dres, or null for both): [R, row] of the entry's
// type; scale/bias/mean/inv: [C] fp32. mode 0 = "cl" (row == C), 1 = "cr"
// (R % C == 0). act 0 = identity, 1 = relu. out: [6, C] fp32 (P1, P2,
// dscale, dbias, ca, cb); part: fp32 scratch of [2, grid, C] ("cl") or
// [2, R] ("cr"); grid: bn_apply_act_backward_grid_*'s. count: the rows a
// channel (M) for the training chain dx = dz inv scale + ca + cb x, or 0 for
// dx = dz inv scale. phase: 0 the one launch; 1 the sums only (count 0: out
// gets this call's P1, P2, dscale, dbias; no dx); 2 the chain from given
// sums (count > 0; part holds the [2, C] P1, P2 to fold, summed over the
// ranks; out and dx as in phase 0). extra: null, or [2, C] fp32 added to
// dmean and dvar in the fold. stamps: null, or 4 int64 that get block 0's
// clock64 at its start, after the sums, after the fold (chain mode) and at
// its end.
extern "C" int bn_apply_act_backward_f32(
    const float* x, const float* scale, const float* bias, const float* mean,
    const float* inv, const float* res, const float* dy, float* dx,
    float* dres, float* out, float* part, long long* stamps, int R, int row,
    int C, int mode, int act, float count, int phase, const float* extra,
    int grid, void* stream) {
  return entry<float>(x, scale, bias, mean, inv, res, dy, dx, dres, out, part,
                      stamps, R, row, C, mode, act, count, phase, extra, grid,
                      stream);
}

extern "C" int bn_apply_act_backward_bf16(
    const bf16* x, const float* scale, const float* bias, const float* mean,
    const float* inv, const bf16* res, const bf16* dy, bf16* dx, bf16* dres,
    float* out, float* part, long long* stamps, int R, int row, int C,
    int mode, int act, float count, int phase, const float* extra, int grid,
    void* stream) {
  return entry<bf16>(x, scale, bias, mean, inv, res, dy, dx, dres, out, part,
                     stamps, R, row, C, mode, act, count, phase, extra, grid,
                     stream);
}
