// K8: batch-norm apply epilogue, forward, fp32 and bf16, for sm_90a.
//
// Replaces the forward of paddle_tpu/ops/pallas_kernels/epilogue.py
// bn_apply_act (:280; _apply_call_fwd :142 -> pallas_call :151, body
// _apply_fwd_kernel :91). Given per-channel statistics it computes, in one
// visit of x,
//   y = act((x - mean) * (inv * scale) + bias [+ residual]),
// act identity or relu, in the TPU kernel's order of operations (one fused
// multiply-add for the affine, the residual added after it, a relu that
// keeps a NaN), for both canonical 2-D layouts:
//   "cl" (NHWC): x [R = N*H*W, C], element (r, j) is of channel j;
//   "cr" (NCHW): x [R = N*C, HW],  element (r, j) is of channel r % C
//                (the TPU version pre-tiles its parameters to [N*C, 1]).
// Both are one function of x's flat index i: i is of channel (i / inner) % C,
// inner = 1 ("cl") or HW ("cr"). x, the residual and y are fp32 or bf16 (T);
// the parameters are fp32 and the arithmetic is fp32 in registers; a bf16 y
// is rounded once, at the store, where the TPU kernel casts (epilogue.py:98).
//
// What bounds it on this card: HBM bytes, 2 or 3 R*row*sizeof(T) (x and the
// residual read once, y written once) plus the 4 C fp32 parameters; 4 flops
// an element.
//
// What the design does about it: one kernel for both layouts, over x, the
// residual and y as flat arrays of R*row elements (64-bit offsets).
//   * 16-byte accesses (4 fp32 or 8 bf16) whatever row is: consecutive
//     threads take consecutive 16-byte vectors, so a warp moves 512
//     contiguous bytes an access. The body starts at x's first 16-byte
//     boundary; the elements before it (a view with a storage offset) and
//     the ragged tail go element by element in block 0. x, the residual and
//     y at different offsets modulo 16 have no common aligned body: then the
//     whole run takes the one-element instantiation of the same kernel.
//   * the channel from the flat index: a quotient by inner and one by C, each
//     a 64-bit multiply-high and a shift (FastDiv, the round-up method of
//     Granlund and Montgomery), then a step an element inside the vector,
//     which may cross rows (row < VEC). How a vector finds its parameters
//     (read through the read-only path; 4 C floats stay in L1) is the
//     instantiation's policy, below: "cl" threads keep their channels'
//     parameters in registers, "cr" vectors read one set, or two where
//     they cross a row, and skip the per-element choice where no vector of
//     the warp crosses.
//   * a grid of whole waves: ceil(vectors / (kUnroll x 128 x resident)) x
//     resident blocks of 128 threads (resident: the occupancy calculator's
//     blocks the card holds at once), each thread kUnroll vectors at a
//     stride of the whole grid, all its loads of x (and of the residual)
//     issued before any arithmetic; the last wave is as full as the first.
//     A short run takes fewer blocks, a vector a thread.
//   * chosen on the card against the PR 3 design, torch's own elementwise
//     kernels over the same bytes and edited copies of this source
//     (`flash_ab.py --kernels bn_apply` and `--kernels variants`; PERF.md,
//     PR 23): one wave of resident blocks whose threads loop lost 3-7% on
//     the large maps to whole waves of threads that take their vectors
//     once; 64 registers a thread spilled the bf16 instantiations (now
//     <= 128: kMinBlocks 4 of 128 threads); one vector a thread is fastest
//     for "cr" (bf16 rows of 49 on an H100 80GB HBM3 at 700 W: 0.0342 ms
//     against 0.0399 at two), two (fp32) or four (bf16) for "cl", whose
//     parameters a thread reads once for all of them.
#include <cuda_runtime.h>
#include <stdint.h>

#include <numeric>

#include "elem.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;   // resident blocks an SM: <= 128 registers
constexpr long long kMaxWaves = 1 << 16;   // past it, the grid-stride loop
enum { kWalk = 0, kSpan = 1, kLanes = 2 };   // how a vector finds its channels

// Vectors a thread takes at a time: kLanes reads its channels' parameters
// once a thread, so 2 (fp32) or 4 (bf16) vectors share them; the others
// read them a vector and run fastest at one vector a thread and more warps.
template <typename T, int POL>
constexpr int kUnrollOf = POL == kLanes ? (sizeof(T) == 4 ? 2 : 4) : 1;

// n / d for n < 2^63 and 1 <= d < 2^31: (umulhi(mul, n) + n) >> shift with
// shift = ceil(log2 d), mul = floor(2^64 (2^shift - d) / d) + 1 (the sum
// fits 64 bits: umulhi(mul, n) <= n < 2^63).
struct FastDiv {
  unsigned long long mul;
  unsigned int d, shift;
};

FastDiv fast_div(unsigned int d) {
  unsigned int l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned __int128 num = (unsigned __int128)((1ull << l) - d) << 64;
  return {(unsigned long long)(num / d) + 1ull, d, l};
}

__device__ __forceinline__ unsigned long long quot(unsigned long long n,
                                                   const FastDiv& f) {
  return (__umul64hi(f.mul, n) + n) >> f.shift;
}

struct Geo {
  long long n;      // elements, R * row
  long long head;   // elements before x's first 16-byte boundary
  long long nvec;   // VEC-element vectors from there
  FastDiv inner;    // 1 ("cl", or "cr" with rows of 1) or row
  FastDiv chans;    // C
};

struct Par {
  float m, a, b;
};

__device__ __forceinline__ Par par_of(const float* __restrict__ scale,
                                      const float* __restrict__ bias,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ inv,
                                      unsigned int c) {
  return {__ldg(mean + c), __ldg(inv + c) * __ldg(scale + c), __ldg(bias + c)};
}

// the TPU kernel's arithmetic on one element: (x - m) * a + b as one fused
// multiply-add, + residual, act
template <bool RES, bool RELU>
__device__ __forceinline__ float apply(float x, float m, float a, float b,
                                       float r) {
  float z = fmaf(x - m, a, b);
  if (RES) z += r;
  return RELU ? relu_f(z) : z;
}

// The channel of flat element e and its place in its run of `inner`.
__device__ __forceinline__ unsigned int channel(long long e, const Geo& g,
                                                unsigned int* j) {
  const unsigned long long q = quot(e, g.inner);
  *j = (unsigned int)(e - q * g.inner.d);
  return (unsigned int)(q - quot(q, g.chans) * g.chans.d);
}

template <int N>
__device__ __forceinline__ void ldg_floats(const float* __restrict__ p,
                                           float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
    out[i] = t.x, out[i + 1] = t.y, out[i + 2] = t.z, out[i + 3] = t.w;
  }
}

// How a vector finds its channels' parameters:
//   kLanes: inner == 1 and C % VEC == 0, no head: a vector holds VEC
//           consecutive channels from a multiple of VEC, and the grid makes
//           (threads of the grid) x VEC a multiple of C, so every vector a
//           thread takes holds the same channels: their parameters are
//           read once, into registers;
//   kSpan:  inner >= VEC: a vector lies in at most two runs, of channels c
//           and c + 1 (mod C); where no vector of the warp crosses (a
//           vote) each takes c's set, else both sets are read and each
//           element takes its own;
//   kWalk:  anything (rows shorter than a vector, odd widths, the
//           one-element instantiation VEC == 1): a set at the vector's
//           first element, a new one at each run it enters.
template <typename T, int VEC, int POL, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bn_apply_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv, const T* __restrict__ res,
                    T* __restrict__ y, Geo g) {
  using V = Vec<T, VEC>;
  constexpr int kUnroll = kUnrollOf<T, POL>;
  if (blockIdx.x == 0) {
    // the head and the tail, fewer than 2 VEC elements, one a thread
    const long long tail = g.head + g.nvec * VEC;
    const long long t = threadIdx.x;
    if (t < g.head + (g.n - tail)) {
      const long long e = t < g.head ? t : tail + (t - g.head);
      unsigned int j;
      const Par p = par_of(scale, bias, mean, inv, channel(e, g, &j));
      y[e] = from_f<T>(apply<RES, RELU>(to_f(x[e]), p.m, p.a, p.b,
                                        RES ? to_f(res[e]) : 0.f));
    }
  }
  // a grid-stride loop over vectors, kUnroll of them a thread at a time
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  constexpr int NL = POL == kLanes ? VEC : 1;
  float lm[NL], la[NL], lb[NL];
  for (long long v0 = first; v0 < g.nvec; v0 += kUnroll * stride) {
    V xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < g.nvec) {
        const long long e = g.head + v * VEC;
        xv[u] = *reinterpret_cast<const V*>(x + e);
        if (RES) rv[u] = *reinterpret_cast<const V*>(res + e);
      }
    }
    if (POL == kLanes && v0 == first) {
      // the thread's channels, read once, after its first loads of x are
      // in flight (the product below waits for them)
      const long long e = first * VEC;
      const unsigned int c = (unsigned int)(e - quot(e, g.chans) * g.chans.d);
      float s[NL], iv[NL];
      ldg_floats<NL>(scale + c, s);
      ldg_floats<NL>(inv + c, iv);
      ldg_floats<NL>(mean + c, lm);
      ldg_floats<NL>(bias + c, lb);
#pragma unroll
      for (int k = 0; k < NL; ++k) la[k] = iv[k] * s[k];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v >= g.nvec) break;
      const long long e = g.head + v * VEC;
      float z[VEC];
      if (POL == kLanes) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          z[k] = apply<RES, RELU>(to_f(xv[u].v[k]), lm[k % NL], la[k % NL],
                                  lb[k % NL], RES ? to_f(rv[u].v[k]) : 0.f);
      } else if (POL == kSpan) {
        unsigned int j;
        const unsigned int c = channel(e, g, &j);
        const unsigned int split = g.inner.d - j;   // elements left in c's run
        const Par p0 = par_of(scale, bias, mean, inv, c);
        if (__all_sync(__activemask(), split >= VEC)) {
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            z[k] = apply<RES, RELU>(to_f(xv[u].v[k]), p0.m, p0.a, p0.b,
                                    RES ? to_f(rv[u].v[k]) : 0.f);
        } else {
          const Par p1 = split < VEC ? par_of(scale, bias, mean, inv,
                                              c + 1 == g.chans.d ? 0 : c + 1)
                                     : p0;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const Par& p = k < split ? p0 : p1;
            z[k] = apply<RES, RELU>(to_f(xv[u].v[k]), p.m, p.a, p.b,
                                    RES ? to_f(rv[u].v[k]) : 0.f);
          }
        }
      } else {
        unsigned int j;
        unsigned int c = channel(e, g, &j);
        Par p = par_of(scale, bias, mean, inv, c);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (k > 0 && ++j == g.inner.d) {   // the vector enters a new run
            j = 0;
            c = c + 1 == g.chans.d ? 0 : c + 1;
            p = par_of(scale, bias, mean, inv, c);
          }
          z[k] = apply<RES, RELU>(to_f(xv[u].v[k]), p.m, p.a, p.b,
                                  RES ? to_f(rv[u].v[k]) : 0.f);
        }
      }
      store_vec<T, VEC>(y + e, z);
    }
  }
}

template <typename T, int VEC, int POL, bool RES, bool RELU>
int launch_one(const T* x, const float* scale, const float* bias,
               const float* mean, const float* inv, const T* res, T* y,
               const Geo& g, cudaStream_t st) {
  auto kernel = bn_apply_fwd_kernel<T, VEC, POL, RES, RELU>;
  constexpr int kUnroll = kUnrollOf<T, POL>;
  // the blocks the card holds at once of this instantiation: one wave
  static const int resident = [kernel] {
    int dev = 0, sms = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
    return sms * (occ > 0 ? occ : 1);
  }();
  // whole waves: each thread takes at most kUnroll vectors, the grid a
  // multiple of the resident blocks (or fewer blocks, of a vector a
  // thread, when the run is short)
  const long long want = (g.nvec + kThreads - 1) / kThreads;
  long long grid = want < 1 ? 1 : want;
  if (want > resident) {
    const long long wave = (long long)kUnroll * kThreads * resident;
    grid = (g.nvec + wave - 1) / wave;
    grid = (grid < kMaxWaves ? grid : kMaxWaves) * resident;
  }
  int blocks = (int)grid;
  if constexpr (POL == kLanes) {
    if ((long long)blocks * kThreads < g.nvec) {
      // a thread takes several vectors: the grid's threads x VEC must be a
      // multiple of C for them to hold the same channels
      constexpr unsigned int kSpan16 = kThreads * VEC;   // a block's elements
      const int m = (int)(g.chans.d / std::gcd(g.chans.d, kSpan16));
      if (m > blocks)
        return launch_one<T, VEC, kWalk, RES, RELU>(x, scale, bias, mean,
                                                    inv, res, y, g, st);
      blocks = (blocks + m - 1) / m * m;
    }
  }
  kernel<<<blocks, kThreads, 0, st>>>(x, scale, bias, mean, inv, res, y, g);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int POL>
int launch_res(const T* x, const float* scale, const float* bias,
               const float* mean, const float* inv, const T* res, T* y,
               const Geo& g, bool relu, cudaStream_t st) {
  if (res != nullptr)
    return relu ? launch_one<T, VEC, POL, true, true>(x, scale, bias, mean,
                                                      inv, res, y, g, st)
                : launch_one<T, VEC, POL, true, false>(x, scale, bias, mean,
                                                       inv, res, y, g, st);
  return relu ? launch_one<T, VEC, POL, false, true>(x, scale, bias, mean, inv,
                                                     res, y, g, st)
              : launch_one<T, VEC, POL, false, false>(x, scale, bias, mean,
                                                      inv, res, y, g, st);
}

unsigned int offset16(const void* p) {
  return (unsigned int)(reinterpret_cast<uintptr_t>(p) & 15u);
}

// VEC: the elements of T in 16 bytes.
template <typename T>
int launch(const T* x, const float* scale, const float* bias,
           const float* mean, const float* inv, const T* res, T* y, int R,
           int row, int C, int mode, int act, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (R == 0 || row == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  Geo g;
  g.n = (long long)R * row;
  const unsigned int inner = mode == 0 ? 1u : (unsigned int)row;
  g.inner = fast_div(inner);
  g.chans = fast_div((unsigned int)C);
  const bool relu = act != 0;
  const unsigned int off = offset16(x);
  if (offset16(y) != off || (res != nullptr && offset16(res) != off)) {
    g.head = 0;
    g.nvec = g.n;
    return launch_res<T, 1, kWalk>(x, scale, bias, mean, inv, res, y, g, relu,
                                   st);
  }
  g.head = ((16u - off) & 15u) / sizeof(T);
  if (g.head > g.n) g.head = g.n;
  g.nvec = (g.n - g.head) / VEC;
  if (inner == 1 && C % VEC == 0 && g.head == 0 &&
      !(offset16(scale) | offset16(bias) | offset16(mean) | offset16(inv)))
    return launch_res<T, VEC, kLanes>(x, scale, bias, mean, inv, res, y, g,
                                      relu, st);
  if (inner >= (unsigned int)VEC)
    return launch_res<T, VEC, kSpan>(x, scale, bias, mean, inv, res, y, g,
                                     relu, st);
  return launch_res<T, VEC, kWalk>(x, scale, bias, mean, inv, res, y, g, relu,
                                   st);
}

}  // namespace

// x, y (and res, or null): [R, row] of the entry's type; scale/bias/mean/
// inv: [C] fp32. mode 0 = "cl" (row == C), mode 1 = "cr" (R % C == 0);
// act 0 = identity, 1 = relu.
extern "C" int bn_apply_act_f32(const float* x, const float* scale,
                                const float* bias, const float* mean,
                                const float* inv, const float* res, float* y,
                                int R, int row, int C, int mode, int act,
                                void* stream) {
  return launch<float>(x, scale, bias, mean, inv, res, y, R, row, C, mode,
                       act, stream);
}

extern "C" int bn_apply_act_bf16(const bf16* x, const float* scale,
                                 const float* bias, const float* mean,
                                 const float* inv, const bf16* res, bf16* y,
                                 int R, int row, int C, int mode, int act,
                                 void* stream) {
  return launch<bf16>(x, scale, bias, mean, inv, res, y, R, row, C, mode,
                      act, stream);
}
