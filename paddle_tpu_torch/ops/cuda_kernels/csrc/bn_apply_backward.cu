// K9: batch-norm apply epilogue, backward, fp32, for sm_90a.
//
// Replaces the backward of paddle_tpu/ops/pallas_kernels/epilogue.py
// bn_apply_act (:280; _apply_call_bwd :166 -> pallas_call :182, body
// _apply_bwd_kernel :101). It recomputes z = (x - mean) * (inv * scale) +
// bias [+ residual] (nothing is saved by the forward), and from dy writes
//   dz = dy * act'(z)          (identity, or relu: z > 0)
//   dx = dz * inv * scale,     dres = dz (when there is a residual)
//   P1 = sum dz,  P2 = sum dz * (x - mean)   per channel, as partial sums.
// The caller derives the four parameter gradients from P1 and P2 (scalar
// algebra per channel, epilogue.py:221-224).
//   "cl" (NHWC): x [R = N*H*W, C]; a block writes one row of each
//                [n_blocks, C] plane, the planes are summed outside the
//                kernel as the TPU version sums its [NT, C] planes (:217);
//   "cr" (NCHW): x [R = N*C, HW]; the sums of a row are complete, [R], and
//                are folded over N outside.
// No atomics anywhere: the sums come in a fixed order and the gradients
// repeat bit for bit.
//
// What bounds it on this card: HBM bytes, 3 or 5 R*row*4 (x, dy and the
// residual read once, dx and dres written once) plus the planes.
//
// What the design does about it. "cl" is a reduction over rows, the axis
// the blocks split: a block of 256 threads is TX column groups by TY rows
// and owns a strip of rows; each thread keeps the same columns in every row
// it visits, so its partial sums stay in registers; the TY partials of a
// column meet in shared memory in a fixed tree, and the block writes one
// [C] row per sum. The caller sizes the strip so the planes stay a small
// part of dx's bytes. 16-byte accesses when C % 4 == 0, one float
// otherwise. "cr": one warp per row, the two sums by warp shuffles, so a
// row of 49 values costs one warp and not one block; float4 when
// HW % 4 == 0, scalar otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int VEC>
struct Pack {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Pack<VEC> load(const float* p) {
  Pack<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Pack<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_apply_bwd_cl_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, const float* __restrict__ mean,
                       const float* __restrict__ inv, const float* __restrict__ res,
                       const float* __restrict__ dy, float* __restrict__ dx,
                       float* __restrict__ dres, float* __restrict__ p1_plane,
                       float* __restrict__ p2_plane, int R, int C, int TX,
                       int rows_per_block, int relu) {
  __shared__ float sm1[kThreads * VEC];
  __shared__ float sm2[kThreads * VEC];
  const int TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int groups = C / VEC;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)R, r0 + rows_per_block);
  // every thread runs every round: the rounds hold block barriers
  for (int g0 = 0; g0 < groups; g0 += TX) {
    const int g = g0 + tx;
    const bool live = g < groups;
    const int c = g * VEC;
    Pack<VEC> acc1, acc2;
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc1.v[k] = acc2.v[k] = 0.f;
    if (live) {
      const Pack<VEC> s = load<VEC>(scale + c), b = load<VEC>(bias + c),
                      m = load<VEC>(mean + c), v = load<VEC>(inv + c);
      Pack<VEC> a;
#pragma unroll
      for (int k = 0; k < VEC; ++k) a.v[k] = v.v[k] * s.v[k];
      for (long long r = r0 + ty; r < r1; r += TY) {
        const size_t off = (size_t)r * C + c;
        const Pack<VEC> xv = load<VEC>(x + off);
        Pack<VEC> dz = load<VEC>(dy + off);
        Pack<VEC> xc;
#pragma unroll
        for (int k = 0; k < VEC; ++k) xc.v[k] = xv.v[k] - m.v[k];
        if (relu) {
          Pack<VEC> z;
#pragma unroll
          for (int k = 0; k < VEC; ++k) z.v[k] = xc.v[k] * a.v[k] + b.v[k];
          if (res != nullptr) {
            const Pack<VEC> rv = load<VEC>(res + off);
#pragma unroll
            for (int k = 0; k < VEC; ++k) z.v[k] += rv.v[k];
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            if (!(z.v[k] > 0.f)) dz.v[k] = 0.f;
        }
        Pack<VEC> gx;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          gx.v[k] = dz.v[k] * a.v[k];
          acc1.v[k] += dz.v[k];
          acc2.v[k] += dz.v[k] * xc.v[k];
        }
        store<VEC>(dx + off, gx);
        if (dres != nullptr) store<VEC>(dres + off, dz);
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sm1[threadIdx.x * VEC + k] = acc1.v[k];
      sm2[threadIdx.x * VEC + k] = acc2.v[k];
    }
    __syncthreads();
    for (int s = TY >> 1; s > 0; s >>= 1) {
      if (ty < s) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          sm1[threadIdx.x * VEC + k] += sm1[(threadIdx.x + s * TX) * VEC + k];
          sm2[threadIdx.x * VEC + k] += sm2[(threadIdx.x + s * TX) * VEC + k];
        }
      }
      __syncthreads();
    }
    if (ty == 0 && live) {
      const size_t o = (size_t)blockIdx.x * C + c;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        p1_plane[o + k] = sm1[threadIdx.x * VEC + k];
        p2_plane[o + k] = sm2[threadIdx.x * VEC + k];
      }
    }
    __syncthreads();   // the next round writes the shared sums again
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_apply_bwd_cr_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, const float* __restrict__ mean,
                       const float* __restrict__ inv, const float* __restrict__ res,
                       const float* __restrict__ dy, float* __restrict__ dx,
                       float* __restrict__ dres, float* __restrict__ p1_rows,
                       float* __restrict__ p2_rows, int R, int HW, int C,
                       int relu) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;          // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int c = (int)(row % C);
  const float a = inv[c] * scale[c], b = bias[c], m = mean[c];
  const size_t base = (size_t)row * HW;
  float acc1 = 0.f, acc2 = 0.f;
  for (int i = lane * VEC; i < HW; i += 32 * VEC) {
    const Pack<VEC> xv = load<VEC>(x + base + i);
    Pack<VEC> dz = load<VEC>(dy + base + i);
    Pack<VEC> xc;
#pragma unroll
    for (int k = 0; k < VEC; ++k) xc.v[k] = xv.v[k] - m;
    if (relu) {
      Pack<VEC> z;
#pragma unroll
      for (int k = 0; k < VEC; ++k) z.v[k] = xc.v[k] * a + b;
      if (res != nullptr) {
        const Pack<VEC> rv = load<VEC>(res + base + i);
#pragma unroll
        for (int k = 0; k < VEC; ++k) z.v[k] += rv.v[k];
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (!(z.v[k] > 0.f)) dz.v[k] = 0.f;
    }
    Pack<VEC> gx;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      gx.v[k] = dz.v[k] * a;
      acc1 += dz.v[k];
      acc2 += dz.v[k] * xc.v[k];
    }
    store<VEC>(dx + base + i, gx);
    if (dres != nullptr) store<VEC>(dres + base + i, dz);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
    acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
  }
  if (lane == 0) {
    p1_rows[row] = acc1;
    p2_rows[row] = acc2;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int pow2_cover(int n, int cap) {
  int t = 1;
  while (t < n && t < cap) t <<= 1;
  return t;
}

}  // namespace

// x, dy, dx (and res, dres, or null for both): [R, row] fp32;
// scale/bias/mean/inv: [C] fp32. mode 0 = "cl" (row == C): p1, p2 are
// [ceil(R / rows_per_block), C] planes. mode 1 = "cr" (R % C == 0): p1, p2
// are [R] and rows_per_block is not read. act 0 = identity, 1 = relu.
extern "C" int bn_apply_act_backward_f32(
    const float* x, const float* scale, const float* bias, const float* mean,
    const float* inv, const float* res, const float* dy, float* dx, float* dres,
    float* p1, float* p2, int R, int row, int C, int mode, int act,
    int rows_per_block, void* stream) {
  if (R == 0 || row == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = row % 4 == 0 && aligned16(x) && aligned16(dy) &&
                   aligned16(dx) && (res == nullptr || aligned16(res)) &&
                   (dres == nullptr || aligned16(dres));
  if (mode == 0) {
    if (rows_per_block < 1) return (int)cudaErrorInvalidValue;
    const bool pvec = vec && aligned16(scale) && aligned16(bias) &&
                      aligned16(mean) && aligned16(inv);
    const int groups = pvec ? C / 4 : C;
    const int TX = pow2_cover(groups, kThreads);
    const int blocks = (R + rows_per_block - 1) / rows_per_block;
    if (pvec)
      bn_apply_bwd_cl_kernel<4><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, dy, dx, dres, p1, p2, R, C, TX,
          rows_per_block, act);
    else
      bn_apply_bwd_cl_kernel<1><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, dy, dx, dres, p1, p2, R, C, TX,
          rows_per_block, act);
  } else {
    const int blocks = (R + kWarps - 1) / kWarps;
    if (vec)
      bn_apply_bwd_cr_kernel<4><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, dy, dx, dres, p1, p2, R, row, C, act);
    else
      bn_apply_bwd_cr_kernel<1><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, dy, dx, dres, p1, p2, R, row, C, act);
  }
  return (int)cudaGetLastError();
}
