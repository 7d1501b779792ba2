// K9: batch-norm apply epilogue, backward, fp32 and bf16, for sm_90a.
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
// The training backward of a batch norm also carries the batch statistics'
// own chain, dx += ca + cb * x per channel, whose coefficients need P1 and
// P2 first. Given ca and cb the kernel adds it in registers before the one
// rounding of dx: the wrapper then runs it twice, a pass for the sums
// (no dx written) and a pass for dx (no sums), so x and dy are read twice
// and dx written once, where a separate chain would read and write dx
// again, and in bf16 round it a second time after most of it cancels. x, the residual, dy, dx and dres are fp32 or bf16
// (T); the parameters, dz and the sums P1, P2 are fp32; a bf16 dx and dres
// are rounded once, at the store, where the TPU kernel casts them
// (epilogue.py:115-117).
//
// What bounds it on this card: HBM bytes, 3 or 5 R*row*sizeof(T) (x, dy and
// the residual read once, dx and dres written once) plus the planes.
//
// What the design does about it. "cl" is a reduction over rows, the axis
// the blocks split: a block of 256 threads is TX column groups by TY rows
// and owns a strip of rows; each thread keeps the same columns in every row
// it visits, so its partial sums stay in registers; the TY partials of a
// column meet in shared memory in a fixed tree, and the block writes one
// [C] row per sum. The caller sizes the strip so the planes stay a small
// part of dx's bytes. 16-byte accesses (4 fp32 or 8 bf16) when C is a
// multiple of that, one element otherwise. "cr": one warp per row, the two
// sums by warp shuffles, so a row of 49 values costs one warp and not one
// block; 16-byte accesses when HW is a multiple of their width, scalar
// otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_apply_bwd_cl_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, const float* __restrict__ mean,
                       const float* __restrict__ inv, const T* __restrict__ res,
                       const T* __restrict__ dy, const float* __restrict__ ca,
                       const float* __restrict__ cb, T* __restrict__ dx,
                       T* __restrict__ dres, float* __restrict__ p1_plane,
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
    float acc1[VEC], acc2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc1[k] = acc2[k] = 0.f;
    if (live) {
      float s[VEC], b[VEC], m[VEC], v[VEC], a[VEC], c1[VEC], c2[VEC];
      load_vec<float, VEC>(scale + c, s);
      load_vec<float, VEC>(bias + c, b);
      load_vec<float, VEC>(mean + c, m);
      load_vec<float, VEC>(inv + c, v);
      if (ca != nullptr) {
        load_vec<float, VEC>(ca + c, c1);
        load_vec<float, VEC>(cb + c, c2);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) a[k] = v[k] * s[k];
      for (long long r = r0 + ty; r < r1; r += TY) {
        const size_t off = (size_t)r * C + c;
        float xv[VEC], xc[VEC], dz[VEC];
        load_vec<T, VEC>(x + off, xv);
        load_vec<T, VEC>(dy + off, dz);
#pragma unroll
        for (int k = 0; k < VEC; ++k) xc[k] = xv[k] - m[k];
        if (relu) {
          float z[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) z[k] = xc[k] * a[k] + b[k];
          if (res != nullptr) {
            float rv[VEC];
            load_vec<T, VEC>(res + off, rv);
#pragma unroll
            for (int k = 0; k < VEC; ++k) z[k] += rv[k];
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            if (!(z[k] > 0.f)) dz[k] = 0.f;
        }
        if (dx != nullptr) {
          float gx[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) gx[k] = dz[k] * a[k];
          if (ca != nullptr) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) gx[k] += c1[k] + c2[k] * xv[k];
          }
          store_vec<T, VEC>(dx + off, gx);
          if (dres != nullptr) store_vec<T, VEC>(dres + off, dz);
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          acc1[k] += dz[k];
          acc2[k] += dz[k] * xc[k];
        }
      }
    }
    if (p1_plane == nullptr) continue;   // the apply pass: no sums (uniform)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sm1[threadIdx.x * VEC + k] = acc1[k];
      sm2[threadIdx.x * VEC + k] = acc2[k];
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_apply_bwd_cr_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, const float* __restrict__ mean,
                       const float* __restrict__ inv, const T* __restrict__ res,
                       const T* __restrict__ dy, const float* __restrict__ ca,
                       const float* __restrict__ cb, T* __restrict__ dx,
                       T* __restrict__ dres, float* __restrict__ p1_rows,
                       float* __restrict__ p2_rows, int R, int HW, int C,
                       int relu) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;          // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int c = (int)(row % C);
  const float a = inv[c] * scale[c], b = bias[c], m = mean[c];
  const float c1 = ca != nullptr ? ca[c] : 0.f, c2 = ca != nullptr ? cb[c] : 0.f;
  const size_t base = (size_t)row * HW;
  float acc1 = 0.f, acc2 = 0.f;
  for (int i = lane * VEC; i < HW; i += 32 * VEC) {
    float xv[VEC], xc[VEC], dz[VEC];
    load_vec<T, VEC>(x + base + i, xv);
    load_vec<T, VEC>(dy + base + i, dz);
#pragma unroll
    for (int k = 0; k < VEC; ++k) xc[k] = xv[k] - m;
    if (relu) {
      float z[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) z[k] = xc[k] * a + b;
      if (res != nullptr) {
        float rv[VEC];
        load_vec<T, VEC>(res + base + i, rv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) z[k] += rv[k];
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (!(z[k] > 0.f)) dz[k] = 0.f;
    }
    if (dx != nullptr) {
      float gx[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) gx[k] = dz[k] * a;
      if (ca != nullptr) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) gx[k] += c1 + c2 * xv[k];
      }
      store_vec<T, VEC>(dx + base + i, gx);
      if (dres != nullptr) store_vec<T, VEC>(dres + base + i, dz);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      acc1 += dz[k];
      acc2 += dz[k] * xc[k];
    }
  }
  if (p1_rows == nullptr) return;   // the apply pass: no sums
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

// VEC: the elements of T in 16 bytes.
template <typename T>
int launch(const T* x, const float* scale, const float* bias,
           const float* mean, const float* inv, const T* res, const T* dy,
           const float* ca, const float* cb, T* dx, T* dres, float* p1,
           float* p2, int R, int row, int C, int mode, int act,
           int rows_per_block, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (R == 0 || row == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = row % VEC == 0 && aligned16(x) && aligned16(dy) &&
                   (dx == nullptr || aligned16(dx)) &&
                   (res == nullptr || aligned16(res)) &&
                   (dres == nullptr || aligned16(dres));
  if (mode == 0) {
    if (rows_per_block < 1) return (int)cudaErrorInvalidValue;
    const bool pvec = vec && aligned16(scale) && aligned16(bias) &&
                      aligned16(mean) && aligned16(inv) &&
                      (ca == nullptr || (aligned16(ca) && aligned16(cb)));
    const int groups = pvec ? C / VEC : C;
    const int TX = pow2_cover(groups, kThreads);
    const int blocks = (R + rows_per_block - 1) / rows_per_block;
    if (pvec)
      bn_apply_bwd_cl_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, dy, ca, cb, dx, dres, p1, p2, R, C,
          TX, rows_per_block, act);
    else
      bn_apply_bwd_cl_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, dy, ca, cb, dx, dres, p1, p2, R, C,
          TX, rows_per_block, act);
  } else {
    const int blocks = (R + kWarps - 1) / kWarps;
    if (vec)
      bn_apply_bwd_cr_kernel<T, VEC><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, dy, ca, cb, dx, dres, p1, p2, R, row,
          C, act);
    else
      bn_apply_bwd_cr_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
          x, scale, bias, mean, inv, res, dy, ca, cb, dx, dres, p1, p2, R, row,
          C, act);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx (and res, dres, or null for both): [R, row] of the entry's
// type; scale/bias/mean/inv: [C] fp32. mode 0 = "cl" (row == C): p1, p2
// are [ceil(R / rows_per_block), C] fp32 planes. mode 1 = "cr"
// (R % C == 0): p1, p2 are [R] fp32 and rows_per_block is not read.
// act 0 = identity, 1 = relu. ca, cb ([C] fp32, or null): the statistics'
// chain, dx = dz * inv * scale + ca + cb * x in fp32, rounded once. dx and
// dres null: a pass for the sums only; p1 and p2 null: a pass for dx only.
extern "C" int bn_apply_act_backward_f32(
    const float* x, const float* scale, const float* bias, const float* mean,
    const float* inv, const float* res, const float* dy, const float* ca,
    const float* cb, float* dx, float* dres, float* p1, float* p2, int R,
    int row, int C, int mode, int act, int rows_per_block, void* stream) {
  return launch<float>(x, scale, bias, mean, inv, res, dy, ca, cb, dx, dres,
                       p1, p2, R, row, C, mode, act, rows_per_block, stream);
}

extern "C" int bn_apply_act_backward_bf16(
    const bf16* x, const float* scale, const float* bias, const float* mean,
    const float* inv, const bf16* res, const bf16* dy, const float* ca,
    const float* cb, bf16* dx, bf16* dres, float* p1, float* p2, int R,
    int row, int C, int mode, int act, int rows_per_block, void* stream) {
  return launch<bf16>(x, scale, bias, mean, inv, res, dy, ca, cb, dx, dres,
                      p1, p2, R, row, C, mode, act, rows_per_block, stream);
}
