// K13: the copy-throughput probe, bf16, for sm_90a.
//
// Replaces the TPU kernels of tools/_attn_dma.py: copy4 (:34, pallas_call
// :37) over [B, nh, S, dh] and copy3 (:47, pallas_call :50) over [B, S, H],
// each o = 2 x (exact in bf16) with a block of `bb` batch items, the block
// shape the tool sweeps (bb in 1, 4, 16) to see what a block's size does to
// the copy rate.
//
// What bounds it on this card: the bytes (x read once, o written once, at
// 3.35 TB/s); there is one multiply an element.
//
// What the design does about it: the tool's grid (B / bb blocks, one a
// group of bb batch items; the layouts differ only in shape, so a block's
// items are one contiguous run) is the probe's variable and stays, so a
// block's own rate sets the row's rate wherever the grid is smaller than
// the card (bb = 16 gives 8 blocks for 132 SMs). A block of 512 threads
// streams its run through a ring of kStages shared-memory stages of kChunk
// bytes: its first thread keeps every free stage loading by one bulk copy
// (cp.async.bulk global -> shared, completing on the stage's mbarrier), the
// block doubles each stage in place as it lands (16-byte shared accesses),
// and the first thread writes it back by one bulk store (shared -> global)
// and refills the stage once the store has read it. So 192 KB stay in
// flight a block, where one 16-byte load a thread kept 8 KB. Measured
// against the alternatives (`flash_ab.py --kernels variants`, H100 80GB
// HBM3 at 700 W; bb = 1 / 4 / 16 ms at [128, 12, 128, 64]): 6 stages of
// 32 KB 0.0219-0.0224 / 0.0259-0.0261 / 0.0687-0.0689; 8 of 16 KB 0.0227-
// 0.0229 / 0.0300 / 0.0980; 12 of 16 KB, 16 of 8 KB and 4 of 16 KB
// slower; 8 or 16 independent 16-byte loads a thread before any store,
// 0.0237-0.0240 / 0.0262-0.0285 / 0.0724-0.0746. Where 8 blocks carry the
// whole copy (bb = 16) a block's rate is all: 91 GB/s an SM, read and
// written, against 80 before.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 512;
constexpr int kChunk = 32768;     // bytes a stage
constexpr int kStages = 6;        // stages in the ring

// 2 x of the 8 bf16 in v (exact: an exponent step; bf16 rounding of the
// fp32 double is the identity).
__device__ __forceinline__ uint4 twice(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = pack2(2.f * __uint_as_float(w[i] << 16),
                 2.f * __uint_as_float(w[i] & 0xffff0000u));
  return make_uint4(r[0], r[1], r[2], r[3]);
}

__global__ void __launch_bounds__(kThreads, 1)
dma_probe_kernel(const bf16* __restrict__ x, bf16* __restrict__ o,
                 long long block_elems) {
  extern __shared__ __align__(128) uint4 ring[];   // kStages x kChunk bytes
  __shared__ uint64_t full[kStages];
  const int tid = threadIdx.x;
  const long long bytes = 2 * block_elems;       // a multiple of 16
  const char* src = reinterpret_cast<const char*>(x + blockIdx.x * block_elems);
  char* dst = reinterpret_cast<char*>(o + blockIdx.x * block_elems);
  const int chunks = (int)((bytes + kChunk - 1) / kChunk);
  auto len = [&](int c) {
    return (uint32_t)min((long long)kChunk, bytes - (long long)c * kChunk);
  };
  auto load = [&](int c) {
    const int s = c % kStages;
    mbar_expect(&full[s], len(c));
    bulk_load(ring + s * (kChunk / 16), src + (long long)c * kChunk, len(c),
              &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int c = 0; c < min(kStages, chunks); ++c) load(c);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    uint4* st = ring + s * (kChunk / 16);
    for (int i = tid; i < (int)(len(c) / 16); i += kThreads) st[i] = twice(st[i]);
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      bulk_store(dst + (long long)c * kChunk, st, len(c));
      // the stage of chunk c - 1 takes chunk c - 1 + kStages once its
      // store has read it
      if (c >= 1 && c - 1 + kStages < chunks) {
        stores_read<1>();
        load(c - 1 + kStages);
      }
    }
  }
  if (tid == 0) stores_done();
}

}  // namespace

// x, o: B batch items of `item` bf16 elements each, 16-byte aligned; bb
// items a block (B % bb == 0, bb * item % 8 == 0 so that every block's run
// starts 16-byte aligned and is whole 16-byte chunks).
extern "C" int dma_probe_bf16(const bf16* x, bf16* o, int B, long long item,
                              int bb, void* stream) {
  if (B == 0 || item == 0) return 0;
  if (bb < 1 || B % bb || (bb * item) % 8) return (int)cudaErrorInvalidValue;
  const int smem = kStages * kChunk;
  const cudaError_t e = cudaFuncSetAttribute(
      dma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dma_probe_kernel<<<B / bb, kThreads, smem, (cudaStream_t)stream>>>(
      x, o, (long long)bb * item);
  return (int)cudaGetLastError();
}
