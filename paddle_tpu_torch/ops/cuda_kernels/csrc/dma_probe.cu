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
// group of bb batch items), each block of 512 threads walking its bb items
// (the layouts differ only in shape, so both are one contiguous run of
// bb * item elements) as 16-byte loads and stores, 8 elements a thread a
// step, neighbouring threads on neighbouring addresses. The block size is
// the probe's variable: with bb = 16 the tool's shape gives 8 blocks for
// the card's 132 SMs, and the rate shows it.
#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
dma_probe_kernel(const bf16* __restrict__ x, bf16* __restrict__ o,
                 long long block_elems) {
  const size_t base = (size_t)blockIdx.x * block_elems;
  const long long n8 = block_elems / 8;    // the launch checks % 8 == 0
  for (long long i = threadIdx.x; i < n8; i += kThreads) {
    float f[8];
    load_vec<bf16, 8>(x + base + 8 * i, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] *= 2.f;
    store_vec<bf16, 8>(o + base + 8 * i, f);
  }
}

}  // namespace

// x, o: B batch items of `item` bf16 elements each; bb items a block (B %
// bb == 0, bb * item % 8 == 0 for the 16-byte steps to stay aligned).
extern "C" int dma_probe_bf16(const bf16* x, bf16* o, int B, long long item,
                              int bb, void* stream) {
  if (B == 0 || item == 0) return 0;
  if (bb < 1 || B % bb || (bb * item) % 8) return (int)cudaErrorInvalidValue;
  dma_probe_kernel<<<B / bb, kThreads, 0, (cudaStream_t)stream>>>(
      x, o, (long long)bb * item);
  return (int)cudaGetLastError();
}
