"""#15: the fused bf16 ResNet bottleneck chain (csrc/bottleneck_block.cu).

Replaces tools/_rn_pallas_block.py:64 `pallas_block`: relu(x . w1), a 3x3
conv of it, relu, a 1x1 back up to C channels plus the residual x, relu —
1x1 (C -> M) -> 3x3 (M -> M) -> 1x1 (M -> C) + x in one kernel, in bf16
on the tensor cores with fp32 accumulation, so the two M-channel
intermediates never reach device memory. No batch norm and no bias, as in
the tool. The JAX package never routes a model through its kernel (the tool
measured it and retired it), so no model here calls this either: the
module's `main()` is the tool's A/B, on the card.

    python -m paddle_tpu_torch.ops.cuda_kernels.bottleneck

prints the kernel's max relative error against the library chain (three
bf16 channels-last F.conv2d, the counterpart of the tool's `xla_block`),
single-shot ms and TFLOP/s of both, and ms a block with K_CHAIN blocks
chained. Two kernels take the shapes (`plan`): the tool's shape and its
kin (M = 64, C a multiple of 64 up to 256, W <= 63) run on wgmma and TMA,
every other shape the wrapper takes on mma.sync.
"""
from __future__ import annotations

import ctypes
import functools
import statistics
import subprocess

import torch
import torch.nn.functional as F

from . import _build

# the tool's shape (tools/_rn_pallas_block.py:38) and chain depth (:107)
B, H, W, C, M = 128, 56, 56, 256, 64
K_CHAIN = 10
STRIP = 4          # output rows a block of the mma.sync kernel owns
TILE = 64          # pixels a tile of the wgmma kernel (one m64 product)
SMEM_LIMIT = 232448            # a block's shared memory on sm_90


def plan(shape, sms):
    """How bottleneck_block runs x [B, H, W, C] with M middle channels on a
    card of `sms` SMs: {"route", "grid", "smem", ...}. "wgmma" (M = 64, C a
    multiple of 64 up to 256, W <= 63): a persistent grid of min(sms,
    tiles) blocks walking B ceil(H W / 64) tiles of 64 flat pixels, each
    block holding the weights, a ring of 3 y1 tiles, 4 x atoms ([64
    pixels][64 channels]) and 4 residual / output atoms; "mma_sync" (every
    other shape the wrapper takes): a block a 4-row strip of one image, the
    grid (H / 4, min(B, 65535)), images past 65535 looped over; None where
    a strip's working set is over a block's shared memory (the wrapper
    raises)."""
    Bx, Hx, Wx, Cx, Mx = shape
    if Mx == 64 and Cx % 64 == 0 and 64 <= Cx <= 256 and Wx <= 63:
        tiles = Bx * -(-Hx * Wx // TILE)
        return {"route": "wgmma", "tiles": tiles,
                "grid": max(1, min(sms, tiles)),
                "smem": 1024 + 2 * TILE * 64 * (2 * Cx // 64 + 9 + 3 + 4 + 4)}
    MP, CP = Mx + 8, Cx + 8
    weights = max(Mx * CP + 48 * CP, 9 * Mx * MP, Cx * MP)
    smem = 2 * ((STRIP + 2) * (Wx + 2) * MP + STRIP * Wx * MP + weights)
    if smem > SMEM_LIMIT:
        return None
    return {"route": "mma_sync", "grid": (Hx // STRIP, min(Bx, 65535)),
            "smem": smem}


def bottleneck_block_plain(x, w1, w2, w3):
    """The tool's `kernel` body in PyTorch: x [B, H, W, C] bf16 NHWC, w1
    [C, M], w2 [3, 3, M, M] HWIO, w3 [M, C]; fp32 sums of bf16 operands,
    y1 and y2 rounded to bf16 after their relu, the residual added in
    fp32, the output bf16."""
    Bx, Hx, Wx, Cx = x.shape
    Mx = w1.shape[1]
    f = lambda t: t.float()  # noqa: E731
    y1 = torch.relu(f(x).reshape(-1, Cx) @ f(w1)).to(x.dtype)
    y1p = F.pad(y1.reshape(Bx, Hx, Wx, Mx), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((Bx * Hx * Wx, Mx), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            sh = y1p[:, dy:dy + Hx, dx:dx + Wx, :].reshape(-1, Mx)
            acc += f(sh) @ f(w2[dy, dx])
    y2 = torch.relu(acc).to(x.dtype)
    y3 = (f(y2) @ f(w3)).reshape(x.shape)
    return torch.relu(y3 + f(x)).to(x.dtype)


def library_chain(x, w1, w2, w3):
    """The same chain as three bf16 channels-last F.conv2d with relu and
    the residual add (the tool's `xla_block`). A yardstick only: the port
    never calls it."""
    Mx, Cx = w1.shape[1], w1.shape[0]
    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2)
    k1 = w1.t().reshape(Mx, Cx, 1, 1).contiguous(memory_format=cl)
    k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    k3 = w3.t().reshape(Cx, Mx, 1, 1).contiguous(memory_format=cl)
    y = torch.relu(F.conv2d(xc, k1))
    y = torch.relu(F.conv2d(y, k2, padding=1))
    y = torch.relu(F.conv2d(y, k3) + xc)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _fns():
    c = ctypes
    lib = _build.library("bottleneck_block")
    wg = _build.bind(lib, "bottleneck_block_wg_bf16",
                     [c.c_void_p] * 5 + [c.c_int] * 6 + [c.c_void_p])
    mma = _build.bind(lib, "bottleneck_block_bf16",
                      [c.c_void_p] * 5 + [c.c_int] * 5 + [c.c_void_p])
    return wg, mma


def bottleneck_block(x, w1, w2, w3):
    """x [B, H, W, C] bf16 NHWC, w1 [C, M], w2 [3, 3, M, M], w3 [M, C]
    bf16, all contiguous and 16-byte aligned -> out [B, H, W, C] bf16.
    CUDA tensors launch the kernel `plan` picks (H % 4 == 0, W % 8 == 0, C
    and M multiples of 16, and, off the wgmma route, a strip's working set
    within a block's shared memory), counted by route in
    `bottleneck_block.launches_by_route`; CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return bottleneck_block_plain(x, w1, w2, w3)
    dev = x.device
    for name, t, nd in (("x", x, 4), ("w1", w1, 2), ("w2", w2, 4),
                        ("w3", w3, 2)):
        _build.check(name, t, torch.bfloat16, nd, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"bottleneck_block: {name} must be 16-byte "
                             f"aligned")
    Bx, Hx, Wx, Cx = x.shape
    Mx = w1.shape[1]
    if (w1.shape != (Cx, Mx) or w2.shape != (3, 3, Mx, Mx)
            or w3.shape != (Mx, Cx)):
        raise ValueError(f"bottleneck_block takes w1 [C, M], w2 [3, 3, M, M], "
                         f"w3 [M, C] for x [B, H, W, C]; got x "
                         f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}, w3 {tuple(w3.shape)}")
    p = plan((Bx, Hx, Wx, Cx, Mx), _sms(dev))
    if Cx % 16 or Mx % 16 or Hx % STRIP or Wx % 8 or p is None:
        raise ValueError(f"bottleneck_block takes C and M multiples of 16, "
                         f"H % {STRIP} == 0, W % 8 == 0 and a strip that fits "
                         f"a block's shared memory; got x {tuple(x.shape)}, "
                         f"M={Mx}")
    out = torch.empty_like(x)
    if x.numel():
        wg, mma = _fns()
        args = (x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
                out.data_ptr(), Bx, Hx, Wx, Cx, Mx)
        if p["route"] == "wgmma":
            _build.launch("bottleneck_block", wg, *args, p["grid"],
                          _build.stream_of(x))
        else:
            _build.launch("bottleneck_block", mma, *args, _build.stream_of(x))
        _build.count(bottleneck_block, x.dtype)
        routes = bottleneck_block.launches_by_route
        routes[p["route"]] = routes.get(p["route"], 0) + 1
    return out


bottleneck_block.launches = 0
bottleneck_block.launches_by_dtype = {}
bottleneck_block.launches_by_route = {}


@functools.lru_cache(maxsize=None)
def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def flops(x, w1):
    """2 B H W (C M + 9 M M + M C): the tool's count (:118)."""
    Bx, Hx, Wx, Cx = x.shape
    Mx = w1.shape[1]
    return 2 * Bx * Hx * Wx * (Cx * Mx + 9 * Mx * Mx + Mx * Cx)


def inputs(device, seed=0, shape=(B, H, W, C, M), scale="tool"):
    """bf16 x, w1, w2, w3 from a seeded generator. scale "tool": the
    tool's inputs (:124-131), x * 0.01 and the weights * 0.02, at which the
    residual dominates the output (the whole chain moves it by a few
    percent). scale "unit": x ~ N(0, 1), w1 * sqrt(2 / C), w2 * sqrt(2 / (9
    M)), w3 * sqrt(1 / M), at which each stage moves the output about as
    much as the residual, so a comparison sees the convolutions."""
    Bx, Hx, Wx, Cx, Mx = shape
    ks = {"tool": (0.01, 0.02, 0.02, 0.02),
          "unit": (1.0, (2 / Cx) ** 0.5, (2 / (9 * Mx)) ** 0.5,
                   (1 / Mx) ** 0.5)}[scale]
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s, k: (k * torch.randn(s, generator=g)).to(  # noqa: E731
        device=device, dtype=torch.bfloat16)
    return (r(Bx, Hx, Wx, Cx, k=ks[0]), r(Cx, Mx, k=ks[1]),
            r(3, 3, Mx, Mx, k=ks[2]), r(Mx, Cx, k=ks[3]))


def _events_ms(fn, reps):
    """Median device ms of `fn` over `reps` calls, each between CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def ab(device, reps=30, chain_reps=20):
    """The tool's A/B on the card: returns a dict of the kernel's max
    relative error against the library chain, single-shot ms and TFLOP/s
    of both, and ms a block with K_CHAIN blocks chained, for both."""
    x, w1, w2, w3 = inputs(device)
    fl = flops(x, w1)
    ref = library_chain(x, w1, w2, w3).float()
    got = bottleneck_block(x, w1, w2, w3).float()
    torch.cuda.synchronize()
    err = float((ref - got).abs().max()) / (float(ref.abs().max()) + 1e-6)

    def chain(fn):
        def run():
            c = x
            for _ in range(K_CHAIN):
                c = fn(c, w1, w2, w3)
            return c
        return run

    ms_k = _events_ms(lambda: bottleneck_block(x, w1, w2, w3), reps)
    ms_l = _events_ms(lambda: library_chain(x, w1, w2, w3), reps)
    ch_k = _events_ms(chain(bottleneck_block), chain_reps) / K_CHAIN
    ch_l = _events_ms(chain(library_chain), chain_reps) / K_CHAIN
    return {"max_rel_err": err, "flops": fl, "kernel_ms": ms_k,
            "library_ms": ms_l, "kernel_tflops": fl / ms_k / 1e9,
            "library_tflops": fl / ms_l / 1e9, "chain_kernel_ms": ch_k,
            "chain_library_ms": ch_l}


def main() -> int:
    if not torch.cuda.is_available():
        print("bottleneck_block: no CUDA device")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    r = ab(torch.device("cuda", 0))
    print(f"B={B} {H}x{W} C={C} M={M} bf16 [{card}]")
    print(f"max rel err kernel vs library chain: {r['max_rel_err']:.4f}")
    print("single-shot (one block a call, CUDA events):")
    print(f"  library chain: {r['library_ms']:.4f} ms "
          f"({r['library_tflops']:.1f} TF/s)")
    print(f"  kernel       : {r['kernel_ms']:.4f} ms "
          f"({r['kernel_tflops']:.1f} TF/s)")
    print(f"chained x{K_CHAIN}:")
    print(f"  library chain: {r['chain_library_ms']:.4f} ms/block")
    print(f"  kernel       : {r['chain_kernel_ms']:.4f} ms/block")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
