"""K13: the copy-throughput probe (csrc/dma_probe.cu).

Replaces tools/_attn_dma.py:34 `copy4` and :47 `copy3`: o = 2 x in bf16
(exact) over [B, nh, S, dh] or [B, S, H], `bb` batch items a block, the
block shape the tool sweeps. No model runs it; the module's `main()` is the
tool's table, on the card:

    python -m paddle_tpu_torch.ops.cuda_kernels.dma_probe [iters]

prints ms a call and GB/s (bytes read and written) for the library copy
(x * 2.0) and the kernel in both layouts at bb = 1, 4, 16.
"""
from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from . import _build
from .attn_probe import card_line, events_ms

# the tool's shapes (tools/_attn_dma.py:14) and block sweep (:65, :67)
B, NH, S, DH = 128, 12, 128, 64
BLOCKS = (1, 4, 16)


def dma_copy_plain(x):
    """2 x, in x's dtype."""
    return x * 2.0


@functools.lru_cache(maxsize=None)
def _fn():
    c = ctypes
    return _build.bind(_build.library("dma_probe"), "dma_probe_bf16",
                       [c.c_void_p, c.c_void_p, c.c_int, c.c_longlong,
                        c.c_int, c.c_void_p])


def dma_copy(x, bb=1):
    """x [B, ...] bf16 (rank 3 or 4, B % bb == 0) -> 2 x, a block of the
    kernel copying bb batch items. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return dma_copy_plain(x)
    if x.dim() not in (3, 4):
        raise ValueError(f"dma_copy takes [B, nh, S, dh] or [B, S, H]; got "
                         f"{tuple(x.shape)}")
    _build.check("x", x, torch.bfloat16, x.dim(), x.device)
    item = x[0].numel() if x.shape[0] else 0
    if bb < 1 or x.shape[0] % bb or (bb * item) % 8 or x.data_ptr() % 16:
        raise ValueError(f"dma_copy: bb = {bb} must divide B = {x.shape[0]}, "
                         f"bb * item % 8 == 0, x 16-byte aligned")
    out = torch.empty_like(x)
    _build.launch("dma_copy", _fn(), x.data_ptr(), out.data_ptr(),
                  x.shape[0], item, bb, _build.stream_of(x))
    _build.count(dma_copy, x.dtype)
    return out


dma_copy.launches = 0
dma_copy.launches_by_dtype = {}


def inputs(device, seed=0):
    """The tool's x4 [B, nh, S, dh] and x3 [B, S, nh dh]: two standard
    normal draws from one seeded generator, in bf16."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape))
                 .to(device=device, dtype=torch.bfloat16)
                 for shape in ((B, NH, S, DH), (B, S, NH * DH)))


def table(device, iters=100):
    """[(row name, ms a call, GB/s)] in the tool's order: the library copy,
    then the kernel over [b,nh,S,dh] and [b,S,H] at each bb."""
    x4, x3 = inputs(device)
    gb = 2 * x4.numel() * x4.element_size() / 1e9

    def row(name, fn):
        ms = events_ms(fn, iters)
        return name, ms, gb / (ms / 1e3)

    rows = [row("x * 2.0 (library)", lambda: x4 * 2.0)]
    rows += [row(f"kernel [b,nh,S,dh] bb={bb}", lambda bb=bb: dma_copy(x4, bb))
             for bb in BLOCKS]
    rows += [row(f"kernel [b,S,H] bb={bb}", lambda bb=bb: dma_copy(x3, bb))
             for bb in BLOCKS]
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("dma_copy: no CUDA device")
        return 1
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    print(f"o = 2x, bf16 [{B},{NH},{S},{DH}] and [{B},{S},{NH * DH}], {iters} "
          f"calls a row [{card_line()}]")
    for name, ms, gbs in table(torch.device("cuda", 0), iters):
        print(f"{name:28s} {ms:8.3f} ms   {gbs:7.1f} GB/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
