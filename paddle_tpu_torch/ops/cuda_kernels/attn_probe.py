"""K12: the attention stage probe (csrc/attn_probe.cu).

Replaces tools/_attn_probe.py:29 `make` with its seven bodies (k_copy,
k_qk, k_qk_max, k_softmax, k_full, k_full_bf16sm, k_full_perhead): one
kernel on wgmma templated on the variant (copy a kernel of its own), each
writing what the tool's body writes, over q, k, v [B, nh, S, 64] bf16,
non-causal. No model runs these; the module's `main()` is the tool's
table, on the card:

    python -m paddle_tpu_torch.ops.cuda_kernels.attn_probe [iters]

prints ms a call and us a batch item for the seven variants, then the
library yardsticks (scaled_dot_product_attention for `full`, q + v for
`copy`).
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
import sys

import numpy as np
import torch

from . import _build

# the tool's shape and head group (tools/_attn_probe.py:15-16)
B, NH, S, DH = 128, 12, 128, 64
GH = 12
# variant -> (the kernel's variant code, heads a block), in the tool's order
VARIANTS = {"copy": (0, GH), "qk": (1, GH), "qk_max": (2, GH),
            "softmax": (3, GH), "full": (4, GH), "full_bf16sm": (5, GH),
            "full_perhead": (4, 1)}


def attention_probe_plain(variant, q, k, v, sm):
    """The tool's body `variant` in PyTorch over [B, nh, S, dh] bf16:
    fp32 scores of the bf16 operands times sm, the output rounded to bf16
    at its store (see csrc/attn_probe.cu for each body)."""
    if variant == "copy":
        return q + v
    dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm
    if variant == "qk":
        return s[..., :dh].to(q.dtype)
    m = s.amax(dim=-1, keepdim=True)
    if variant == "qk_max":
        return (s[..., :dh] - m).to(q.dtype)
    if variant == "full_bf16sm":
        p = torch.exp((s - m).to(torch.bfloat16).float()).to(torch.bfloat16)
        l = p.float().sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float())
        return (o / l).to(q.dtype)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if variant == "softmax":
        return (p / l)[..., :dh].to(q.dtype)
    if variant in ("full", "full_perhead"):
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
        return (o / l).to(q.dtype)
    raise ValueError(f"attention_probe: no variant {variant!r}")


@functools.lru_cache(maxsize=None)
def _fn():
    c = ctypes
    return _build.bind(_build.library("attn_probe"), "attn_probe_bf16",
                       [c.c_void_p] * 4 + [c.c_int] * 6
                       + [c.c_float, c.c_void_p])


def attention_probe(variant, q, k, v, sm, heads_per_block=None):
    """q, k, v [B, nh, S, 64] bf16 (S >= 64, nh a multiple of the heads a
    block: the variant's in the tool's mapping, VARIANTS, unless given) ->
    the variant's [B, nh, S, 64] bf16 output. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"attention_probe: no variant {variant!r}")
    if q.device.type == "cpu":
        return attention_probe_plain(variant, q, k, v, sm)
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check(name, t, torch.bfloat16, 4, dev)
        if t.data_ptr() % 16 or t.shape != q.shape:
            raise ValueError(f"attention_probe: {name} must start on a "
                             f"16-byte boundary and have q's shape")
    code, per_block = VARIANTS[variant]
    per_block = heads_per_block or per_block
    b, nh, s, dh = q.shape
    if dh != DH or s < dh or nh % per_block or b > 65535:
        raise ValueError(f"attention_probe takes dh = {DH}, S >= dh, nh a "
                         f"multiple of {per_block}, B <= 65535; got "
                         f"{tuple(q.shape)}")
    out = torch.empty_like(q)
    _build.launch("attention_probe", _fn(), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, nh, s, dh, code,
                  per_block, float(sm), _build.stream_of(q))
    _build.count(attention_probe, q.dtype)
    return out


attention_probe.launches = 0
attention_probe.launches_by_dtype = {}


def inputs(device, seed=0):
    """The tool's q, k, v: three standard normal draws from one seeded
    generator, in bf16."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, NH, S, DH)))
                 .to(device=device, dtype=torch.bfloat16) for _ in range(3))


def events_ms(fn, iters):
    """Device ms a call of `fn` over `iters` calls back to back between two
    CUDA events, after one warm-up call (the tools' protocol: L2 warm)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def table(device, iters=100):
    """[(row name, ms a call)]: the seven variants, then the library
    yardsticks."""
    import torch.nn.functional as F

    q, k, v = inputs(device)
    sm = DH ** -0.5
    rows = [(name, events_ms(lambda n=name: attention_probe(n, q, k, v, sm),
                             iters)) for name in VARIANTS]
    rows.append(("sdpa bf16 (full)", events_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=sm), iters)))
    rows.append(("q + v (copy)", events_ms(lambda: q + v, iters)))
    return rows


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device")
        return 1
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    print(f"B={B} nh={NH} S={S} dh={DH} bf16, {iters} calls a row "
          f"[{card_line()}]")
    for name, ms in table(torch.device("cuda", 0), iters):
        print(f"{name:16s} {ms:8.3f} ms   {ms / B * 1e3:6.2f} us/step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
