"""K3: row layer norm with affine and activation (csrc/layer_norm.cu).

Replaces the forward of paddle_tpu/ops/pallas_kernels/epilogue.py:421
`layer_norm_act`: each row of x2 [R, K] (fp32 or bf16) normalized over K
with fp32 statistics, then scale, bias (fp32) and an identity or relu act,
y in x2's dtype. The kernel also
writes each row's mean and variance, the layer_norm op's Mean/Variance
outputs, so the op needs no second pass over x.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

ACTS = ("identity", "relu")
MAX_K = 2048


def layer_norm_act_plain(x2, scale, bias, eps=1e-5, act="identity"):
    """Returns (y [R, K], mean [R], var [R]): the JAX package's
    `layer_norm_act_reference` plus the row statistics."""
    xf = x2.float()
    m = xf.mean(dim=-1, keepdim=True)
    var = (xf - m).square().mean(dim=-1, keepdim=True)
    z = (xf - m) * torch.rsqrt(var + eps)
    z = z * scale.float().reshape(1, -1) + bias.float().reshape(1, -1)
    if act == "relu":
        z = torch.relu(z)
    return z.to(x2.dtype), m.reshape(-1), var.reshape(-1)


@functools.lru_cache(maxsize=None)
def _fn(sfx):
    c = ctypes
    return _build.bind(_build.library("layer_norm"), f"layer_norm_act_{sfx}",
                       [c.c_void_p] * 6 + [c.c_int] * 2
                       + [c.c_float, c.c_int, c.c_void_p])


def layer_norm_act(x2, scale, bias, eps=1e-5, act="identity"):
    """x2 [R, K] fp32 or bf16, scale/bias [K] fp32 -> (y in x2's dtype,
    mean, var fp32). CUDA tensors launch the kernel; CPU tensors take the
    plain version; meta tensors give the outputs' shapes only."""
    act = act or "identity"
    if act not in ACTS:
        raise ValueError(f"layer_norm_act act must be one of {ACTS}, got {act!r}")
    if x2.device.type == "cpu":
        return layer_norm_act_plain(x2, scale, bias, eps, act)
    R, K = x2.shape
    if x2.device.type == "meta":
        stat = torch.empty(R, dtype=torch.float32, device="meta")
        return torch.empty_like(x2), stat, stat.clone()
    dev = x2.device
    sfx = _build.elem("layer_norm_act", x2)
    _build.check("x", x2, x2.dtype, 2, dev)
    _build.check("scale", scale, torch.float32, 1, dev)
    _build.check("bias", bias, torch.float32, 1, dev)
    if scale.shape[0] != K or bias.shape[0] != K or not 1 <= K <= MAX_K:
        raise ValueError(f"layer_norm_act takes K <= {MAX_K} and scale/bias "
                         f"of length K; got x {tuple(x2.shape)}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)}")
    y = torch.empty_like(x2)
    mean = torch.empty(R, dtype=torch.float32, device=dev)
    var = torch.empty(R, dtype=torch.float32, device=dev)
    if R:
        _build.launch("layer_norm_act", _fn(sfx),
                      x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                      y.data_ptr(), mean.data_ptr(), var.data_ptr(), R, K,
                      float(eps), ACTS.index(act), _build.stream_of(x2))
        _build.count(layer_norm_act, x2.dtype)
    return y, mean, var


layer_norm_act.launches = 0
layer_norm_act.launches_by_dtype = {}
