"""K5: row layer norm + affine + act, backward (csrc/layer_norm_backward.cu).

Replaces the backward of paddle_tpu/ops/pallas_kernels/epilogue.py
`layer_norm_act` (its custom-vjp `vjp_bwd`): dx by recomputing each row's
statistics, dscale and dbias as per-block partial rows that are summed
here, as the TPU version sums its partial planes outside the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .layer_norm import ACTS, MAX_K


def layer_norm_act_backward_plain(x2, scale, bias, dy, eps=1e-5,
                                  act="identity"):
    """Returns (dx [R, K], dscale [K], dbias [K]) of
    act((x - mean) * rsqrt(var + eps) * scale + bias) over rows of x2, with
    fp32 statistics (the TPU kernel's formula)."""
    xf = x2.float()
    m = xf.mean(dim=-1, keepdim=True)
    xc = xf - m
    r = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xc * r
    sc = scale.float().reshape(1, -1)
    dz = dy.float()
    if act == "relu":
        z = xhat * sc + bias.float().reshape(1, -1)
        dz = dz * (z > 0).float()
    dxhat = dz * sc
    a = dxhat.mean(dim=-1, keepdim=True)
    c = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = r * (dxhat - a - xhat * c)
    return dx.to(x2.dtype), (dz * xhat).sum(dim=0), dz.sum(dim=0)


@functools.lru_cache(maxsize=None)
def _fns():
    c = ctypes
    lib = _build.library("layer_norm_backward")
    rows = _build.bind(lib, "layer_norm_act_backward_rows_per_block", [])
    run = _build.bind(lib, "layer_norm_act_backward_f32",
                      [c.c_void_p] * 7 + [c.c_int] * 2
                      + [c.c_float, c.c_int, c.c_void_p])
    return int(rows()), run


def layer_norm_act_backward(x2, scale, bias, dy, eps=1e-5, act="identity"):
    """x2, dy [R, K] fp32, scale/bias [K] fp32 -> (dx, dscale, dbias).
    CUDA tensors launch the kernel; CPU tensors take the plain version;
    meta tensors give the outputs' shapes only."""
    act = act or "identity"
    if act not in ACTS:
        raise ValueError(f"layer_norm_act_backward act must be one of {ACTS}, "
                         f"got {act!r}")
    if x2.device.type == "cpu":
        return layer_norm_act_backward_plain(x2, scale, bias, dy, eps, act)
    R, K = x2.shape
    if x2.device.type == "meta":
        return (torch.empty_like(x2), torch.empty_like(scale),
                torch.empty_like(scale))
    dev = x2.device
    _build.check("x", x2, torch.float32, 2, dev)
    _build.check("dy", dy, torch.float32, 2, dev)
    _build.check("scale", scale, torch.float32, 1, dev)
    _build.check("bias", bias, torch.float32, 1, dev)
    if (dy.shape != x2.shape or scale.shape[0] != K or bias.shape[0] != K
            or not 1 <= K <= MAX_K):
        raise ValueError(f"layer_norm_act_backward takes K <= {MAX_K}, dy of "
                         f"x's shape and scale/bias of length K; got x "
                         f"{tuple(x2.shape)}, dy {tuple(dy.shape)}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)}")
    dx = torch.empty_like(x2)
    if not R:
        return dx, torch.zeros_like(scale), torch.zeros_like(bias)
    rows, run = _fns()
    nblocks = -(-R // rows)
    ds_part = torch.empty((nblocks, K), dtype=torch.float32, device=dev)
    db_part = torch.empty_like(ds_part)
    _build.launch("layer_norm_act_backward", run,
                  x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  dy.data_ptr(), dx.data_ptr(), ds_part.data_ptr(),
                  db_part.data_ptr(), R, K, float(eps), ACTS.index(act),
                  _build.stream_of(x2))
    layer_norm_act_backward.launches += 1
    # the partials' sum over blocks, as the TPU version's jnp.sum of its
    # per-tile planes: a reduction outside the kernel, not a substitute
    return dx, ds_part.sum(dim=0), db_part.sum(dim=0)


layer_norm_act_backward.launches = 0
