"""K5: row layer norm + affine + act, backward (csrc/layer_norm_backward.cu).

Replaces the backward of paddle_tpu/ops/pallas_kernels/epilogue.py
`layer_norm_act` (its custom-vjp `vjp_bwd`): dx by recomputing each row's
statistics; dscale and dbias as one partial row for each block of a fixed
grid, which a second kernel of the same source sums over the blocks in a
fixed order (the TPU version sums its partial planes in jnp outside its
kernel), so all three repeat bit for bit. x, dy and dx are fp32 or bf16;
the statistics and the partials fp32.
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
def _fns(sfx):
    c = ctypes
    lib = _build.library("layer_norm_backward")
    blocks = _build.bind(lib, f"layer_norm_act_backward_blocks_{sfx}",
                         [c.c_int] * 3)
    run = _build.bind(lib, f"layer_norm_act_backward_{sfx}",
                      [c.c_void_p] * 8 + [c.c_int] * 2
                      + [c.c_float, c.c_int, c.c_int, c.c_void_p])
    return blocks, run


@functools.lru_cache(maxsize=None)
def _blocks(sfx, R, K, act):
    """The row kernel's grid for (R, K, act): the blocks the card holds at
    once, no more than the rows need; the partials' first dimension."""
    return int(_fns(sfx)[0](R, K, act))


def layer_norm_act_backward(x2, scale, bias, dy, eps=1e-5, act="identity"):
    """x2, dy [R, K] fp32 or bf16 (one dtype), scale/bias [K] fp32 ->
    (dx in x2's dtype, dscale, dbias fp32). CUDA tensors launch the
    kernel; CPU tensors take the plain version; meta tensors give the
    outputs' shapes only."""
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
    sfx = _build.elem("layer_norm_act_backward", x2)
    _build.check("x", x2, x2.dtype, 2, dev)
    _build.check("dy", dy, x2.dtype, 2, dev)
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
    a = ACTS.index(act)
    grid = _blocks(sfx, R, K, a)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(bias)
    part = torch.empty((2, grid, K), dtype=torch.float32, device=dev)
    _build.launch("layer_norm_act_backward", _fns(sfx)[1],
                  x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                  dbias.data_ptr(), part.data_ptr(), R, K, float(eps), a,
                  grid, _build.stream_of(x2))
    _build.count(layer_norm_act_backward, x2.dtype)
    return dx, dscale, dbias


layer_norm_act_backward.launches = 0
layer_norm_act_backward.launches_by_dtype = {}
