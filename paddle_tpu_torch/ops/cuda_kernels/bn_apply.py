"""K8: batch-norm apply epilogue, forward (csrc/bn_apply.cu).

Replaces the forward of paddle_tpu/ops/pallas_kernels/epilogue.py:280
`bn_apply_act` (body `_apply_fwd_kernel` :91, `pallas_call` :151): given
per-channel statistics, one visit of x computes act((x - mean) * (inv *
scale) + bias [+ residual]) in fp32 registers, x, the residual and y in
fp32 or bf16 and the parameters in fp32, over one of two canonical 2-D
layouts:

  "cl" (NHWC): x2 [R = N*H*W, C], a column's parameters are p[col];
  "cr" (NCHW): x2 [R = N*C, H*W], a row's parameters are p[row % C] (the
               TPU version tiles its parameters to [N*C, 1]; here they stay
               [C]).

What bounds it on the H100: HBM bytes, 2 or 3 R*row*sizeof(T) (x and the
residual read once, y written once) plus the 4 C fp32 parameters; 4 flops
an element. The kernel treats both layouts as one flat stream: element i
of x is of channel (i // inner) % C, inner = 1 ("cl") or H*W ("cr"); each
thread moves 16-byte vectors, several loads in flight before any
arithmetic, over a grid of one wave of resident blocks, whatever the row
length (the source's note has the design). A CUDA tensor always launches
it; a CPU tensor takes `bn_apply_act_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

ACTS = ("identity", "relu")
MODES = ("cl", "cr")


def param_view(p, x2, mode):
    """The [C] parameter p broadcast against x2 in `mode`."""
    C = p.shape[0]
    if mode == "cl":
        return p.float().reshape(1, C)
    return p.float().repeat(x2.shape[0] // C).reshape(-1, 1)


def bn_apply_act_plain(x2, scale, bias, mean, inv, act="identity",
                       residual=None, mode="cl"):
    """The JAX package's `bn_apply_act_reference` over the canonical 2-D
    operands: fp32 math, normalize -> affine -> (+residual) -> act, cast
    back to x2's dtype."""
    s, b, m, v = (param_view(p, x2, mode) for p in (scale, bias, mean, inv))
    z = (x2.float() - m) * (v * s) + b
    if residual is not None:
        z = z + residual.float()
    if act == "relu":
        z = torch.relu(z)
    return z.to(x2.dtype)


def check_operands(what, x2, params, same_shape, mode):
    """The checks K8 and K9 share: x2 and every tensor of `same_shape`
    (name -> tensor or None) contiguous [R, row] CUDA tensors of one dtype,
    fp32 or bf16, the four parameters fp32 [C] with C == row ("cl") or C
    dividing R ("cr"). Returns (R, row, C, the C entry suffix)."""
    dev = x2.device
    sfx = _build.elem(what, x2)
    _build.check("x", x2, x2.dtype, 2, dev)
    R, row = x2.shape
    for name, t in same_shape.items():
        if t is None:
            continue
        _build.check(name, t, x2.dtype, 2, dev)
        if t.shape != x2.shape:
            raise ValueError(f"{what}: {name} must have x's shape "
                             f"{tuple(x2.shape)}, got {tuple(t.shape)}")
    C = params["scale"].shape[0] if params["scale"].dim() == 1 else -1
    for name, p in params.items():
        _build.check(name, p, torch.float32, 1, dev)
        if p.shape[0] != C:
            raise ValueError(f"{what}: {name} must have scale's length {C}, "
                             f"got {tuple(p.shape)}")
    if C < 1 or (mode == "cl" and row != C) or (mode == "cr" and R % C):
        raise ValueError(f"{what}: {C} channels do not fit x {tuple(x2.shape)} "
                         f"in mode {mode!r} ('cl': row == C; 'cr': R % C == 0)")
    if max(R, row) >= 2**31:
        raise ValueError(f"{what}: x {tuple(x2.shape)} is beyond the kernel's "
                         f"32-bit extents")
    return R, row, C, sfx


def check_names(what, act, mode):
    act = act or "identity"
    if act not in ACTS:
        raise ValueError(f"{what} act must be one of {ACTS}, got {act!r}")
    if mode not in MODES:
        raise ValueError(f"{what} mode must be one of {MODES}, got {mode!r}")
    return act


@functools.lru_cache(maxsize=None)
def _fn(sfx):
    c = ctypes
    return _build.bind(_build.library("bn_apply"), f"bn_apply_act_{sfx}",
                       [c.c_void_p] * 7 + [c.c_int] * 5 + [c.c_void_p])


def bn_apply_act(x2, scale, bias, mean, inv, act="identity", residual=None,
                 mode="cl"):
    """x2 (and residual, or None) [R, row] fp32 or bf16, scale/bias/mean/
    inv [C] fp32 -> y [R, row] in x2's dtype. CUDA tensors launch the
    kernel; CPU tensors take the plain version; meta tensors give the
    output's shape only."""
    act = check_names("bn_apply_act", act, mode)
    if x2.device.type == "cpu":
        return bn_apply_act_plain(x2, scale, bias, mean, inv, act, residual,
                                  mode)
    if x2.device.type == "meta":
        return torch.empty_like(x2)
    R, row, C, sfx = check_operands(
        "bn_apply_act", x2,
        {"scale": scale, "bias": bias, "mean": mean, "inv": inv},
        {"residual": residual}, mode)
    y = torch.empty_like(x2)
    if R and row:
        _build.launch("bn_apply_act", _fn(sfx),
                      x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                      mean.data_ptr(), inv.data_ptr(),
                      None if residual is None else residual.data_ptr(),
                      y.data_ptr(), R, row, C, MODES.index(mode),
                      ACTS.index(act), _build.stream_of(x2))
        _build.count(bn_apply_act, x2.dtype)
    return y


bn_apply_act.launches = 0
bn_apply_act.launches_by_dtype = {}
