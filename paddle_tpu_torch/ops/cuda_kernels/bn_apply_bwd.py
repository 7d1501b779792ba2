"""K9: batch-norm apply epilogue, backward (csrc/bn_apply_backward.cu).

Replaces the backward of paddle_tpu/ops/pallas_kernels/epilogue.py:280
`bn_apply_act` (its custom-vjp `_bwd_shared`): z is recomputed from x, the
kernel writes dx (and dres), sums P1 = sum dz and P2 = sum dz (x - mean)
per channel and folds them on the device into the parameter gradients:
`bn_fold` is that fold's per-channel algebra, whose plain form the plain
version runs.

With `count` (M, the rows a channel), the training backward of the batch
statistics joins dx in the kernel, dx = dz inv scale + ca + cb x in fp32
registers, rounded once (bf16 needs it unrounded: most of dx cancels in
it): the sums, the fold and dx are three phases of one cooperative launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .bn_apply import (ACTS, MODES, param_view, check_names, check_operands)


def bn_param_grads(p1, p2, scale, inv):
    """(dscale, dbias, dmean, dinv) from the two sums, per channel."""
    return p2 * inv, p1, -p1 * inv * scale, p2 * scale


def bn_fold(p1, p2, scale, mean, inv, count=None):
    """(dscale, dbias, ca, cb) per channel from the sums P1 and P2: the
    parameter gradients and, with `count` = M, the coefficients of the
    batch statistics' chain dx += ca + cb x (var = E[x^2] - mean^2, inv =
    (var + eps)^-1/2: dvar = -inv^3 dinv / 2, ca = (dmean - 2 mean dvar) /
    M, cb = 2 dvar / M); without it ca = cb = 0. The kernel's fold computes
    the same in the same order."""
    dscale, dbias, dmean, dinv = bn_param_grads(p1, p2, scale, inv)
    if count is None:
        return dscale, dbias, torch.zeros_like(p1), torch.zeros_like(p1)
    dvar = -0.5 * inv * inv * inv * dinv
    return dscale, dbias, (dmean - 2.0 * mean * dvar) / count, 2.0 * dvar / count


def bn_apply_act_backward_plain(x2, scale, bias, mean, inv, dy2,
                                act="identity", residual=None, mode="cl",
                                count=None):
    """Returns (dx [R, row], dres [R, row] or None, P1, P2, dscale, dbias
    [C]) of act((x - mean) * (inv * scale) + bias [+ residual]) by the TPU
    kernel's algebra, in fp32, dx and dres rounded to x2's and dy2's dtype;
    with `count`, dx also carries the statistics' chain + ca + cb x
    (`bn_fold`) before its rounding."""
    C = scale.shape[0]
    s, b, m, v = (param_view(p, x2, mode) for p in (scale, bias, mean, inv))
    xc = x2.float() - m
    g = v * s
    dz = dy2.float()
    if act == "relu":
        z = xc * g + b
        if residual is not None:
            z = z + residual.float()
        dz = dz * (z > 0).float()
    if mode == "cl":
        p1, p2 = dz.sum(dim=0), (dz * xc).sum(dim=0)
    else:
        p1 = dz.sum(dim=1).reshape(-1, C).sum(dim=0)
        p2 = (dz * xc).sum(dim=1).reshape(-1, C).sum(dim=0)
    dscale, dbias, ca, cb = bn_fold(p1, p2, scale, mean, inv, count)
    dx = dz * g
    if count is not None:
        dx = dx + param_view(ca, x2, mode) + param_view(cb, x2, mode) * x2.float()
    dres = dz.to(dy2.dtype) if residual is not None else None
    return dx.to(x2.dtype), dres, p1, p2, dscale, dbias


@functools.lru_cache(maxsize=None)
def _fns(sfx):
    c = ctypes
    lib = _build.library("bn_apply_backward")
    grid = _build.bind(lib, f"bn_apply_act_backward_grid_{sfx}", [c.c_int] * 3)
    run = _build.bind(lib, f"bn_apply_act_backward_{sfx}",
                      [c.c_void_p] * 12 + [c.c_int] * 5
                      + [c.c_float, c.c_int, c.c_void_p])
    return grid, run


@functools.lru_cache(maxsize=None)
def _grid(sfx, R, C, mode):
    """The kernel's cooperative grid for R rows of C channels in `mode`:
    the blocks the card holds at once (at most two an SM), fewer for few
    rows."""
    return _fns(sfx)[0](R, C, mode)


def bn_apply_act_backward(x2, scale, bias, mean, inv, dy2, act="identity",
                          residual=None, mode="cl", count=None, stamps=None):
    """x2, dy2 (and residual, or None) [R, row] fp32 or bf16 (one dtype),
    scale/bias/mean/inv [C] fp32 -> (dx, dres or None in x2's dtype, P1,
    P2, dscale, dbias [C] fp32); with `count` (M > 0), dx carries the
    statistics' chain (`bn_fold`). One launch, counted, either way. CUDA
    tensors launch the kernel; CPU tensors take the plain version; meta
    tensors give the outputs' shapes only. `stamps` is a diagnostic that
    no model path passes: an int64 CUDA tensor of 4, it gets block 0's
    clock at the kernel's start, after the sums, after the fold (chain
    mode) and at its end, the split of one call's time into its phases
    that chip_smoke.py and flash_ab.py print; with None (the default) the
    kernel only tests the pointer."""
    act = check_names("bn_apply_act_backward", act, mode)
    if x2.device.type == "cpu":
        return bn_apply_act_backward_plain(x2, scale, bias, mean, inv, dy2,
                                           act, residual, mode, count)
    if x2.device.type == "meta":
        return (torch.empty_like(x2),
                None if residual is None else torch.empty_like(x2),
                *(torch.empty_like(scale) for _ in range(4)))
    R, row, C, sfx = check_operands(
        "bn_apply_act_backward", x2,
        {"scale": scale, "bias": bias, "mean": mean, "inv": inv},
        {"dy": dy2, "residual": residual}, mode)
    dev = x2.device
    dx = torch.empty_like(x2)
    dres = None if residual is None else torch.empty_like(x2)
    if not (R and row):
        zero = torch.zeros(4, C, dtype=torch.float32, device=dev)
        return (dx, dres, *zero)
    m = MODES.index(mode)
    grid = _grid(sfx, R, C, m)
    prow = grid if mode == "cl" else R // C
    sums = torch.empty((6, C), dtype=torch.float32, device=dev)
    part = torch.empty(2 * prow * C, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch("bn_apply_act_backward", _fns(sfx)[1],
                  x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  mean.data_ptr(), inv.data_ptr(), ptr(residual),
                  dy2.data_ptr(), dx.data_ptr(), ptr(dres), sums.data_ptr(),
                  part.data_ptr(), ptr(stamps), R, row, C, m,
                  ACTS.index(act), float(count or 0), grid,
                  _build.stream_of(x2))
    _build.count(bn_apply_act_backward, x2.dtype)
    return dx, dres, sums[0], sums[1], sums[2], sums[3]


bn_apply_act_backward.launches = 0
bn_apply_act_backward.launches_by_dtype = {}
