"""K9: batch-norm apply epilogue, backward (csrc/bn_apply_backward.cu).

Replaces the backward of paddle_tpu/ops/pallas_kernels/epilogue.py:280
`bn_apply_act` (its custom-vjp `_bwd_shared`): z is recomputed from x, the
kernel writes dx (and dres) and the two per-channel sums P1 = sum dz and
P2 = sum dz (x - mean) as partials, which are folded here, outside the
kernel, as the TPU version folds its planes; `bn_param_grads` is the scalar
algebra per channel that turns P1 and P2 into the four parameter gradients.

With `chain`, a function from (P1, P2) to per-channel (ca, cb), the kernel
runs twice in one call: the sums first, then dx = dz inv scale + ca + cb x
in fp32 registers, rounded once (the training backward of the batch
statistics, which bf16 needs unrounded: most of dx cancels in it).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .bn_apply import (ACTS, MODES, param_view, check_names, check_operands)

# "cl": rows a block owns at least (its [C] partial rows are then at most
# 1/16 of dx's bytes each), and the block count aimed at for long inputs
MIN_ROWS_PER_BLOCK = 16
TARGET_BLOCKS = 1024
MAX_ROWS_PER_BLOCK = 256


def bn_apply_act_backward_plain(x2, scale, bias, mean, inv, dy2,
                                act="identity", residual=None, mode="cl",
                                chain=None):
    """Returns (dx [R, row], dres [R, row] or None, P1 [C], P2 [C]) of
    act((x - mean) * (inv * scale) + bias [+ residual]) by the TPU kernel's
    algebra, in fp32, dx and dres rounded to x2's and dy2's dtype; with
    `chain`, dx also carries + ca + cb x, (ca, cb) = chain(P1, P2), before
    its rounding."""
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
    dx = dz * g
    if chain is not None:
        ca, cb = (param_view(t, x2, mode) for t in chain(p1, p2))
        dx = dx + ca + cb * x2.float()
    dres = dz.to(dy2.dtype) if residual is not None else None
    return dx.to(x2.dtype), dres, p1, p2


def bn_param_grads(p1, p2, scale, inv):
    """(dscale, dbias, dmean, dinv) from the two sums, per channel."""
    return p2 * inv, p1, -p1 * inv * scale, p2 * scale


def rows_per_block(R: int) -> int:
    """The strip of rows one "cl" block owns."""
    return max(MIN_ROWS_PER_BLOCK,
               min(MAX_ROWS_PER_BLOCK, -(-R // TARGET_BLOCKS)))


@functools.lru_cache(maxsize=None)
def _fn(sfx):
    c = ctypes
    return _build.bind(_build.library("bn_apply_backward"),
                       f"bn_apply_act_backward_{sfx}",
                       [c.c_void_p] * 13 + [c.c_int] * 6 + [c.c_void_p])


def bn_apply_act_backward(x2, scale, bias, mean, inv, dy2, act="identity",
                          residual=None, mode="cl", chain=None):
    """x2, dy2 (and residual, or None) [R, row] fp32 or bf16 (one dtype),
    scale/bias/mean/inv [C] fp32 -> (dx, dres or None in x2's dtype, P1
    [C], P2 [C] fp32); with `chain`, dx carries the statistics' chain (two
    kernel launches, each counted). CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    act = check_names("bn_apply_act_backward", act, mode)
    if x2.device.type == "cpu":
        return bn_apply_act_backward_plain(x2, scale, bias, mean, inv, dy2,
                                           act, residual, mode, chain)
    if x2.device.type == "meta":
        return (torch.empty_like(x2),
                None if residual is None else torch.empty_like(x2),
                torch.empty_like(scale), torch.empty_like(scale))
    R, row, C, sfx = check_operands(
        "bn_apply_act_backward", x2,
        {"scale": scale, "bias": bias, "mean": mean, "inv": inv},
        {"dy": dy2, "residual": residual}, mode)
    dev = x2.device
    dx = torch.empty_like(x2)
    dres = None if residual is None else torch.empty_like(x2)
    if not (R and row):
        zero = torch.zeros(C, dtype=torch.float32, device=dev)
        return dx, dres, zero, zero.clone()
    rpb = rows_per_block(R)
    pshape = (-(-R // rpb), C) if mode == "cl" else (R // C, C)
    p1 = torch.empty(pshape, dtype=torch.float32, device=dev)
    p2 = torch.empty(pshape, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def run(ca, cb, out, out_res, s1, s2):
        _build.launch("bn_apply_act_backward", _fn(sfx),
                      x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                      mean.data_ptr(), inv.data_ptr(), ptr(residual),
                      dy2.data_ptr(), ptr(ca), ptr(cb), ptr(out),
                      ptr(out_res), ptr(s1), ptr(s2), R, row, C,
                      MODES.index(mode), ACTS.index(act), rpb,
                      _build.stream_of(x2))
        _build.count(bn_apply_act_backward, x2.dtype)

    # the fold of the partials, outside the kernel as on the TPU: over the
    # blocks' planes ("cl"), or over N of the complete row sums ("cr")
    if chain is None:
        run(None, None, dx, dres, p1, p2)
        P1, P2 = p1.sum(dim=0), p2.sum(dim=0)
    else:
        run(None, None, None, None, p1, p2)
        P1, P2 = p1.sum(dim=0), p2.sum(dim=0)
        ca, cb = (t.float().contiguous() for t in chain(P1, P2))
        run(ca, cb, dx, dres, None, None)
    return dx, dres, P1, P2


bn_apply_act_backward.launches = 0
bn_apply_act_backward.launches_by_dtype = {}
