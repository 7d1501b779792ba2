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

The split mode serves a batch norm whose statistics span several ranks (a
sync batch norm): `bn_apply_act_backward_sums` launches the sums and the
fold of this rank's rows, the caller sums [P1; P2] over the ranks, and
`bn_apply_act_backward_chain` folds the summed rows with the global M and
writes dx. With one rank the two launches give the one launch's bits. The
one launch stays the route of every batch norm that is not synced.
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


def bn_fold(p1, p2, scale, mean, inv, count=None, extra=None):
    """(dscale, dbias, ca, cb) per channel from the sums P1 and P2: the
    parameter gradients and, with `count` = M, the coefficients of the
    batch statistics' chain dx += ca + cb x (var = E[x^2] - mean^2, inv =
    (var + eps)^-1/2: dvar = -inv^3 dinv / 2, ca = (dmean - 2 mean dvar) /
    M, cb = 2 dvar / M); without it ca = cb = 0. `extra` ([2, C] or None)
    adds cotangents of the statistics outputs to dmean and to dvar
    (`stat_cotangents`). The kernel's fold computes the same in the same
    order."""
    dscale, dbias, dmean, dinv = bn_param_grads(p1, p2, scale, inv)
    if count is None:
        return dscale, dbias, torch.zeros_like(p1), torch.zeros_like(p1)
    dvar = -0.5 * inv * inv * inv * dinv
    if extra is not None:
        dmean, dvar = dmean + extra[0], dvar + extra[1]
    return dscale, dbias, (dmean - 2.0 * mean * dvar) / count, 2.0 * dvar / count


def stat_cotangents(inv, momentum, saved_mean=None, saved_inv=None,
                    mean_out=None, var_out=None):
    """The [2, C] `extra` of `bn_fold` from the cotangents of a training
    batch norm's statistics outputs (None where an output has none):
    SavedMean is the batch mean, SavedVariance its inv, MeanOut and
    VarianceOut move by 1 - momentum of the batch mean and variance. None
    where every cotangent is None."""
    if all(g is None for g in (saved_mean, saved_inv, mean_out, var_out)):
        return None
    dm = torch.zeros_like(inv)
    dv = torch.zeros_like(inv)
    if saved_mean is not None:
        dm = dm + saved_mean.float()
    if mean_out is not None:
        dm = dm + (1.0 - momentum) * mean_out.float()
    if saved_inv is not None:
        dv = dv - 0.5 * inv * inv * inv * saved_inv.float()
    if var_out is not None:
        dv = dv + (1.0 - momentum) * var_out.float()
    return torch.stack([dm, dv]).contiguous()


def _plain_dz(x2, scale, bias, mean, inv, dy2, act, residual, mode):
    """(dz, x - mean, inv * scale) in fp32, viewed per channel."""
    s, b, m, v = (param_view(p, x2, mode) for p in (scale, bias, mean, inv))
    xc = x2.float() - m
    g = v * s
    dz = dy2.float()
    if act == "relu":
        z = xc * g + b
        if residual is not None:
            z = z + residual.float()
        dz = dz * (z > 0).float()
    return dz, xc, g


def _plain_sums(dz, xc, mode, C):
    if mode == "cl":
        return dz.sum(dim=0), (dz * xc).sum(dim=0)
    return (dz.sum(dim=1).reshape(-1, C).sum(dim=0),
            (dz * xc).sum(dim=1).reshape(-1, C).sum(dim=0))


def _plain_grads(x2, dy2, dz, g, residual, mode, p1, p2, scale, mean, inv,
                 count, extra):
    dscale, dbias, ca, cb = bn_fold(p1, p2, scale, mean, inv, count, extra)
    dx = dz * g
    if count is not None:
        dx = dx + param_view(ca, x2, mode) + param_view(cb, x2, mode) * x2.float()
    dres = dz.to(dy2.dtype) if residual is not None else None
    return dx.to(x2.dtype), dres, p1, p2, dscale, dbias


def bn_apply_act_backward_plain(x2, scale, bias, mean, inv, dy2,
                                act="identity", residual=None, mode="cl",
                                count=None, extra=None):
    """Returns (dx [R, row], dres [R, row] or None, P1, P2, dscale, dbias
    [C]) of act((x - mean) * (inv * scale) + bias [+ residual]) by the TPU
    kernel's algebra, in fp32, dx and dres rounded to x2's and dy2's dtype;
    with `count`, dx also carries the statistics' chain + ca + cb x
    (`bn_fold`, with `extra`) before its rounding."""
    dz, xc, g = _plain_dz(x2, scale, bias, mean, inv, dy2, act, residual, mode)
    p1, p2 = _plain_sums(dz, xc, mode, scale.shape[0])
    return _plain_grads(x2, dy2, dz, g, residual, mode, p1, p2, scale, mean,
                        inv, count, extra)


def bn_apply_act_backward_sums_plain(x2, scale, bias, mean, inv, dy2,
                                     act="identity", residual=None,
                                     mode="cl"):
    """The split mode's first launch, plainly: [6, C] fp32 rows P1, P2,
    dscale, dbias of these rows, then two rows of zeros."""
    dz, xc, _ = _plain_dz(x2, scale, bias, mean, inv, dy2, act, residual,
                          mode)
    p1, p2 = _plain_sums(dz, xc, mode, scale.shape[0])
    dscale, dbias, ca, cb = bn_fold(p1, p2, scale, mean, inv)
    return torch.stack([p1, p2, dscale, dbias, ca, cb])


def bn_apply_act_backward_chain_plain(x2, scale, bias, mean, inv, dy2, sums,
                                      count, act="identity", residual=None,
                                      mode="cl", extra=None):
    """The split mode's second launch, plainly: the outputs of
    `bn_apply_act_backward_plain` with P1 and P2 taken from `sums` [2, C]
    (summed over the ranks) and `count` the global M."""
    dz, _, g = _plain_dz(x2, scale, bias, mean, inv, dy2, act, residual, mode)
    return _plain_grads(x2, dy2, dz, g, residual, mode, sums[0], sums[1],
                        scale, mean, inv, count, extra)


@functools.lru_cache(maxsize=None)
def _fns(sfx):
    c = ctypes
    lib = _build.library("bn_apply_backward")
    grid = _build.bind(lib, f"bn_apply_act_backward_grid_{sfx}", [c.c_int] * 3)
    run = _build.bind(lib, f"bn_apply_act_backward_{sfx}",
                      [c.c_void_p] * 12 + [c.c_int] * 5
                      + [c.c_float, c.c_int, c.c_void_p, c.c_int, c.c_void_p])
    return grid, run


@functools.lru_cache(maxsize=None)
def _grid(sfx, R, C, mode):
    """The kernel's cooperative grid for R rows of C channels in `mode`:
    the blocks the card holds at once (at most two an SM), fewer for few
    rows."""
    return _fns(sfx)[0](R, C, mode)


def _launch(phase, x2, scale, bias, mean, inv, dy2, act, residual, mode,
            count, sums=None, extra=None, stamps=None):
    """One launch of the kernel in `phase` (0 the one launch, 1 the sums, 2
    the chain from `sums`) on CUDA tensors: (dx or None, dres or None, the
    [6, C] fp32 P1, P2, dscale, dbias, ca, cb)."""
    R, row, C, sfx = check_operands(
        "bn_apply_act_backward", x2,
        {"scale": scale, "bias": bias, "mean": mean, "inv": inv},
        {"dy": dy2, "residual": residual}, mode)
    dev = x2.device
    for name, t in (("sums", sums), ("extra", extra)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != (2, C)
                              or not t.is_contiguous()):
            raise ValueError(f"bn_apply_act_backward: {name} must be a "
                             f"contiguous fp32 [2, {C}] tensor on {dev}")
    dx = None if phase == 1 else torch.empty_like(x2)
    dres = None if residual is None or phase == 1 else torch.empty_like(x2)
    if not (R and row):
        return dx, dres, torch.zeros(6, C, dtype=torch.float32, device=dev)
    m = MODES.index(mode)
    grid = _grid(sfx, R, C, m)
    prow = grid if mode == "cl" else R // C
    out = torch.empty((6, C), dtype=torch.float32, device=dev)
    part = (sums if phase == 2 else
            torch.empty(2 * prow * C, dtype=torch.float32, device=dev))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch("bn_apply_act_backward", _fns(sfx)[1],
                  x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  mean.data_ptr(), inv.data_ptr(), ptr(residual),
                  dy2.data_ptr(), ptr(dx), ptr(dres), out.data_ptr(),
                  part.data_ptr(), ptr(stamps), R, row, C, m,
                  ACTS.index(act), float(count or 0), phase, ptr(extra), grid,
                  _build.stream_of(x2))
    return dx, dres, out


def bn_apply_act_backward(x2, scale, bias, mean, inv, dy2, act="identity",
                          residual=None, mode="cl", count=None, stamps=None,
                          extra=None):
    """x2, dy2 (and residual, or None) [R, row] fp32 or bf16 (one dtype),
    scale/bias/mean/inv [C] fp32 -> (dx, dres or None in x2's dtype, P1,
    P2, dscale, dbias [C] fp32); with `count` (M > 0), dx carries the
    statistics' chain (`bn_fold`, with `extra`: the [2, C] of
    `stat_cotangents`, or None). One launch, counted, either way. CUDA
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
                                           act, residual, mode, count, extra)
    if x2.device.type == "meta":
        return (torch.empty_like(x2),
                None if residual is None else torch.empty_like(x2),
                *(torch.empty_like(scale) for _ in range(4)))
    dx, dres, out = _launch(0, x2, scale, bias, mean, inv, dy2, act, residual,
                            mode, count, extra=extra, stamps=stamps)
    _build.count(bn_apply_act_backward, x2.dtype)
    return dx, dres, out[0], out[1], out[2], out[3]


def bn_apply_act_backward_sums(x2, scale, bias, mean, inv, dy2,
                               act="identity", residual=None, mode="cl"):
    """The split mode's first launch: [6, C] fp32, rows P1, P2, dscale and
    dbias of this call's rows (then two rows of zeros); no dx. The caller
    sums rows [:2] over the ranks and passes them to
    `bn_apply_act_backward_chain`. One launch, counted; CPU tensors take the
    plain version; meta tensors give the shape."""
    act = check_names("bn_apply_act_backward_sums", act, mode)
    if x2.device.type == "cpu":
        return bn_apply_act_backward_sums_plain(x2, scale, bias, mean, inv,
                                                dy2, act, residual, mode)
    if x2.device.type == "meta":
        return torch.empty((6, scale.shape[0]), dtype=torch.float32,
                           device="meta")
    out = _launch(1, x2, scale, bias, mean, inv, dy2, act, residual, mode,
                  None)[2]
    _build.count(bn_apply_act_backward_sums, x2.dtype)
    return out


def bn_apply_act_backward_chain(x2, scale, bias, mean, inv, dy2, sums, count,
                                act="identity", residual=None, mode="cl",
                                extra=None):
    """The split mode's second launch: the outputs of
    `bn_apply_act_backward` with the statistics' chain, from `sums` ([2, C]
    fp32: P1 and P2 summed over the ranks) and `count` (the global M > 0)
    in place of this call's own sums; dscale and dbias are the global ones.
    One launch, counted; CPU tensors take the plain version."""
    act = check_names("bn_apply_act_backward_chain", act, mode)
    if not count or count <= 0:
        raise ValueError("bn_apply_act_backward_chain: count must be the "
                         "global rows a channel (> 0)")
    if x2.device.type == "cpu":
        return bn_apply_act_backward_chain_plain(x2, scale, bias, mean, inv,
                                                 dy2, sums, count, act,
                                                 residual, mode, extra)
    if x2.device.type == "meta":
        return (torch.empty_like(x2),
                None if residual is None else torch.empty_like(x2),
                *(torch.empty_like(scale) for _ in range(4)))
    dx, dres, out = _launch(2, x2, scale, bias, mean, inv, dy2, act, residual,
                            mode, count, sums=sums, extra=extra)
    _build.count(bn_apply_act_backward_chain, x2.dtype)
    return dx, dres, out[0], out[1], out[2], out[3]


for _fn in (bn_apply_act_backward, bn_apply_act_backward_sums,
            bn_apply_act_backward_chain):
    _fn.launches = 0
    _fn.launches_by_dtype = {}
