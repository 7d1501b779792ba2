"""K7: softmax cross-entropy backward (csrc/softmax_xent_bwd.cu).

Replaces paddle_tpu/ops/pallas_kernels/xent.py `xent_grad` (row statistics
recomputed from the logits: the program path, whose grad op is given the
logits and no saved statistics) and, when the forward's m and lse are
passed, the backward of `softmax_xent_rows` (its saved-stats mode). The
kernel reads each row of logits from device memory once in both modes (see
the source's header for the widths past which it streams a row twice).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


def softmax_xent_bwd_plain(logits, labels, g, m=None, lse=None):
    """dlogits [N, V] = g * (softmax(logits) - onehot(labels)), with the
    softmax taken from the saved (m, lse) when given."""
    xf = logits.float()
    if m is None:
        mlse = torch.logsumexp(xf, dim=-1)
    else:
        mlse = m.float() + lse.float()
    p = torch.exp(xf - mlse[:, None])
    col = torch.arange(xf.shape[-1], device=xf.device)
    onehot = (col[None, :] == labels.long()[:, None]).float()
    return ((p - onehot) * g.float()[:, None]).to(logits.dtype)


@functools.lru_cache(maxsize=None)
def _fn(sfx):
    c = ctypes
    return _build.bind(_build.library("softmax_xent_bwd"),
                       f"softmax_xent_bwd_{sfx}",
                       [c.c_void_p] * 6 + [c.c_int] * 2 + [c.c_void_p])


def _like_phase(logits):
    """An empty [N, V] tensor like `logits` whose address has the logits'
    phase mod 16, so that the kernel's 16-byte chunks of the two line up
    (an unaligned view of logits gets an offset view of a new buffer)."""
    off = logits.data_ptr() % 16 // logits.element_size()
    if not off:
        return torch.empty_like(logits)
    buf = torch.empty(logits.numel() + off, dtype=logits.dtype,
                      device=logits.device)
    return buf[off:].view(logits.shape)


def softmax_xent_bwd(logits, labels, g, m=None, lse=None):
    """logits [N, V] fp32 or bf16, labels [N] int32, g [N] fp32, optional
    saved m/lse [N] fp32 (both or neither) -> dlogits [N, V] in the logits'
    dtype. CUDA tensors launch the kernel; CPU tensors take the plain
    version; meta tensors give the output's shape only."""
    if (m is None) != (lse is None):
        raise ValueError("softmax_xent_bwd takes both saved m and lse, or "
                         "neither")
    if logits.device.type == "cpu":
        return softmax_xent_bwd_plain(logits, labels, g, m, lse)
    if logits.device.type == "meta":
        return torch.empty_like(logits)
    N, V = logits.shape
    dev = logits.device
    sfx = _build.elem("softmax_xent_bwd", logits)
    _build.check("logits", logits, logits.dtype, 2, dev)
    _build.check("labels", labels, torch.int32, 1, dev)
    _build.check("g", g, torch.float32, 1, dev)
    stats = []
    if m is not None:
        _build.check("m", m, torch.float32, 1, dev)
        _build.check("lse", lse, torch.float32, 1, dev)
        stats = [m, lse]
    if any(t.shape[0] != N for t in [labels, g, *stats]) or not V:
        raise ValueError(f"softmax_xent_bwd takes labels, g (and m, lse) of "
                         f"[N] for logits [N, V > 0]; got logits "
                         f"{tuple(logits.shape)}")
    dx = _like_phase(logits)
    if N:
        _build.launch("softmax_xent_bwd", _fn(sfx), logits.data_ptr(),
                      labels.data_ptr(), g.data_ptr(),
                      m.data_ptr() if m is not None else None,
                      lse.data_ptr() if lse is not None else None,
                      dx.data_ptr(), N, V, _build.stream_of(logits))
        _build.count(softmax_xent_bwd, logits.dtype)
    return dx


softmax_xent_bwd.launches = 0
softmax_xent_bwd.launches_by_dtype = {}
