"""K6: softmax cross-entropy forward (csrc/softmax_xent_fwd.cu).

Replaces paddle_tpu/ops/pallas_kernels/xent.py `softmax_xent_rows` /
`xent_loss_fwd`: hard-label cross entropy per row of logits [N, V] in one
pass with an online max and sum, emitting the loss and the row statistics
m and lse (logsumexp = m + lse) that K7's saved-stats mode reads.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


def softmax_xent_fwd_plain(logits, labels):
    """Returns (loss, m, lse), each [N] fp32: m = row max, lse = log sum
    exp(x - m), loss = -(x[label] - m - lse); a label outside [0, V) picks
    0, as in the kernel."""
    xf = logits.float()
    m = xf.amax(dim=-1)
    lse = torch.log(torch.exp(xf - m[:, None]).sum(dim=-1))
    V = xf.shape[-1]
    lab = labels.long()
    ok = (lab >= 0) & (lab < V)
    picked = xf.gather(1, lab.clamp(0, V - 1)[:, None])[:, 0]
    picked = torch.where(ok, picked, torch.zeros_like(picked))
    return -(picked - m - lse), m, lse


@functools.lru_cache(maxsize=None)
def _fn():
    c = ctypes
    return _build.bind(_build.library("softmax_xent_fwd"),
                       "softmax_xent_fwd_f32",
                       [c.c_void_p] * 5 + [c.c_int] * 2 + [c.c_void_p])


def softmax_xent_fwd(logits, labels):
    """logits [N, V] fp32, labels [N] int32 -> (loss, m, lse) [N] fp32.
    CUDA tensors launch the kernel; CPU tensors take the plain version;
    meta tensors give the outputs' shapes only."""
    if logits.device.type == "cpu":
        return softmax_xent_fwd_plain(logits, labels)
    N, V = logits.shape
    if logits.device.type == "meta":
        return tuple(torch.empty(N, dtype=torch.float32, device="meta")
                     for _ in range(3))
    dev = logits.device
    _build.check("logits", logits, torch.float32, 2, dev)
    _build.check("labels", labels, torch.int32, 1, dev)
    if labels.shape[0] != N or not V:
        raise ValueError(f"softmax_xent_fwd takes labels [N] for logits "
                         f"[N, V > 0]; got {tuple(labels.shape)}, "
                         f"{tuple(logits.shape)}")
    loss, m, lse = (torch.empty(N, dtype=torch.float32, device=dev)
                    for _ in range(3))
    if N:
        _build.launch("softmax_xent_fwd", _fn(), logits.data_ptr(),
                      labels.data_ptr(), loss.data_ptr(), m.data_ptr(),
                      lse.data_ptr(), N, V, _build.stream_of(logits))
        softmax_xent_fwd.launches += 1
    return loss, m, lse


softmax_xent_fwd.launches = 0
