"""K10: flash-attention forward (csrc/flash_attention.cu).

The forward of the bundled TPU flash-attention kernel that the JAX
package's attention_ops.py:147 `flash_attention` takes past S = 1024 (or
past S = 512 with `use_pallas`): jax's
pallas/ops/tpu/flash_attention.py:589 `_flash_attention_impl`. It returns
the output and the fp32 log-sum-exp of every row, which the backward (K11)
reads in place of the TPU kernel's saved l and m. It takes any S >= 1 (the
TPU kernel wants S % 128 == 0) and dh = 64 or 128; fp32 runs on the CUDA
cores, bf16 on the tensor cores (mma.sync).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIMS = (64, 128)     # the instantiated head widths


def _scores(q, k, causal, sm_scale):
    """fp32 Q K^T * scale over [B, nh, S, dh], -inf above the diagonal if
    causal."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        S = s.shape[-1]
        col = torch.arange(S, device=q.device)
        s = s.masked_fill(col[None, :] > col[:, None], float("-inf"))
    return s


def flash_attention_fwd_plain(q, k, v, causal=False, sm_scale=1.0):
    """(out, lse): softmax(Q K^T * scale) V with fp32 scores and softmax,
    the weights rounded to V's dtype before they multiply V and the product
    divided by the fp32 row sum, out in q's dtype; lse = m + log l, fp32
    [B, nh, S]."""
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


@functools.lru_cache(maxsize=None)
def _fn(sfx):
    c = ctypes
    return _build.bind(_build.library("flash_attention"),
                       f"flash_attention_{sfx}",
                       [c.c_void_p] * 5 + [c.c_int] * 5
                       + [c.c_float, c.c_void_p])


def check_inputs(what, tensors, q):
    """Raise unless every tensor of `tensors` ({name: t}) is a contiguous
    CUDA tensor of q's dtype and shape, 16-byte aligned, and q's shape is
    one the flash kernels take. Returns q's shape."""
    dev = q.device
    for name, t in tensors.items():
        _build.check(name, t, q.dtype, 4, dev)
        if t.data_ptr() % 16:   # the kernels move 4 elements a load
            raise ValueError(f"{what}: {name} must start on a 16-byte "
                             f"boundary")
        if t.shape != q.shape:
            raise ValueError(f"{what} takes tensors of one shape; got {name} "
                             f"{tuple(t.shape)} vs q {tuple(q.shape)}")
    B, nh, S, dh = q.shape
    if S < 1 or dh not in HEAD_DIMS or B > 65535 or nh > 65535:
        raise ValueError(f"{what} takes S >= 1, dh in {HEAD_DIMS}, B and nh "
                         f"<= 65535; got {tuple(q.shape)}")
    return B, nh, S, dh


def flash_attention_fwd(q, k, v, causal=False, sm_scale=1.0):
    """q, k, v [B, nh, S, dh] fp32 or bf16, one dtype (S >= 1, dh 64 or
    128) -> (out [B, nh, S, dh] in q's dtype, lse [B, nh, S] fp32). CUDA
    tensors launch the kernel; CPU tensors take the plain version; meta
    tensors give the outputs' shapes only."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, sm_scale)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return torch.empty_like(q), lse
    sfx = _build.elem("flash_attention_fwd", q)
    B, nh, S, dh = check_inputs("flash_attention_fwd",
                                {"q": q, "k": k, "v": v}, q)
    out = torch.empty_like(q)
    _build.launch("flash_attention_fwd", _fn(sfx), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  B, nh, S, dh, int(bool(causal)), float(sm_scale),
                  _build.stream_of(q))
    _build.count(flash_attention_fwd, q.dtype)
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_dtype = {}
