"""K11: flash-attention backward (csrc/flash_attention_backward.cu).

The backward of the bundled TPU flash-attention kernel (the JAX package's
`flash_bundled` arm): jax's pallas/ops/tpu/flash_attention.py
`_flash_attention_bwd` (:254), `_flash_attention_bwd_dkv` (:941) and
`_flash_attention_bwd_dq` (:1287). Unlike K4 it is handed the forward's
output O and log-sum-exp (K10's), and takes di = rowsum(O . dO) from the
rounded O, as the TPU kernel does (:274). Any S >= 1, dh = 64 or 128;
fp32 on the CUDA cores, bf16 on the tensor cores (mma.sync).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import _scores, check_inputs


def flash_attention_backward_plain(q, k, v, o, lse, do, causal=False,
                                   sm_scale=1.0):
    """(dq, dk, dv) of softmax(Q K^T * scale) V over [B, nh, S, dh] from the
    forward's o and lse [B, nh, S]: P = exp(fp32 scores - lse), di =
    rowsum(o . do) in fp32, dV = P^T dO, dS = (dO V^T - di) P * scale, dQ =
    dS K, dK = dS^T Q; in a low-precision dtype P and dS are cast to it
    before they multiply, and so are the outputs, as in the TPU kernel."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dof = do.float()
    di = (o.float() * dof).sum(dim=-1, keepdim=True)
    low = lambda t: t.to(q.dtype).float()  # noqa: E731  (identity in fp32)
    dv = torch.einsum("bhqk,bhqd->bhkd", low(p), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = low((dp - di) * p * sm_scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _fn(sfx):
    c = ctypes
    return _build.bind(_build.library("flash_attention_backward"),
                       f"flash_attention_backward_{sfx}",
                       [c.c_void_p] * 10 + [c.c_int] * 5
                       + [c.c_float, c.c_void_p])


def flash_attention_backward(q, k, v, o, lse, do, causal=False,
                             sm_scale=1.0):
    """q, k, v, o, do [B, nh, S, dh] fp32 or bf16, one dtype (S >= 1, dh 64
    or 128), lse [B, nh, S] fp32 (from K10) -> (dq, dk, dv) in q's dtype.
    CUDA tensors launch the kernel; CPU tensors take the plain version; meta
    tensors give the outputs' shapes only."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal,
                                              sm_scale)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    sfx = _build.elem("flash_attention_backward", q)
    B, nh, S, dh = check_inputs("flash_attention_backward",
                                {"q": q, "k": k, "v": v, "o": o, "do": do}, q)
    _build.check("lse", lse, torch.float32, 3, q.device)
    if lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_backward: lse {tuple(lse.shape)} "
                         f"is not [B, nh, S] of q {tuple(q.shape)}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # rowsum(o . do), written by the query pass, read by the key pass
    di = torch.empty_like(lse)
    _build.launch("flash_attention_backward", _fn(sfx),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), di.data_ptr(), B, nh, S, dh,
                  int(bool(causal)), float(sm_scale), _build.stream_of(q))
    _build.count(flash_attention_backward, q.dtype)
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.launches_by_dtype = {}
