"""K4: attention backward (csrc/attention_backward.cu).

The backward of both TPU attention kernels on the training path:
paddle_tpu/ops/pallas_kernels/short_attention.py `short128_attention` (S
<= 128, optional ragged kv_lens) and paddle_tpu/ops/pallas_kernels/
attention.py `short_seq_attention` (S % 128 == 0, S <= 512). It takes K2's
domain: any S in 1..512, dh % 4 == 0, dh <= 128. Like the TPU kernels it
saves nothing from the forward: the softmax, and with it delta =
rowsum(dP . P), is recomputed from q, k, v. fp32 runs register-tiled
kernels on the CUDA cores, one block a head up to S = 128 with dh <= 64 and
a query-tile and key-tile pair past it (`attention_backward_pair` forces the
pair, to time the two routes at one shape); bf16 runs on the tensor cores,
one block a head up to S = 128 and the pair past it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .prefill_attention import MAX_S, _M_FLOOR, _MAX_DH, _NEG_INF, takes


def attention_backward_plain(q, k, v, do, causal=False, sm_scale=1.0,
                             kv_lens=None):
    """(dq, dk, dv) of softmax(QK^T * scale)V over [B, nh, S, dh], the TPU
    kernels' recompute: masked fp32 scores, fp32 softmax with fully masked
    rows all zero, dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)) *
    scale, dQ = dS K, dK = dS^T Q; in a low-precision dtype P and dS are
    cast to it before they multiply, and so are the outputs, as on the
    TPU."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    S = s.shape[-1]
    col = torch.arange(S, device=q.device)
    neg = torch.full_like(s, _NEG_INF)
    if causal:
        s = torch.where(col[None, None, None, :] <= col[None, None, :, None],
                        s, neg)
    if kv_lens is not None:
        live = col[None, None, None, :] < kv_lens.long()[:, None, None, None]
        s = torch.where(live, s, neg)
    m = s.amax(dim=-1, keepdim=True).clamp_min(_M_FLOOR)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dof = do.float()
    low = lambda t: t.to(q.dtype).float()  # noqa: E731  (identity in fp32)
    dv = torch.einsum("bhqk,bhqd->bhkd", low(p), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = low(p * (dp - delta) * sm_scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _fn(entry):
    c = ctypes
    return _build.bind(_build.library("attention_backward"), entry,
                       [c.c_void_p] * 10 + [c.c_int] * 5
                       + [c.c_float, c.c_void_p])


def attention_backward(q, k, v, do, causal=False, sm_scale=1.0,
                       kv_lens=None):
    """q, k, v, do [B, nh, S, dh] fp32 or bf16, one dtype (S <= 512,
    dh % 4 == 0, dh <= 128), optional kv_lens [B] int32 -> (dq, dk, dv) in
    q's dtype. CUDA tensors launch the kernel; CPU tensors take the plain
    version; meta tensors give the outputs' shapes only."""
    return _backward(q, k, v, do, causal, sm_scale, kv_lens, pair=False)


def attention_backward_pair(q, k, v, do, causal=False, sm_scale=1.0,
                            kv_lens=None):
    """attention_backward with fp32 CUDA tensors always on the query/key
    kernel pair, also where the head kernel would take the shape; bf16 and
    CPU tensors as attention_backward."""
    return _backward(q, k, v, do, causal, sm_scale, kv_lens, pair=True)


def _backward(q, k, v, do, causal, sm_scale, kv_lens, pair):
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, do, causal, sm_scale,
                                        kv_lens)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dev = q.device
    sfx = _build.elem("attention_backward", q)
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _build.check(name, t, q.dtype, 4, dev)
        if t.data_ptr() % 16:   # the kernels stage tiles 16 bytes a copy
            raise ValueError(f"attention_backward: {name} must start on a "
                             f"16-byte boundary")
        if t.shape != q.shape:
            raise ValueError(f"attention_backward takes q, k, v, do of one "
                             f"shape; got {name} {tuple(t.shape)} vs q "
                             f"{tuple(q.shape)}")
    B, nh, S, dh = q.shape
    if not takes(q.shape):
        raise ValueError(
            f"attention_backward takes 1 <= S <= {MAX_S}, dh % 4 == 0, "
            f"dh <= {_MAX_DH}, B * nh <= 65535; got {tuple(q.shape)}")
    lens_ptr = None
    if kv_lens is not None:
        _build.check("kv_lens", kv_lens, torch.int32, 1, dev)
        if kv_lens.shape[0] != B:
            raise ValueError(f"kv_lens has {kv_lens.shape[0]} rows, q has {B}")
        lens_ptr = kv_lens.data_ptr()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # per-row lse and delta, written by the query pass, read by the key pass
    # (past S = 128, or dh > 64 in fp32, where one block no longer holds a
    # head)
    lse = torch.empty((B, nh, S), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse)
    entry = f"attention_backward_{sfx}" + ("_pair" if pair and sfx == "f32"
                                           else "")
    _build.launch("attention_backward", _fn(entry),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lens_ptr, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), B, nh, S, dh,
                  int(bool(causal)), float(sm_scale), _build.stream_of(q))
    _build.count(attention_backward, q.dtype)
    return dq, dk, dv


attention_backward.launches = 0
attention_backward.launches_by_dtype = {}
