"""K2: causal prefill attention (csrc/prefill_attention.cu).

One kernel for the forward of both TPU attention kernels on the prefill
path: paddle_tpu/ops/pallas_kernels/short_attention.py:248
`short128_attention` (S <= 128, optional ragged kv_lens) and
paddle_tpu/ops/pallas_kernels/attention.py:211 `short_seq_attention`
(S % 128 == 0, S <= 512). It takes any S in 1..512 with dh <= 128, so the
pow2 prefill buckets and the dense oracle's arbitrary lengths all run on it:
fp32 on the CUDA cores, bf16 on the tensor cores.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_NEG_INF = -1e30
# clamp floor for the row max: a fully masked row keeps exp(s - m) == 0, so
# l == 0 and the row is emitted as zeros (the short128 kernel's rule)
_M_FLOOR = -0.5e30
MAX_S = 512
_MAX_DH = 128


def takes(shape) -> bool:
    """True where K2 and K4 take q's [B, nh, S, dh]."""
    B, nh, S, dh = shape
    return 1 <= S <= MAX_S and dh % 4 == 0 and dh <= _MAX_DH \
        and B * nh <= 65535


def causal_prefill_attention_plain(q, k, v, causal=True, sm_scale=1.0,
                                   kv_lens=None):
    """softmax(QK^T * scale)V over [B, nh, S, dh] with fp32 scores and
    statistics, an optional causal mask, and key slots >= kv_lens[b]
    masked; a fully masked row emits zeros. As in the TPU kernel, the
    unnormalized weights are cast to V's dtype before they multiply V, the
    product is divided by the fp32 row sum, and the result is cast to q's
    dtype."""
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
    p = torch.exp(s - m)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _fn(sfx):
    c = ctypes
    return _build.bind(_build.library("prefill_attention"),
                       f"causal_prefill_attention_{sfx}",
                       [c.c_void_p] * 5 + [c.c_int] * 5 + [c.c_float, c.c_void_p])


def causal_prefill_attention(q, k, v, causal=True, sm_scale=1.0,
                             kv_lens=None):
    """q, k, v [B, nh, S, dh] fp32 or bf16, one dtype (S <= 512,
    dh % 4 == 0, dh <= 128), optional kv_lens [B] int32 -> [B, nh, S, dh]
    in q's dtype. CUDA tensors launch the kernel; CPU tensors take the
    plain version; meta tensors give the output's shape only."""
    if q.device.type == "cpu":
        return causal_prefill_attention_plain(q, k, v, causal, sm_scale,
                                              kv_lens)
    if q.device.type == "meta":
        return torch.empty_like(q)
    dev = q.device
    sfx = _build.elem("causal_prefill_attention", q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check(name, t, q.dtype, 4, dev)
        if t.data_ptr() % 16:   # the kernel stages tiles 16 bytes a copy
            raise ValueError(f"causal_prefill_attention: {name} must start "
                             f"on a 16-byte boundary")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"causal_prefill_attention takes q, k, v of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, nh, S, dh = q.shape
    if not takes(q.shape):
        raise ValueError(
            f"causal_prefill_attention takes 1 <= S <= {MAX_S}, dh % 4 == 0, "
            f"dh <= {_MAX_DH}, B * nh <= 65535; got {tuple(q.shape)}")
    lens_ptr = None
    if kv_lens is not None:
        _build.check("kv_lens", kv_lens, torch.int32, 1, dev)
        if kv_lens.shape[0] != B:
            raise ValueError(f"kv_lens has {kv_lens.shape[0]} rows, q has {B}")
        lens_ptr = kv_lens.data_ptr()
    out = torch.empty_like(q)
    _build.launch("causal_prefill_attention", _fn(sfx),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_ptr,
                  out.data_ptr(), B, nh, S, dh, int(bool(causal)),
                  float(sm_scale), _build.stream_of(q))
    _build.count(causal_prefill_attention, q.dtype)
    return out


causal_prefill_attention.launches = 0
causal_prefill_attention.launches_by_dtype = {}
