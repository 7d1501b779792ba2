"""K1: ragged paged decode attention (csrc/paged_attention.cu).

Replaces paddle_tpu/ops/pallas_kernels/paged_attention.py:164
`paged_decode_attention`. One query token per request row attends over
that row's pages of the [num_pages, page_size, nh, dh] K/V pool through its
page table; slots >= kv_lens[b] are masked. A kv_len 0 row (scheduler
padding) gets finite output nobody reads: zeros from the kernel, a uniform
average from the plain version (as from the JAX reference).

fp32 and bf16: a bf16 pool is staged as bf16 and widened in the kernel's
dot products, with fp32 softmax statistics and partials and one rounding of
the output; the plain version follows the JAX reference, which rounds the
probabilities to bf16 before they weight V. fp16 raises (ROADMAP Queue 2,
domain item 1).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_NEG_INF = -1e9
_MAX_DH = 128


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, kv_lens,
                                 sm_scale=1.0):
    """Gather-based plain version (the JAX package's
    `_paged_attention_reference`): every row's pages gathered into a dense
    [B, P*ps, nh, dh] view, fp32 softmax, slots past kv_len masked."""
    B, nh, dh = q.shape
    num_pages, ps = k_pool.shape[0], k_pool.shape[1]
    P = page_table.shape[1]
    pt = page_table.long().clamp(0, num_pages - 1)
    k = k_pool[pt].reshape(B, P * ps, nh, dh)
    v = v_pool[pt].reshape(B, P * ps, nh, dh)
    # the product and its scale in q's dtype, as the JAX reference's
    # einsum(...) * sm_scale (the scale rounded to that dtype), then fp32
    scale = torch.tensor(sm_scale, dtype=q.dtype).item()
    s = (torch.einsum("bhd,bkhd->bhk", q, k) * scale).float()
    pos = torch.arange(P * ps, device=q.device)
    s = torch.where(pos[None, None, :] < kv_lens.long()[:, None, None], s,
                    torch.full_like(s, _NEG_INF))
    probs = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", probs.to(q.dtype), v)


@functools.lru_cache(maxsize=None)
def _fns(sfx):
    c = ctypes
    lib = _build.library("paged_attention")
    plan = _build.bind(lib, f"paged_decode_attention_plan_{sfx}",
                       [c.c_int] * 5 + [c.c_void_p])
    run = _build.bind(lib, f"paged_decode_attention_{sfx}",
                      [c.c_void_p] * 7 + [c.c_int] * 11
                      + [c.c_float, c.c_void_p])
    return plan, run


@functools.lru_cache(maxsize=None)
def _plan(B, nh, dh, ps, P, sfx="f32"):
    """(chunk, span, grid, shared memory bytes, heads, blocks an SM) of a
    call's shape and element type (`sfx`, "f32" or "bf16": a bf16 stage
    takes half the bytes): slots staged at once, slots a (row, span) item,
    the cooperative grid (the resident blocks, fewer for fewer items), the
    dynamic shared memory a block, the heads an item (all nh unless a row is
    too wide for shared memory) and the occupancy calculator's resident
    blocks an SM at that shared memory."""
    out = (ctypes.c_int * 6)()
    _build.launch("paged_decode_attention plan", _fns(sfx)[0], B, nh, dh, ps,
                  P, ctypes.addressof(out))
    return tuple(out)


def paged_decode_attention(q, k_pool, v_pool, page_table, kv_lens,
                           sm_scale=1.0):
    """q [B, nh, dh] and pools [num_pages, ps, nh, dh], all fp32 or all
    bf16, page_table [B, P] int32, kv_lens [B] int32 -> [B, nh, dh] in q's
    dtype. CUDA tensors launch the kernel (any other dtype raises); CPU
    tensors take the plain version; meta tensors give the output's shape
    only."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                            kv_lens, sm_scale)
    if q.device.type == "meta":
        return torch.empty_like(q)
    dev = q.device
    if q.dtype not in _build.ELEM:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16, "
                        f"got {q.dtype} (fp16 pools: ROADMAP Queue 2, domain "
                        f"item 1)")
    sfx = _build.ELEM[q.dtype]
    _build.check("q", q, q.dtype, 3, dev)
    _build.check("k_pool", k_pool, q.dtype, 4, dev)
    _build.check("v_pool", v_pool, q.dtype, 4, dev)
    _build.check("page_table", page_table, torch.int32, 2, dev)
    _build.check("kv_lens", kv_lens, torch.int32, 1, dev)
    B, nh, dh = q.shape
    num_pages, ps = k_pool.shape[0], k_pool.shape[1]
    if (tuple(k_pool.shape) != (num_pages, ps, nh, dh)
            or v_pool.shape != k_pool.shape
            or page_table.shape[0] != B or kv_lens.shape[0] != B):
        raise ValueError(
            f"paged_decode_attention shapes disagree: q {tuple(q.shape)}, "
            f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}, page_table "
            f"{tuple(page_table.shape)}, kv_lens {tuple(kv_lens.shape)}")
    if dh > _MAX_DH:
        raise ValueError(f"paged_decode_attention takes dh <= {_MAX_DH}; "
                         f"got dh {dh}")
    out = torch.empty_like(q)
    if B == 0 or nh * dh == 0:
        return out
    P = page_table.shape[1]
    chunk, span, grid, smem, hg = (_plan(B, nh, dh, ps, P, sfx)[:5] if P
                                   else (1, 1, 1, 0, nh))
    spans = -(-P * ps // span)
    part = torch.empty(B * spans * nh * (dh + 2), dtype=torch.float32,
                       device=dev)
    _build.launch("paged_decode_attention", _fns(sfx)[1],
                  q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
                  part.data_ptr(), B, nh, dh, num_pages, ps, P, chunk, span,
                  grid, smem, hg, float(sm_scale), _build.stream_of(q))
    _build.count(paged_decode_attention, q.dtype)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_dtype = {}
