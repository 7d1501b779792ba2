"""Attention and KV-cache ops (the JAX package's attention_ops.py :183,
:412, :428, :443, :487): fused_attention on K2 forward and K4 backward up
to S = 512 and on K10 / K11 (flash attention) past it, and
the serving path's paged decode attention (K1) and cache writes.

The cache writes update the pool tensors IN PLACE (`index_put_`): the
serving programs name KPoolOut/VPoolOut the same vars as KPool/VPool, and
the executor stores the returned (same) tensors back into the scope. The
JAX package scatters with mode="drop" through an out-of-range sentinel page
to skip masked rows; torch has no drop mode and an out-of-range index on
CUDA is a device fault, so the writes list the kept entries explicitly
(`_write_kept_`).
"""
from __future__ import annotations

import torch

from .cuda_kernels.attention_bwd import attention_backward
from .cuda_kernels.flash_attention import flash_attention_fwd
from .cuda_kernels.flash_attention_bwd import flash_attention_backward
from .cuda_kernels.paged_attention import paged_decode_attention
from .cuda_kernels.prefill_attention import MAX_S, causal_prefill_attention
from .registry import ExecContext, register_grad_compute, register_op


def _fused_attention_inputs(ctx: ExecContext):
    """Q, K, V made contiguous; raises on what is not ported."""
    if ctx.has_input("Bias"):
        raise NotImplementedError(
            "fused_attention with an additive Bias is not ported yet "
            "(ROADMAP Queue 1, WMT encoder-decoder)")
    q, k, v = (ctx.input(s).contiguous() for s in ("Q", "K", "V"))
    if k.shape[2] != q.shape[2]:
        raise NotImplementedError(
            "fused_attention with Sq != Sk is not ported yet "
            "(ROADMAP Queue 1, WMT encoder-decoder)")
    return q, k, v


@register_op("fused_attention")
def fused_attention(ctx: ExecContext):
    """Q, K, V [B, nh, S, dh]; attrs causal, sm_scale -> Out [B, nh, S, dh].
    S <= 512 runs on K2 (the short-sequence kernels' port); S > 512 on K10,
    the port of the bundled flash kernel, whose output and log-sum-exp are
    left in the executor's stash for the grad op (K11 reads both).

    `use_pallas` does not change the kernel. The JAX package takes its
    flash arm past S = 1024, or past S = 512 with `use_pallas`, and only on
    a TPU; at 512 < S <= 1024 without `use_pallas` it takes its XLA arm
    (`_reference_attention`, whose scores are rounded to the operands'
    dtype, bf16 under AMP), where the port takes K10 with fp32 scores."""
    q, k, v = _fused_attention_inputs(ctx)
    causal, scale = ctx.attr("causal", False), ctx.attr("sm_scale", 1.0)
    if q.shape[2] <= MAX_S:
        return {"Out": causal_prefill_attention(q, k, v, causal=causal,
                                                sm_scale=scale)}
    out, lse = flash_attention_fwd(q, k, v, causal, scale)
    if ctx.stash is not None:
        ctx.stash[ctx.op.outputs["Out"][0]] = (out, lse)
    return {"Out": out}


@register_grad_compute("fused_attention")
def fused_attention_grad(ctx: ExecContext):
    """Q, K, V, Out@GRAD -> Q/K/V@GRAD (the JAX grad op's slots). S <= 512:
    K4, which recomputes the softmax. S > 512: K11 on the forward's output
    and log-sum-exp from the stash; where the forward did not run in this
    executor run, K10 runs again to make them. The forward's kernels have
    no autograd graph, so a replay could not do this."""
    q, k, v = _fused_attention_inputs(ctx)
    causal, scale = ctx.attr("causal", False), ctx.attr("sm_scale", 1.0)
    do = ctx.input("Out@GRAD")
    do = torch.zeros_like(q) if do is None else do.contiguous()
    if q.shape[2] <= MAX_S:
        grads = attention_backward(q, k, v, do, causal=causal, sm_scale=scale)
    else:
        out_name = ctx.op.inputs["Out@GRAD"][0][:-len("@GRAD")]
        saved = None if ctx.stash is None else ctx.stash.get(out_name)
        out, lse = (flash_attention_fwd(q, k, v, causal, scale)
                    if saved is None else saved)
        grads = flash_attention_backward(q, k, v, out, lse, do, causal, scale)
    return {s + "@GRAD": g for s, g in zip(("Q", "K", "V"), grads)
            if s + "@GRAD" in ctx.op.outputs}


@register_op("paged_decode_attention")
def paged_decode_attention_op(ctx: ExecContext):
    """Q [B, nh, dh], KPool/VPool [pages, ps, nh, dh], PageTable [B, P],
    Positions [B] (the slot this step's token was appended at: it attends
    slots 0..Positions inclusive, itself included) -> Out [B, nh, dh],
    through the K1 kernel."""
    if ctx.attr("tp_degree", 1) != 1:
        raise NotImplementedError(
            "paged_decode_attention with tp_degree > 1 is not ported yet "
            "(ROADMAP Queue 1, tensor-parallel serving)")
    kv_lens = (ctx.input("Positions").to(torch.int32) + 1).contiguous()
    out = paged_decode_attention(
        ctx.input("Q").contiguous(), ctx.input("KPool"), ctx.input("VPool"),
        ctx.input("PageTable").to(torch.int32).contiguous(), kv_lens,
        sm_scale=ctx.attr("sm_scale", 1.0))
    return {"Out": out}


def _write_kept_(k_pool, v_pool, page_idx, slot, k, v, keep):
    """k_pool/v_pool[page_idx, slot] = k/v at the kept entries only, in
    place. `page_idx`, `slot` and `keep` share their shape; k and v carry
    [nh, dh] more. Entries not kept are left out of the index lists (their
    page ids may be padding that names a live row's page). Listing the kept
    entries (`nonzero`) syncs the host with the device once per call."""
    sel = keep.reshape(-1).nonzero().squeeze(1)
    index = (page_idx.reshape(-1)[sel], slot.reshape(-1)[sel])
    for pool, x in ((k_pool, k), (v_pool, v)):
        pool.index_put_(index, x.reshape((-1,) + tuple(x.shape[-2:]))[sel]
                        .to(pool.dtype))


def kv_cache_append_(k_pool, v_pool, k, v, page_table, positions, live=None):
    """Write one decode step's K/V [B, nh, dh] into the pools in place:
    row b writes slot positions[b] of its table; rows with live[b] == 0
    write nothing. Returns the (same) pools."""
    if k_pool.is_meta:
        return k_pool, v_pool
    ps = k_pool.shape[1]
    P = page_table.shape[1]
    positions = positions.long().reshape(-1)
    page_of = (positions // ps).clamp(0, P - 1)
    page_idx = page_table.long().gather(1, page_of[:, None])[:, 0]
    keep = (live.reshape(-1) > 0 if live is not None
            else torch.ones_like(positions, dtype=torch.bool))
    _write_kept_(k_pool, v_pool, page_idx, positions % ps, k, v, keep)
    return k_pool, v_pool


def kv_cache_prefill_write_(k_pool, v_pool, k, v, page_table, lens):
    """Write a prefill's K/V [B, nh, S, dh] into the pools in place: local
    position s of row b writes slot s when s < lens[b]; bucket padding
    writes nothing. Returns the (same) pools."""
    if k_pool.is_meta:
        return k_pool, v_pool
    B, nh, S, dh = k.shape
    ps = k_pool.shape[1]
    P = page_table.shape[1]
    pos = torch.arange(S, device=k.device)
    keep = pos[None, :] < lens.long().reshape(-1)[:, None]           # [B, S]
    page_of = (pos // ps).clamp(0, P - 1).expand(B, S)
    _write_kept_(k_pool, v_pool, page_table.long().gather(1, page_of),
                 (pos % ps).expand(B, S), k.transpose(1, 2),
                 v.transpose(1, 2), keep)
    return k_pool, v_pool


@register_op("kv_cache_append")
def kv_cache_append_op(ctx: ExecContext):
    """KPool/VPool, K/V [B, nh, dh], PageTable [B, P], Positions [B],
    optional Mask [B, 1] (masked rows write nothing)."""
    live = ctx.input("Mask") if ctx.has_input("Mask") else None
    kp, vp = kv_cache_append_(ctx.input("KPool"), ctx.input("VPool"),
                              ctx.input("K"), ctx.input("V"),
                              ctx.input("PageTable"), ctx.input("Positions"),
                              live)
    return {"KPoolOut": kp, "VPoolOut": vp}


@register_op("kv_cache_prefill_write")
def kv_cache_prefill_write_op(ctx: ExecContext):
    """KPool/VPool, K/V [B, nh, S, dh], PageTable [B, P], Lens [B]."""
    if ctx.has_input("Start"):
        raise NotImplementedError(
            "kv_cache_prefill_write with Start (windowed prefill) is not "
            "ported yet (ROADMAP Queue 1, prefix cache)")
    kp, vp = kv_cache_prefill_write_(ctx.input("KPool"), ctx.input("VPool"),
                                     ctx.input("K"), ctx.input("V"),
                                     ctx.input("PageTable"), ctx.input("Lens"))
    return {"KPoolOut": kp, "VPoolOut": vp}


@register_op("gather_token_logits")
def gather_token_logits_op(ctx: ExecContext):
    """X [B, S, V], Lens [B] -> [B, V]: row b's logits at Lens[b] - 1."""
    x = ctx.input("X")
    idx = (ctx.input("Lens").long() - 1).clamp(0, x.shape[1] - 1)
    return {"Out": x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]}
