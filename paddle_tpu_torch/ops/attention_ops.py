"""Attention and KV-cache ops (the JAX package's attention_ops.py :183,
:412, :428, :443, :458, :472, :487): fused_attention on K2 forward and K4
backward or on K10 / K11 (flash attention), the route resolved per shape
through the tuner (`attention_backend`; with a Bias or Sq != Sk, the torch
composition of the JAX package's XLA arm), and
ring attention over a sequence split across a ring's ranks (blockwise, the
block products in torch, as the JAX package computes them in einsums),
the serving path's paged decode attention (K1), its windowed attention
over the pool (`paged_prefill_attention`: an XLA gather composition in the
JAX package, so a torch composition here), the cache writes and the
copy-on-write page copy.

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

from .. import flags, tuning
from .cuda_kernels.attention_bwd import attention_backward
from .cuda_kernels.flash_attention import HEAD_DIMS, flash_attention_fwd
from .cuda_kernels.flash_attention import takes as flash_takes
from .cuda_kernels.flash_attention_bwd import flash_attention_backward
from .cuda_kernels.paged_attention import paged_decode_attention
from .cuda_kernels.prefill_attention import MAX_S, causal_prefill_attention
from .cuda_kernels.prefill_attention import takes as short_takes
from .math_ops import rounded
from .registry import (ExecContext, register_grad_compute, register_op,
                       under_autograd)


# The JAX package computes a biased attention, or one with Sq != Sk, in
# its XLA arm (`_reference_attention`): every short-sequence TPU kernel
# refuses both. It does so up to S = 1024, or 512 with `use_pallas`; past
# that it takes the bundled flash kernel with its bias, which K10/K11 lack.
COMPOSED_MAX_S = {False: 1024, True: 512}


def _composed(ctx: ExecContext) -> bool:
    """True when the op takes the torch composition of the JAX package's
    XLA arm (a Bias, or Sq != Sk); raises past that arm's lengths."""
    q, k = ctx.input("Q"), ctx.input("K")
    if not ctx.has_input("Bias") and q.shape[2] == k.shape[2]:
        return False
    limit = COMPOSED_MAX_S[bool(ctx.attr("use_pallas", False))]
    if max(q.shape[2], k.shape[2]) > limit:
        raise NotImplementedError(
            f"fused_attention with a Bias or Sq != Sk past S = {limit} needs "
            f"the flash kernels' additive bias, which K10/K11 lack (ROADMAP "
            f"Queue 2, domain item 5)")
    return True


# The JAX package's attention lever names its arms; the port keeps the
# names (DB files, store rows and learned models stay interchangeable) and
# runs each on a pair of hand kernels: the short-sequence kernels' port
# K2/K4 ("pallas_short", and "pallas_short128", the JAX package's S <= 128
# kernel), the bundled flash kernel's K10/K11 ("flash_bundled"). It has no
# arm for "xla" on an unbiased Sq = Sk attention.
SHORT_ROUTES = ("pallas_short", "pallas_short128")
FLASH_ROUTE = "flash_bundled"


def runnable(backend, q_shape) -> bool:
    """True where the hand kernels of `backend` take Q's [B, nh, S, dh]
    (the predicate their wrappers check)."""
    if backend in SHORT_ROUTES:
        return short_takes(q_shape)
    if backend == FLASH_ROUTE:
        return flash_takes(q_shape)
    return False


def _prior(q_shape) -> str:
    """The analytic prior: K2/K4 up to S = 512, K10/K11 past it."""
    return SHORT_ROUTES[0] if q_shape[2] <= MAX_S else FLASH_ROUTE


def attention_backend(q_shape, dtype, causal=False, device=None):
    """(backend, tier): which pair of hand kernels carries an unbiased
    attention of Q's shape [B, nh, S, dh] (Sq = Sk) on `device`, the JAX
    package's attention_ops.py:89 lever. FLAGS_attention_force_backend
    comes before every tier and raises, naming the flag, where the port
    cannot run the forced arm; then, under FLAGS_tuning_mode consult or
    explore, an exact DB hit, the learned tier, the analytic prior (K2/K4
    up to S = 512, K10/K11 past it). A DB or learned verdict the port
    cannot run at this shape ("xla", or K2/K4 past S = 512) is refused by
    `validate` and falls through to the prior: there is no plain route for
    a CUDA tensor."""
    forced = str(flags.get_flag("attention_force_backend")).strip()
    if forced:
        if not runnable(forced, q_shape):
            raise ValueError(
                f"FLAGS_attention_force_backend={forced!r}: the port runs no "
                f"hand kernel of that arm for Q {tuple(q_shape)}; it runs "
                f"{SHORT_ROUTES} (K2/K4, S <= {MAX_S}) and {FLASH_ROUTE!r} "
                f"(K10/K11, dh in {HEAD_DIMS})")
        return forced, "forced"
    prior = {"backend": _prior(q_shape)}
    if tuning.mode() == "off":
        return prior["backend"], "analytic"
    B, nh, S, dh = q_shape
    key = tuning.canonical_key(
        "attention", tuning.attention_key(B, nh, S, S, dh, causal),
        str(dtype).replace("torch.", ""), tuning.device_kind(device))
    decision, tier = tuning.decide(
        "attention", key, prior=lambda: prior, default=prior,
        validate=lambda d: runnable(d.get("backend"), q_shape))
    return decision["backend"], tier


def _route(ctx: ExecContext, q, causal) -> str:
    """This op's backend, resolved once per (shape, causal, dtype, device)
    in the prepared program (`ctx.decisions`) at its first use there and
    read from the record after: the grad op and the replays through
    `_AttentionFn` take the route their forward took and never consult
    again. Shape inference consults nothing (the prior)."""
    if ctx.is_meta:
        return _prior(q.shape)
    key = ("attention", tuple(q.shape), bool(causal), q.dtype, q.device)
    decisions = ctx.decisions if ctx.decisions is not None else {}
    if key not in decisions:
        decisions[key] = attention_backend(tuple(q.shape), q.dtype, causal,
                                           q.device)[0]
    return decisions[key]


def reference_attention(q, k, v, bias=None, causal=False, sm_scale=1.0):
    """The JAX package's `_reference_attention` in torch: scores in the
    operands' dtype, then an fp32 softmax (a bias added in fp32, the
    causal mask aligned to the last key, tril(Sk - Sq)), the
    probabilities cast back to the operands' dtype before they weight V."""
    scores = (torch.matmul(q, k.transpose(-1, -2))
              * rounded(sm_scale, q.dtype)).float()
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        sq, sk = scores.shape[-2:]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~keep, -1e9)
    return torch.matmul(torch.softmax(scores, dim=-1).to(q.dtype), v)


def _composed_args(ctx: ExecContext):
    bias = ctx.input("Bias") if ctx.has_input("Bias") else None
    return (ctx.input("Q"), ctx.input("K"), ctx.input("V"), bias,
            ctx.attr("causal", False), ctx.attr("sm_scale", 1.0))


@register_op("fused_attention")
def fused_attention(ctx: ExecContext):
    """Q [B, nh, Sq, dh], K and V [B, nh, Sk, dh], optional Bias
    (broadcastable to [B, nh, Sq, Sk]); attrs causal, sm_scale -> Out
    [B, nh, Sq, dh]. Without a Bias and with Sq == Sk = S: the route
    `_route` resolves (by default S <= 512 on K2, the short-sequence
    kernels' port, S > 512 on K10, the port of the bundled flash kernel,
    whose output and log-sum-exp are left in the executor's stash for the
    grad op: K11 reads both). With a Bias or
    Sq != Sk: the torch composition of the JAX package's XLA arm
    (`reference_attention`), which is where the JAX package computes them.

    `use_pallas` does not change the kernel. The JAX package takes its
    flash arm past S = 1024, or past S = 512 with `use_pallas`, and only on
    a TPU; at 512 < S <= 1024 without `use_pallas` it takes its XLA arm
    (`_reference_attention`, whose scores are rounded to the operands'
    dtype, bf16 under AMP), where the port takes K10 with fp32 scores.
    Inside a replayed grad (a recompute segment) the kernels run through
    `_AttentionFn`, whose backward is the registered grad's K4 or K11."""
    if _composed(ctx):
        return {"Out": reference_attention(*_composed_args(ctx))}
    q, k, v = (ctx.input(s).contiguous() for s in ("Q", "K", "V"))
    causal, scale = ctx.attr("causal", False), ctx.attr("sm_scale", 1.0)
    route = _route(ctx, q, causal)
    if under_autograd(q, k, v):
        return {"Out": _AttentionFn.apply(q, k, v, causal, scale, route)}
    if route in SHORT_ROUTES:
        return {"Out": causal_prefill_attention(q, k, v, causal=causal,
                                                sm_scale=scale)}
    out, lse = flash_attention_fwd(q, k, v, causal, scale)
    if ctx.stash is not None:
        ctx.stash[ctx.op.outputs["Out"][0]] = (out, lse)
    return {"Out": out}


def _attention_grads(q, k, v, do, causal, scale, route, saved=None):
    """(dq, dk, dv): on K4 where `route` is K2/K4's, which recomputes the
    softmax; else on K11 from the forward's (output, log-sum-exp), `saved`,
    or from K10 run again where there are none."""
    if route in SHORT_ROUTES:
        return attention_backward(q, k, v, do, causal=causal, sm_scale=scale)
    out, lse = flash_attention_fwd(q, k, v, causal, scale) if saved is None else saved
    return flash_attention_backward(q, k, v, out, lse, do, causal, scale)


class _AttentionFn(torch.autograd.Function):
    """The kernels' attention inside a replayed grad, on `route`'s pair: K2
    or K10 forward, and as backward `_attention_grads`, the registered
    grad's K4 or K11 (K11 on the output and log-sum-exp saved here)."""

    @staticmethod
    def forward(fctx, q, k, v, causal, scale, route):
        fctx.causal, fctx.scale, fctx.route = causal, scale, route
        if route in SHORT_ROUTES:
            fctx.save_for_backward(q, k, v)
            return causal_prefill_attention(q, k, v, causal=causal,
                                            sm_scale=scale)
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        fctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(fctx, do):
        q, k, v, *saved = fctx.saved_tensors
        grads = _attention_grads(q, k, v, do.contiguous(), fctx.causal,
                                 fctx.scale, fctx.route, tuple(saved) or None)
        return (*grads, None, None, None)


def _composed_grad(ctx: ExecContext, do):
    """The grads the op asks for, by autograd through the composition."""
    args = list(_composed_args(ctx))
    wanted = [i for i, s in enumerate(("Q", "K", "V", "Bias"))
              if s + "@GRAD" in ctx.op.outputs]
    for i in wanted:
        args[i] = args[i].detach().requires_grad_(True)
    with torch.enable_grad():
        out = reference_attention(*args)
    grads = torch.autograd.grad(out, [args[i] for i in wanted], do)
    return {("Q", "K", "V", "Bias")[i] + "@GRAD": g
            for i, g in zip(wanted, grads)}


@register_grad_compute("fused_attention")
def fused_attention_grad(ctx: ExecContext):
    """Q, K, V, Out@GRAD -> Q/K/V@GRAD (the JAX grad op's slots) through
    `_attention_grads` on the route the forward took (`_route`): K4, or K11
    on the forward's output and log-sum-exp from the stash (K10 again where
    the forward did not run in this executor run). A Bias or Sq != Sk:
    autograd through the composition (and Bias@GRAD where asked)."""
    do = ctx.input("Out@GRAD")
    do = torch.zeros_like(ctx.input("Q")) if do is None else do.contiguous()
    if _composed(ctx):
        return _composed_grad(ctx, do)
    q, k, v = (ctx.input(s).contiguous() for s in ("Q", "K", "V"))
    causal = ctx.attr("causal", False)
    route = _route(ctx, q, causal)
    saved = None
    if route == FLASH_ROUTE and ctx.stash is not None:
        saved = ctx.stash.get(ctx.op.inputs["Out@GRAD"][0][:-len("@GRAD")])
    grads = _attention_grads(q, k, v, do, causal, ctx.attr("sm_scale", 1.0),
                             route, saved)
    return {s + "@GRAD": g for s, g in zip(("Q", "K", "V"), grads)
            if s + "@GRAD" in ctx.op.outputs}


def _shard_paged_shapes(q_shape, pool_shape, tp=1):
    """The per-shard view of a paged decode shape under tp-way head
    sharding (the JAX package's attention_ops.py:208): nh / tp heads of
    the query and of the pool."""
    tp = max(1, int(tp))
    B, nh, dh = q_shape
    q = (B, max(1, int(nh) // tp), dh)
    if pool_shape is None:
        return q, None
    num_pages, ps, p_nh, p_dh = pool_shape
    return q, (num_pages, ps, max(1, int(p_nh) // tp), p_dh)


def paged_attention_backend(batch, num_heads, kv_slots, head_dim, dtype,
                            pool_shape=None, tp=1, device=None):
    """(backend, tier) of one paged decode shape under the JAX package's
    attention_ops.py:223 key (b, nh, 1, sk = the padded slot count, dh,
    causal): the port runs K1 for every such shape, so the prior is
    "pallas_paged" and `validate` refuses any other verdict; the decision
    is resolved, counted and (in sweep and explore mode) recorded, and
    changes no kernel. `num_heads` is the global head count: under tp > 1
    the key is the shard's, nh / tp heads, as in the JAX package."""
    (batch, num_heads, head_dim), _ = _shard_paged_shapes(
        (batch, num_heads, head_dim), pool_shape, tp)
    prior = {"backend": "pallas_paged"}
    if tuning.mode() == "off":
        return prior["backend"], "analytic"
    key = tuning.canonical_key(
        "attention",
        tuning.attention_key(batch, num_heads, 1, kv_slots, head_dim, True),
        str(dtype).replace("torch.", ""), tuning.device_kind(device))
    decision, tier = tuning.decide(
        "attention", key, prior=lambda: prior, default=prior,
        validate=lambda d: d.get("backend") == prior["backend"])
    return decision["backend"], tier


@register_op("paged_decode_attention")
def paged_decode_attention_op(ctx: ExecContext):
    """Q [B, nh, dh], KPool/VPool [pages, ps, nh, dh], PageTable [B, P],
    Positions [B] (the slot this step's token was appended at: it attends
    slots 0..Positions inclusive, itself included) -> Out [B, nh, dh],
    through the K1 kernel; its tuner key resolved once a shape in the
    prepared program (`paged_attention_backend`). Under tensor
    parallelism (`tp_degree`, the tensor-parallel rewrite) the op sees this
    rank's heads of Q and of the pools, and K1 runs on them: the shapes
    are already the shard's and are not divided again."""
    q, k_pool, table = ctx.input("Q"), ctx.input("KPool"), ctx.input("PageTable")
    if ctx.decisions is not None and tuning.mode() != "off":
        (B, nh, dh), slots = q.shape, table.shape[1] * k_pool.shape[1]
        key = ("paged", B, nh, slots, dh, q.dtype, q.device)
        if key not in ctx.decisions:
            ctx.decisions[key] = paged_attention_backend(
                B, nh, slots, dh, q.dtype, device=q.device)[0]
    kv_lens = (ctx.input("Positions").to(torch.int32) + 1).contiguous()
    out = paged_decode_attention(
        q.contiguous(), k_pool, ctx.input("VPool"),
        table.to(torch.int32).contiguous(), kv_lens,
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


def kv_cache_prefill_write_(k_pool, v_pool, k, v, page_table, lens,
                            start=None):
    """Write a prefill window's K/V [B, nh, S, dh] into the pools in place.
    Without `start`: local position s of row b writes slot s when s <
    lens[b]; bucket padding writes nothing. With `start` [B] (a suffix
    prefill past a cached prefix, or a speculative verify window): local
    position s writes slot start[b] + s, and lens[b] counts the valid local
    positions (a padded row passes 0 and writes nothing). Returns the
    (same) pools."""
    if k_pool.is_meta:
        return k_pool, v_pool
    B, nh, S, dh = k.shape
    ps = k_pool.shape[1]
    P = page_table.shape[1]
    pos = torch.arange(S, device=k.device)
    keep = pos[None, :] < lens.long().reshape(-1)[:, None]           # [B, S]
    gpos = (pos.expand(B, S) if start is None
            else start.long().reshape(-1)[:, None] + pos[None, :])
    _write_kept_(k_pool, v_pool,
                 page_table.long().gather(1, (gpos // ps).clamp(0, P - 1)),
                 gpos % ps, k.transpose(1, 2), v.transpose(1, 2), keep)
    return k_pool, v_pool


def paged_prefill_attention(q, k_pool, v_pool, page_table, start,
                            sm_scale=1.0):
    """Windowed causal attention over the pool: query s of row b (global
    position start[b] + s) attends pool slots 0..start[b] + s inclusive,
    its own just-written K/V included. q [B, nh, S, dh] -> [B, nh, S, dh].
    The JAX package's `paged_prefill_attention_fn` in torch: every row's
    pages gathered into a dense [B, P*ps, nh, dh] view, the scores in the
    operands' dtype (the scale rounded to it), then fp32 with the -1e9 mask
    and an fp32 softmax, the probabilities cast back to q's dtype before
    they weight V."""
    B, nh, S, dh = q.shape
    num_pages, ps = k_pool.shape[0], k_pool.shape[1]
    P = page_table.shape[1]
    pt = page_table.long().clamp(0, num_pages - 1)
    k = k_pool[pt].reshape(B, P * ps, nh, dh)
    v = v_pool[pt].reshape(B, P * ps, nh, dh)
    s = (torch.einsum("bhsd,bkhd->bhsk", q, k)
         * rounded(sm_scale, q.dtype)).float()
    slot = torch.arange(P * ps, device=q.device)
    limit = (start.long().reshape(-1)[:, None]
             + torch.arange(S, device=q.device)[None, :])            # [B, S]
    keep = slot[None, None, None, :] <= limit[:, None, :, None]
    s = s.masked_fill(~keep, -1e9)
    probs = torch.softmax(s, dim=-1)
    return torch.einsum("bhsk,bkhd->bhsd", probs.to(q.dtype), v)


def kv_cache_copy_page_(k_pool, v_pool, src, dst):
    """pool[dst] := pool[src] for K and V, in place; `src` and `dst` are
    one-element id tensors, indexed on the device (no host sync). Returns
    the (same) pools."""
    src = src.long().reshape(-1)[:1]
    dst = dst.long().reshape(-1)[:1]
    for pool in (k_pool, v_pool):
        pool.index_copy_(0, dst, pool.index_select(0, src))
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
    """KPool/VPool, K/V [B, nh, S, dh], PageTable [B, P], Lens [B],
    optional Start [B] (the windowed write at slots Start + s, Lens counting
    the valid local positions)."""
    start = ctx.input("Start") if ctx.has_input("Start") else None
    kp, vp = kv_cache_prefill_write_(ctx.input("KPool"), ctx.input("VPool"),
                                     ctx.input("K"), ctx.input("V"),
                                     ctx.input("PageTable"), ctx.input("Lens"),
                                     start)
    return {"KPoolOut": kp, "VPoolOut": vp}


@register_op("paged_prefill_attention")
def paged_prefill_attention_op(ctx: ExecContext):
    """Q [B, nh, S, dh], KPool/VPool, PageTable [B, P], Start [B] (query
    s's global position is Start + s) -> Out [B, nh, S, dh]; under tensor
    parallelism this rank's heads of Q and of the pools."""
    return {"Out": paged_prefill_attention(
        ctx.input("Q"), ctx.input("KPool"), ctx.input("VPool"),
        ctx.input("PageTable"), ctx.input("Start"),
        sm_scale=ctx.attr("sm_scale", 1.0))}


@register_op("kv_cache_copy_page")
def kv_cache_copy_page_op(ctx: ExecContext):
    """Copy-on-write's copy: KPool/VPool, Src [1], Dst [1] -> pool[Dst] :=
    pool[Src] for K and V, in place."""
    kp, vp = kv_cache_copy_page_(ctx.input("KPool"), ctx.input("VPool"),
                                 ctx.input("Src"), ctx.input("Dst"))
    return {"KPoolOut": kp, "VPoolOut": vp}


@register_op("gather_token_logits")
def gather_token_logits_op(ctx: ExecContext):
    """X [B, S, V], Lens [B] -> [B, V]: row b's logits at Lens[b] - 1."""
    x = ctx.input("X")
    idx = (ctx.input("Lens").long() - 1).clamp(0, x.shape[1] - 1)
    return {"Out": x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]}


# ---------------------------------------------------------------------------
# Ring attention (sequence parallelism over the ring's group)
# ---------------------------------------------------------------------------

_NEG_INF = -1e9


def _ring_group(ctx: ExecContext):
    """The group `ring_id` binds in this run (None unbound or of one
    rank)."""
    from .collective_ops import AXIS_ENV_KEY

    env = ctx.env.get(AXIS_ENV_KEY)
    g = None if env is None else env.get(ctx.attr("ring_id", 0), env.get(0))
    return g if g is not None and g.size > 1 else None


def ring_pass(g, tensors):
    """Each rank's `tensors` sent to the next rank of the ring and the
    previous rank's received (send/recv over the group; a gloo group
    stages CUDA tensors through host memory)."""
    import torch.distributed as dist

    from .collective_ops import _STATS

    nxt = g.ranks[(g.index + 1) % g.size]
    prv = g.ranks[(g.index - 1) % g.size]
    dev = tensors[0].device
    stage = g.backend == "gloo" and dev.type == "cuda"
    if stage:
        torch.cuda.current_stream(dev).synchronize()
    send = [(t.cpu() if stage else t).contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt, g.pg) for t in send] + \
        [dist.P2POp(dist.irecv, t, prv, g.pg) for t in recv]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    _STATS["calls"] += 1
    _STATS["bytes"] += sum(t.numel() * t.element_size() for t in send)
    return [t.to(dev, non_blocking=True) for t in recv] if stage else recv


def _ring_scores(q32, kb, rank, src, s_loc, causal):
    s = torch.matmul(q32, kb.float().transpose(-1, -2))
    if causal:
        qp = rank * s_loc + torch.arange(s_loc, device=q32.device)[:, None]
        kp = src * s_loc + torch.arange(s_loc, device=q32.device)[None, :]
        s = s.masked_fill(qp < kp, _NEG_INF)
    return s


def ring_attention_local(g, q, k, v, causal=False, sm_scale=1.0):
    """Blockwise ring attention (the JAX package's attention_ops.py:502):
    q, k, v [B, nh, S_local, dh] are this rank's slice of the sequence;
    K/V rotate round the ring, each block merged into an online softmax in
    fp32 (causal offsets from the ranks). Returns (out in q's dtype, the
    running max m and sum l [B, nh, S_local], fp32)."""
    p, rank = g.size, g.index
    s_loc = q.shape[2]
    q32 = q.float() * sm_scale
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], float("-inf"), device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    kb, vb, src = k, v, rank
    for step in range(p):
        s = _ring_scores(q32, kb, rank, src, s_loc, causal)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        pe = torch.exp(s - m_new[..., None])
        l = l * alpha + pe.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(pe, vb.float())
        m = m_new
        if step < p - 1:
            kb, vb = ring_pass(g, [kb, vb])
            src = (src - 1) % p
    return (acc / l[..., None]).to(q.dtype), m, l


def ring_attention_grad(g, q, k, v, out, m, l, do, causal=False,
                        sm_scale=1.0):
    """The hand-written backward of `ring_attention_local`: each block's
    probabilities recomputed from the saved (m, l); dQ accumulated here,
    dK and dV carried round the ring with their blocks and home to their
    owners after p passes."""
    p, rank = g.size, g.index
    s_loc = q.shape[2]
    q32 = q.float() * sm_scale
    lse = m + torch.log(l)
    do32 = do.float()
    delta = (do32 * out.float()).sum(-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    kb, vb, src = k, v, rank
    for step in range(p):
        s = _ring_scores(q32, kb, rank, src, s_loc, causal)
        pr = torch.exp(s - lse[..., None])
        dv = dv + torch.matmul(pr.transpose(-1, -2), do32)
        ds = pr * (torch.matmul(do32, vb.float().transpose(-1, -2))
                   - delta[..., None])
        dq = dq + torch.matmul(ds, kb.float()) * sm_scale
        dk = dk + torch.matmul(ds.transpose(-1, -2), q32)
        if step < p - 1:
            kb, vb, dk, dv = ring_pass(g, [kb, vb, dk, dv])
            src = (src - 1) % p
        else:
            dk, dv = ring_pass(g, [dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@register_op("ring_attention")
def ring_attention(ctx: ExecContext):
    """Q, K, V [B, nh, S_local, dh] -> Out: exact attention over the
    sequence split across the group `ring_id` binds (K/V rotating round
    the ring, `ring_attention_local`; the (out, m, l) left in the run's
    stash for the grad op). With no ring bound (or one of one rank) it is
    `fused_attention` on the local sequence, on its kernels."""
    g = _ring_group(ctx)
    if g is None:
        return fused_attention(ctx)
    q, k, v = (ctx.input(s) for s in ("Q", "K", "V"))
    out, m, l = ring_attention_local(g, q, k, v, ctx.attr("causal", False),
                                     ctx.attr("sm_scale", 1.0))
    if ctx.stash is not None:
        ctx.stash[ctx.op.outputs["Out"][0]] = (out, m, l)
    return {"Out": out}


@register_grad_compute("ring_attention")
def ring_attention_grad_op(ctx: ExecContext):
    """Q/K/V@GRAD of `ring_attention`: `ring_attention_grad` from the
    forward's stashed (out, m, l), or the forward again where it ran in
    another run; unbound, `fused_attention`'s grad on its kernels."""
    g = _ring_group(ctx)
    if g is None:
        return fused_attention_grad(ctx)
    q, k, v = (ctx.input(s) for s in ("Q", "K", "V"))
    causal, scale = ctx.attr("causal", False), ctx.attr("sm_scale", 1.0)
    do = ctx.input("Out@GRAD")
    do = torch.zeros_like(q) if do is None else do
    key = ctx.op.inputs["Out@GRAD"][0][:-len("@GRAD")]
    saved = ctx.stash.get(key) if ctx.stash is not None else None
    if saved is None:
        saved = ring_attention_local(g, q, k, v, causal, scale)
    grads = ring_attention_grad(g, q, k, v, *saved, do, causal, scale)
    return {s + "@GRAD": t for s, t in zip(("Q", "K", "V"), grads)
            if s + "@GRAD" in ctx.op.outputs}
