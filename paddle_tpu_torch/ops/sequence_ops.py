"""Sequence ops on the padding contract, and beam search (the JAX
package's sequence_ops.py).

A ragged batch is a padded [B, T, ...] tensor plus an int `Length` [B]; a
mask over the time axis stands in for the reference's LoD offset walk.
Beam search keeps fixed [batch * beam, ...] shapes: a finished beam is
frozen on end_id rather than pruned, so a decode step is sync-free and the
decode loop runs the same ops every iteration.
"""
from __future__ import annotations

import torch

from ..core.types import torch_feed_dtype
from .registry import ExecContext, register_op

# index outputs are int64 in the API and narrow to int32 at run time
_INDEX_DTYPE = torch_feed_dtype("int64")

_NEG_INF = -1e9


def _lengths(ctx: ExecContext, time_extent: int, batch: int, device):
    ln = ctx.input("Length")
    if ln is None:
        return torch.full((batch,), time_extent, dtype=torch.int32,
                          device=device)
    return ln.reshape(-1).to(torch.int32)


def _time_mask(lengths, maxlen: int, dtype=torch.float32):
    """[B, maxlen]: 1 where t < lengths[b]."""
    t = torch.arange(maxlen, dtype=torch.int32, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def _trailing(mask, ndim: int):
    """A [B, T] mask with ones appended to reach `ndim` dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - 2))


@register_op("sequence_mask", grad="none")
def sequence_mask(ctx: ExecContext):
    """Lengths [B] -> [B, maxlen] mask; maxlen must be static."""
    maxlen = ctx.attr("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen attr")
    x = ctx.input("X").reshape(-1).to(torch.int32)
    dt = torch_feed_dtype(ctx.attr("out_dtype", "int64"))
    return {"Y": _time_mask(x, int(maxlen), dt)}


@register_op("sequence_pad")
def sequence_pad(ctx: ExecContext):
    """Keep the valid prefix of [B, T, ...] and set the tail to PadValue;
    a static padded_length truncates or extends the time extent."""
    x, pad = ctx.input("X"), ctx.input("PadValue")
    maxlen = ctx.attr("padded_length", -1)
    if maxlen is not None and maxlen > 0 and maxlen != x.shape[1]:
        if maxlen < x.shape[1]:
            x = x[:, :maxlen]
        else:
            widths = [0, 0] * (x.dim() - 2) + [0, maxlen - x.shape[1]]
            x = torch.nn.functional.pad(x, widths)
    ln = _lengths(ctx, x.shape[1], x.shape[0], x.device)
    ln = ln.clamp(max=x.shape[1])
    mask = _trailing(_time_mask(ln, x.shape[1], torch.bool), x.dim())
    out = torch.where(mask, x, pad.to(x.dtype))
    return {"Out": out, "Length": ln.to(_INDEX_DTYPE)}


@register_op("sequence_unpad")
def sequence_unpad(ctx: ExecContext):
    """The padded layout stays dense; its tail is zeroed."""
    x = ctx.input("X")
    ln = _lengths(ctx, x.shape[1], x.shape[0], x.device)
    return {"Out": x * _trailing(_time_mask(ln, x.shape[1], x.dtype),
                                 x.dim())}


@register_op("sequence_pool")
def sequence_pool(ctx: ExecContext):
    """SUM / AVERAGE / SQRT / MAX / LAST / FIRST over the valid region of
    [B, T, ...]."""
    x = ctx.input("X")
    pooltype = str(ctx.attr("pooltype", "SUM")).upper()
    B, T = x.shape[0], x.shape[1]
    ln = _lengths(ctx, T, B, x.device)
    mask = _trailing(_time_mask(ln, T, x.dtype), x.dim())
    per_row = (B,) + (1,) * (x.dim() - 2)
    if pooltype == "SUM":
        out = (x * mask).sum(dim=1)
    elif pooltype == "AVERAGE":
        out = (x * mask).sum(dim=1) / ln.to(x.dtype).clamp(min=1).reshape(per_row)
    elif pooltype == "SQRT":
        out = (x * mask).sum(dim=1) / torch.sqrt(
            ln.to(x.dtype).clamp(min=1)).reshape(per_row)
    elif pooltype == "MAX":
        out = torch.where(mask.bool(), x, _NEG_INF).amax(dim=1)
    elif pooltype == "LAST":
        idx = (ln - 1).clamp(min=0).long().reshape((B, 1) + (1,) * (x.dim() - 2))
        out = x.gather(1, idx.expand((B, 1) + tuple(x.shape[2:]))).squeeze(1)
    elif pooltype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"sequence_pool: unknown pooltype '{pooltype}'")
    return {"Out": out}


@register_op("sequence_reverse")
def sequence_reverse(ctx: ExecContext):
    """Each valid prefix reversed in place; the padding stays at the
    tail."""
    x = ctx.input("X")
    B, T = x.shape[0], x.shape[1]
    ln = _lengths(ctx, T, B, x.device)[:, None]
    t = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
    idx = torch.where(t < ln, ln - 1 - t, t).long()
    idx = idx.reshape((B, T) + (1,) * (x.dim() - 2)).expand(x.shape)
    return {"Y": x.gather(1, idx)}


@register_op("sequence_expand")
def sequence_expand(ctx: ExecContext):
    """Each row of X repeated `times` times in a row (the beam layout):
    [B, ...] -> [B * times, ...] (a 0-d X as one row, as jnp.repeat
    takes it)."""
    x = ctx.input("X")
    x = x.reshape(1) if x.dim() == 0 else x
    return {"Out": torch.repeat_interleave(x, int(ctx.attr("times", 1)),
                                           dim=0)}


@register_op("sequence_softmax")
def sequence_softmax(ctx: ExecContext):
    """Softmax over each valid region of [B, T]; padding gets 0."""
    x = ctx.input("X")
    B, T = x.shape[0], x.shape[1]
    mask = _time_mask(_lengths(ctx, T, B, x.device), T, torch.bool)
    p = torch.softmax(torch.where(mask, x, _NEG_INF), dim=1)
    return {"Out": torch.where(mask, p, 0.0)}


@register_op("sequence_concat")
def sequence_concat(ctx: ExecContext):
    """Padded operands concatenated along time."""
    return {"Out": torch.cat([x for x in ctx.inputs("X") if x is not None],
                             dim=1)}


@register_op("beam_search", grad="none")
def beam_search(ctx: ExecContext):
    """One decode step on flattened beam-major rows (BW = batch * beam).

    pre_ids [BW, 1], pre_scores [BW, 1] (cumulative log-probs), ids and
    scores [BW, K] (the decoder's top-K candidates, log-softmaxed) ->
    selected_ids [BW, 1], selected_scores [BW, 1], parent_idx [BW] (the
    row of the previous layout each selection extends).

    Every row gets one more candidate, end_id at -1e9, so a finished
    hypothesis survives even when end_id is not among its top K. A finished
    row (pre_id == end_id) is frozen: all its original candidates are
    killed and the appended end_id carries it on at exactly its
    pre_score. On the first step only beam 0 of each batch row proposes.
    Fixed shapes, no host sync."""
    pre_ids = ctx.input("pre_ids").reshape(-1)
    pre_scores = ctx.input("pre_scores").reshape(-1)
    ids, scores = ctx.input("ids"), ctx.input("scores")
    beam = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))
    BW = ids.shape[0]
    B = BW // beam
    dev = ids.device

    finished = (pre_ids == end_id)[:, None]
    ids = torch.cat([ids, torch.full((BW, 1), end_id, dtype=ids.dtype,
                                     device=dev)], dim=1)
    scores = torch.cat([scores, torch.full((BW, 1), _NEG_INF,
                                           dtype=scores.dtype, device=dev)],
                       dim=1)
    K = ids.shape[1]
    cand = pre_scores[:, None] + torch.where(finished, 0.0, scores)
    original = torch.arange(K, device=dev)[None, :] < K - 1
    cand = torch.where(finished & original, _NEG_INF, cand)
    if ctx.attr("is_first_step", False):
        live0 = (torch.arange(BW, device=dev) % beam == 0)[:, None]
        cand = torch.where(live0, cand, _NEG_INF)
    top_scores, top_pos = torch.topk(cand.reshape(B, beam * K), beam, dim=1)
    batch_off = torch.arange(B, device=dev)[:, None] * beam
    parent = (batch_off + top_pos // K).reshape(-1)
    sel_ids = ids.reshape(B, beam * K).gather(1, top_pos).reshape(-1, 1)
    return {"selected_ids": sel_ids.to(_INDEX_DTYPE),
            "selected_scores": top_scores.reshape(-1, 1),
            "parent_idx": parent.to(torch.int32)}


@register_op("beam_search_decode", grad="none")
def beam_search_decode(ctx: ExecContext):
    """Backtrack the parent pointers: Ids, ParentIdx, Scores [T, BW] ->
    SentenceIds [BW, T] (each final row's hypothesis), SentenceScores [BW]
    (the last step's cumulative scores)."""
    ids, parents = ctx.input("Ids"), ctx.input("ParentIdx").long()
    T, BW = ids.shape
    ptr = torch.arange(BW, device=ids.device)
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = ids[t][ptr]
        ptr = parents[t][ptr]
    return {"SentenceIds": torch.stack(toks, dim=1).to(_INDEX_DTYPE),
            "SentenceScores": ctx.input("Scores")[-1].reshape(-1)}
