"""Sequence ops on the padding contract, and beam search (the JAX
package's sequence_ops.py).

A ragged batch is a padded [B, T, ...] tensor plus an int `Length` [B]; a
mask over the time axis stands in for the reference's LoD offset walk.
The tail (sequence_slice .. match_matrix_tensor) follows the JAX ops of
sequence_ops.py:270-:490 on the same layout; their grads are derived by
replay. Beam search keeps fixed [batch * beam, ...] shapes: a finished beam is
frozen on end_id rather than pruned, so a decode step is sync-free and the
decode loop runs the same ops every iteration.
"""
from __future__ import annotations

import torch

from ..core.types import torch_feed_dtype
from .registry import ExecContext, register_grad_compute, register_op

# index outputs are int64 in the API and narrow to int32 at run time
_INDEX_DTYPE = torch_feed_dtype("int64")

_NEG_INF = -1e9


def _lengths(ctx: ExecContext, time_extent: int, batch: int, device,
             slot: str = "Length"):
    """Input `slot` as int32 [B], or `time_extent` for every row when
    absent."""
    ln = ctx.input(slot)
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


@register_op("sequence_slice")
def sequence_slice(ctx: ExecContext):
    """Row b holds X[b, off_b : off_b + len_b] left-aligned and
    zero-padded; OutLength is len_b (the JAX op, sequence_ops.py:270). The
    time extent stays T: a shifted, clamped index gathers each row."""
    x = ctx.input("X")
    off = ctx.input("Offset").reshape(-1).to(torch.int32)
    ln = ctx.input("Length").reshape(-1).to(torch.int32)
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
    src = torch.clamp(t + off[:, None], 0, T - 1).long()
    gathered = x[torch.arange(B, device=x.device)[:, None], src]
    mask = _trailing(t < ln[:, None], x.dim())
    return {"Out": torch.where(mask, gathered, torch.zeros_like(gathered)),
            "OutLength": ln.to(_INDEX_DTYPE)}


@register_op("sequence_erase", grad="none")
def sequence_erase(ctx: ExecContext):
    """Drop the listed tokens from each valid prefix of X [B, T] and shift
    the survivors left, zero-padded; OutLength counts them (sequence_ops.py
    :291). A stable sort on "dropped" puts the kept positions first in
    their order, so negative values survive as they are."""
    x = ctx.input("X")
    B, T = x.shape
    ln = _lengths(ctx, T, B, x.device)
    t = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
    keep = t < ln[:, None]
    for tok in ctx.attr("tokens", []):
        keep = keep & (x != int(tok))
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    out_len = keep.sum(dim=1).to(torch.int32)
    out = torch.where(t < out_len[:, None], x.gather(1, order),
                      torch.zeros_like(x))
    return {"Out": out, "OutLength": out_len.to(_INDEX_DTYPE)}


@register_op("sequence_expand_as")
def sequence_expand_as(ctx: ExecContext):
    """Each row of X repeated B_y / B_x times (sequence_ops.py:323)."""
    x, y = ctx.input("X"), ctx.input("Y")
    bx, by = x.shape[0], y.shape[0]
    if by % bx:
        raise ValueError(
            f"sequence_expand_as: Y batch {by} not a multiple of X batch {bx}")
    return {"Out": torch.repeat_interleave(x, by // bx, dim=0)}


@register_grad_compute("sequence_expand_as")
def sequence_expand_as_grad(ctx: ExecContext):
    """X@GRAD sums each row's repeats; Y only sets the row count, so
    Y@GRAD is zeros (what jax.vjp gives the JAX op's Y)."""
    x, y, og = ctx.input("X"), ctx.input("Y"), ctx.input("Out@GRAD")
    out = {}
    if "X@GRAD" in ctx.op.outputs:
        out["X@GRAD"] = (torch.zeros_like(x) if og is None else og.reshape(
            (x.shape[0], -1) + tuple(x.shape[1:])).sum(dim=1))
    if "Y@GRAD" in ctx.op.outputs:
        out["Y@GRAD"] = torch.zeros_like(y)
    return out


@register_op("sequence_scatter")
def sequence_scatter(ctx: ExecContext):
    """X [B, T, ...] plus Updates [B, S, ...] added at per-row positions Ids
    [B, S] (sequence_ops.py:336: accumulate, duplicates add); IdsLength
    masks the trailing updates. `scatter_add` along time."""
    x = ctx.input("X")
    ids = ctx.input("Ids")
    upd = ctx.input("Updates")
    if ids.dim() == 3 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    if upd.dim() == 3 and upd.shape[-1] == 1 and x.dim() == 2:
        upd = upd.reshape(upd.shape[:-1])
    B, S = ids.shape
    if ctx.input("IdsLength") is not None:
        ln = ctx.input("IdsLength").reshape(-1).to(torch.int32)
        m = torch.arange(S, dtype=torch.int32, device=x.device)[None, :] < ln[:, None]
        upd = torch.where(_trailing(m, upd.dim()), upd, torch.zeros_like(upd))
    idx = ids.long().reshape((B, S) + (1,) * (x.dim() - 2)).expand(
        (B, S) + tuple(x.shape[2:]))
    return {"Out": x.scatter_add(1, idx, upd.to(x.dtype))}


@register_op("sequence_conv")
def sequence_conv(ctx: ExecContext):
    """Context-window convolution over time (sequence_ops.py:361): X
    [B, T, D] and Filter [contextLength * D, F] -> [B, T, F]; step t
    concatenates rows t + contextStart .. t + contextStart + contextLength
    - 1 (zeros outside [0, T)) and multiplies the filter. Length masks the
    padded steps of the output."""
    x, filt = ctx.input("X"), ctx.input("Filter")
    start = int(ctx.attr("contextStart", -1))
    length = int(ctx.attr("contextLength", 3))
    if int(ctx.attr("contextStride", 1)) != 1:
        raise NotImplementedError("sequence_conv: contextStride must be 1 "
                                  "(the reference enforces the same)")
    B, T, D = x.shape
    t = torch.arange(T, dtype=torch.int32, device=x.device)
    cols = []
    for j in range(length):
        src = t + start + j
        valid = ((src >= 0) & (src < T))[None, :, None]
        g = x[:, torch.clamp(src, 0, T - 1).long(), :]
        cols.append(torch.where(valid, g, torch.zeros_like(g)))
    out = torch.cat(cols, dim=-1) @ filt
    if ctx.input("Length") is not None:
        ln = ctx.input("Length").reshape(-1).to(torch.int32)
        out = torch.where((t[None, :] < ln[:, None])[:, :, None], out,
                          torch.zeros_like(out))
    return {"Out": out}


@register_op("sequence_enumerate", grad="none")
def sequence_enumerate(ctx: ExecContext):
    """Sliding id windows (sequence_ops.py:393): X [B, T] -> [B, T, win];
    positions past the row's length fill with pad_value."""
    x = ctx.input("X")
    if x.dim() == 3 and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    win, pad = int(ctx.attr("win_size", 2)), int(ctx.attr("pad_value", 0))
    B, T = x.shape
    t = torch.arange(T, dtype=torch.int32, device=x.device)
    ln = _lengths(ctx, T, B, x.device)
    outs = []
    for j in range(win):
        ok = (t + j)[None, :] < ln[:, None]
        g = x[:, torch.clamp(t + j, 0, T - 1).long()]
        outs.append(torch.where(ok, g, torch.full_like(g, pad)))
    return {"Out": torch.stack(outs, dim=-1)}


@register_op("sequence_reshape")
def sequence_reshape(ctx: ExecContext):
    """[B, T, D] -> [B, T * D / new_dim, new_dim] (sequence_ops.py:418)."""
    x = ctx.input("X")
    new_dim = int(ctx.attr("new_dim", 1))
    total = 1
    for d in x.shape[1:]:
        total *= d
    if total % new_dim:
        raise ValueError(
            f"sequence_reshape: {total} values per row not divisible by "
            f"new_dim {new_dim}")
    return {"Out": x.reshape(x.shape[0], total // new_dim, new_dim)}


@register_op("sequence_topk_avg_pooling")
def sequence_topk_avg_pooling(ctx: ExecContext):
    """Per channel and row of X [B, C, R, W], the mean of the top k column
    scores for each k of `topks` (sequence_ops.py:432): Out [B, R,
    C * len(topks)] in (r, channel, k) order. ColLength masks columns
    (with fewer valid than k, the valid ones summed over k); RowLength
    zeroes padded rows."""
    x = ctx.input("X")
    topks = [int(k) for k in ctx.attr("topks", [1])]
    B, C, R, W = x.shape
    cl = _lengths(ctx, W, B, x.device, "ColLength")
    w = torch.arange(W, dtype=torch.int32, device=x.device)
    col_ok = (w[None, :] < cl[:, None])[:, None, None, :]
    masked = torch.where(col_ok, x, torch.finfo(x.dtype).min)
    s = torch.sort(masked, dim=-1, descending=True).values
    s = torch.where(col_ok, s, torch.zeros_like(s))
    csum = torch.cumsum(s, dim=-1)
    out = torch.stack([csum[..., min(k, W) - 1] / float(k) for k in topks],
                      dim=-1)
    out = out.permute(0, 2, 1, 3).reshape(B, R, C * len(topks))
    if ctx.input("RowLength") is not None:
        rl = ctx.input("RowLength").reshape(-1).to(torch.int32)
        row_ok = torch.arange(R, dtype=torch.int32, device=x.device)[None, :] < rl[:, None]
        out = torch.where(row_ok[:, :, None], out, torch.zeros_like(out))
    return {"Out": out}


@register_op("match_matrix_tensor")
def match_matrix_tensor(ctx: ExecContext):
    """Out[b, c, i, j] = x_i^T W_c y_j (sequence_ops.py:468): X [B, Tx, H],
    Y [B, Ty, H], W [H, C, H] -> [B, C, Tx, Ty]; XLength / YLength zero
    the padded positions."""
    x, y, w = ctx.input("X"), ctx.input("Y"), ctx.input("W")
    out = torch.einsum("bih,hcg,bjg->bcij", x, w, y)
    Tx, Ty = x.shape[1], y.shape[1]
    if ctx.input("XLength") is not None:
        xl = ctx.input("XLength").reshape(-1).to(torch.int32)
        m = torch.arange(Tx, dtype=torch.int32, device=x.device)[None, :] < xl[:, None]
        out = torch.where(m[:, None, :, None], out, torch.zeros_like(out))
    if ctx.input("YLength") is not None:
        yl = ctx.input("YLength").reshape(-1).to(torch.int32)
        m = torch.arange(Ty, dtype=torch.int32, device=x.device)[None, :] < yl[:, None]
        out = torch.where(m[:, None, None, :], out, torch.zeros_like(out))
    return {"Out": out}
