"""CTC on padded batches (the JAX package's ctc_ops.py): the warpctc loss,
the greedy decoder's alignment (ctc_align), the Levenshtein distance
(edit_distance) and the chunk counts of tagged sequences (chunk_eval).

warpctc's alpha recursion runs in log space over the extended label
[blank, l1, blank, ..., blank], one step a frame on the host over the
static padded T, batched over [B, 2S+1]; a frame past a sample's logits
length keeps its alpha. Its grad is derived by replay (ops/registry.py).
An unreachable slot holds _NEG, and a log-sum-exp over only such slots
returns _NEG: the branch where() does not take is then kept finite too,
so the replay's gradient there is 0, not 0 * inf. ctc_align and
edit_distance are sync-free: a stable sort compacts the kept tokens, and
the insertion closure of each edit-distance row is a prefix minimum
(torch.cummin). chunk_eval is a host op: the chunk walk reads the tags
back, as the reference's CPU kernel does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import torch_feed_dtype
from .registry import ExecContext, register_op
from .sequence_ops import _lengths

# index outputs are int64 in the API and run as int32, as in the JAX
# package with x64 off
_INDEX_DTYPE = torch_feed_dtype("int64")

_NEG = -1e30


def _logsumexp2(a, b):
    m = torch.maximum(a, b)
    dead = m <= _NEG
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    s = torch.where(dead, torch.ones_like(s), s)
    return torch.where(dead, torch.full_like(m, _NEG), m_safe + torch.log(s))


def _logsumexp3(a, b, c):
    return _logsumexp2(_logsumexp2(a, b), c)


def _squeeze_last(x):
    if x.dim() == 3 and x.shape[-1] == 1:
        return x.reshape(x.shape[:-1])
    return x


def _shift(x, k, fill):
    """x [B, L] moved k slots right, the first k filled with `fill`."""
    return torch.cat([torch.full_like(x[:, :k], fill), x[:, :-k]], dim=1)


@register_op("warpctc")
def warpctc(ctx: ExecContext):
    """Logits [B, T, V] raw activations, Label [B, S] ids (padded with
    anything), LogitsLength [B], LabelLength [B] -> Loss [B, 1], the
    negative log-likelihood (divided by the logits length when
    norm_by_times, as the JAX op does); an impossible alignment gives
    -_NEG. blank is the attr `blank` (default 0)."""
    logits = ctx.input("Logits")
    label = ctx.input("Label").to(torch.int64)
    blank = int(ctx.attr("blank", 0))
    norm_by_times = bool(ctx.attr("norm_by_times", False))
    B, T, V = logits.shape
    S = label.shape[1]
    dev = logits.device
    lg_len = _lengths(ctx, T, B, dev, "LogitsLength")
    lb_len = _lengths(ctx, S, B, dev, "LabelLength")

    logp = torch.log_softmax(logits, dim=-1)            # [B, T, V]

    # the extended sequence l' = [blank, l1, blank, l2, ..., blank]
    L = 2 * S + 1
    pos = torch.arange(L, device=dev)
    odd = pos % 2 == 1
    lbl_at = torch.div(pos - 1, 2, rounding_mode="floor").clamp(0, S - 1)
    ext = torch.where(odd[None, :], label.index_select(1, lbl_at),
                      torch.full((), blank, dtype=torch.int64, device=dev))
    ext_len = 2 * lb_len.to(torch.int64) + 1            # [B]
    # a label id outside [0, V) (padding) is read from a valid column: only
    # slots past ext_len hold one, and no slot the loss reads depends on them
    ext_at = torch.where(ext < 0, ext + V, ext).clamp(0, V - 1)
    # the skip l'[s-2] -> l'[s] is allowed where l'[s] is a label and
    # differs from l'[s-2]
    can_skip = odd[None, :] & (ext != _shift(ext, 2, -1))   # [B, L]

    def emit(t):
        return logp[:, t].gather(1, ext_at)                 # [B, L]

    neg = torch.full((), _NEG, dtype=logp.dtype, device=dev)
    first = logp[:, 0].gather(1, ext_at[:, 1:2])[:, 0]
    alpha = torch.cat([logp[:, 0, blank:blank + 1],
                       torch.where(lb_len > 0, first, neg)[:, None],
                       neg.expand(B, L - 2)], dim=1)
    steps = range(1, 1 if logits.is_meta else T)
    for t in steps:
        a = _logsumexp3(alpha, _shift(alpha, 1, _NEG),
                        torch.where(can_skip, _shift(alpha, 2, _NEG), neg))
        a = a + emit(t)
        # frames beyond a sample's logits length keep the old alpha
        alpha = torch.where((t < lg_len)[:, None], a, alpha)

    # total probability: alpha[ext_len - 1] (+) alpha[ext_len - 2]
    last = alpha.gather(1, (ext_len - 1)[:, None])[:, 0]
    last2 = alpha.gather(1, (ext_len - 2).clamp(min=0)[:, None])[:, 0]
    loss = -_logsumexp2(last, torch.where(ext_len >= 2, last2, neg))
    if norm_by_times:
        loss = loss / lg_len.to(loss.dtype).clamp(min=1)
    return {"Loss": loss[:, None].to(logits.dtype)}


@register_op("ctc_align", grad="none")
def ctc_align(ctx: ExecContext):
    """The CTC greedy decode after the argmax: merge repeats, drop blanks.
    Input [B, T] tokens + InputLength [B] -> Output [B, T] left-compacted,
    padded with `padding_value` (-1), OutputLength [B]. A stable sort on
    "dropped" puts the kept tokens first in time order."""
    x = _squeeze_last(ctx.input("Input")).to(torch.int32)
    blank = int(ctx.attr("blank", 0))
    B, T = x.shape
    ln = _lengths(ctx, T, B, x.device, "InputLength")
    t = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
    prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], dim=1)
    keep = (x != blank) & (x != prev) & (t < ln[:, None])
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    n_keep = keep.sum(dim=1).to(torch.int32)
    pad = torch.full((), int(ctx.attr("padding_value", -1)), dtype=x.dtype,
                     device=x.device)
    out = torch.where(t < n_keep[:, None], x.gather(1, order), pad)
    return {"Output": out.to(_INDEX_DTYPE),
            "OutputLength": n_keep.to(_INDEX_DTYPE)}


@register_op("edit_distance", grad="none")
def edit_distance(ctx: ExecContext):
    """Levenshtein distance: Hyps [B, Th] + HypsLength [B], Refs [B, Tr] +
    RefsLength [B] -> Out [B, 1] float distances (divided by the ref
    length when attr normalized) and SequenceNum [1]. One host step a hyp
    position, each updating the whole [B, Tr+1] row of the table."""
    hyp = _squeeze_last(ctx.input("Hyps")).to(torch.int32)
    ref = _squeeze_last(ctx.input("Refs")).to(torch.int32)
    B, Th = hyp.shape
    Tr = ref.shape[1]
    dev = hyp.device
    hl = _lengths(ctx, Th, B, dev, "HypsLength")
    rl = _lengths(ctx, Tr, B, dev, "RefsLength")

    j = torch.arange(Tr + 1, dtype=torch.float32, device=dev)[None, :]
    row = j.expand(B, Tr + 1)
    for i in range(1, 1 if hyp.is_meta else Th + 1):
        # D[i, j] from D[i-1, :]: deletion D[i-1, j] + 1, substitution
        # D[i-1, j-1] + cost, then the insertion closure
        # min_k<=j (base[k] + j - k): a prefix min of base - j, plus j
        sub = row[:, :-1] + (hyp[:, i - 1:i] != ref).to(torch.float32)
        base = torch.cat([row[:, :1] + 1.0, torch.minimum(row[:, 1:] + 1.0,
                                                          sub)], dim=1)
        closed = torch.cummin(base - j, dim=1).values + j
        new = torch.minimum(base, closed)
        # past this hyp's length the row stays frozen
        row = torch.where((i <= hl)[:, None], new, row)
    dist = row.gather(1, rl.to(torch.int64)[:, None])
    if bool(ctx.attr("normalized", True)):
        dist = dist / rl[:, None].to(torch.float32).clamp(min=1.0)
    return {"Out": dist,
            "SequenceNum": torch.full((1,), B, dtype=_INDEX_DTYPE, device=dev)}


_TAGS_A_TYPE = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _chunks(seq, scheme, n_types, excluded):
    """The typed chunks {(type, start, end)} of one tag sequence."""
    tag_n = _TAGS_A_TYPE[scheme]
    chunks = []
    start = cur_type = None
    for i, v in enumerate(seq):
        if v < 0 or v >= n_types * tag_n:
            t_, p = None, None
        else:
            t_, p = int(v) // tag_n, int(v) % tag_n
        if scheme == "plain":
            begin = t_ is not None and t_ != cur_type
            end_prev = cur_type is not None and t_ != cur_type
        elif scheme == "IOB":
            begin = t_ is not None and (p == 0 or t_ != cur_type)
            end_prev = cur_type is not None and (t_ is None or p == 0
                                                or t_ != cur_type)
        elif scheme == "IOE":
            begin = t_ is not None and (start is None or t_ != cur_type)
            end_prev = cur_type is not None and t_ != cur_type
        else:  # IOBES: 0 = B, 1 = I, 2 = E, 3 = S
            begin = t_ is not None and p in (0, 3)
            end_prev = cur_type is not None and (t_ is None or p in (0, 3))
        if end_prev and start is not None:
            chunks.append((cur_type, start, i - 1))
            start = cur_type = None
        if begin:
            start, cur_type = i, t_
        if (scheme == "IOE" and t_ is not None and p == 1) or (
                scheme == "IOBES" and t_ is not None and p in (2, 3)):
            chunks.append((t_, start if start is not None else i, i))
            start = cur_type = None
    if start is not None:
        chunks.append((cur_type, start, len(seq) - 1))
    return {c for c in chunks if c[0] not in excluded}


@register_op("chunk_eval", grad="none", host=True)
def chunk_eval(ctx: ExecContext):
    """Chunking precision, recall and F1 of IOB / IOE / IOBES / plain tag
    sequences: decode each into typed chunks and count the matches. A host
    op: the chunk walk is irregular control flow, which the reference also
    runs on the CPU, and metrics never sit on the training path."""
    inf_t = ctx.input("Inference")
    inf = inf_t.reshape(inf_t.shape[0], -1).cpu().numpy().astype(np.int64)
    lab = ctx.input("Label").reshape(inf.shape[0], -1).cpu().numpy().astype(
        np.int64)
    scheme = ctx.attr("chunk_scheme", "IOB")
    n_types = int(ctx.attr("num_chunk_types"))
    excluded = set(ctx.attr("excluded_chunk_types", []) or [])
    B, T = inf.shape
    if ctx.has_input("SeqLength"):
        ln = ctx.input("SeqLength").reshape(-1).cpu().numpy().astype(np.int64)
    else:
        ln = np.full((B,), T, np.int64)
    n_inf = n_lab = n_correct = 0
    for b in range(B):
        ic = _chunks(inf[b, :ln[b]], scheme, n_types, excluded)
        lc = _chunks(lab[b, :ln[b]], scheme, n_types, excluded)
        n_inf += len(ic)
        n_lab += len(lc)
        n_correct += len(ic & lc)
    p = n_correct / n_inf if n_inf else 0.0
    r = n_correct / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0

    def out(v, dtype):
        return torch.tensor([v], dtype=dtype).to(ctx.device)

    return {"Precision": out(p, torch.float32),
            "Recall": out(r, torch.float32),
            "F1-Score": out(f1, torch.float32),
            "NumInferChunks": out(n_inf, _INDEX_DTYPE),
            "NumLabelChunks": out(n_lab, _INDEX_DTYPE),
            "NumCorrectChunks": out(n_correct, _INDEX_DTYPE)}
