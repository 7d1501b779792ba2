"""Linear-chain CRF: the negative log-likelihood and Viterbi decoding (the
JAX package's crf_ops.py).

Both recursions run batched over the padded batch: alpha and the Viterbi
scores are [B, N], and the loop walks the static padded T on the host, one
step of a few [B, N, N] ops a frame. Lengths become device masks (a frame
past a sequence's length keeps its row), so nothing is read back. The
Viterbi back-pointers are one [T-1, B, N] tensor and the backtrack T-1
gathers. The likelihood's grad is derived by replay (ops/registry.py):
the autograd of the log-space recursion is the backward the reference
writes by hand. Index reads go through `gather` and `index_select`, whose
backwards are sync-free on CUDA (advanced indexing's is not).

Transition layout (the reference's): [N+2, N], row 0 the start weights,
row 1 the stop weights, rows 2..N+1 the N x N transition matrix.
"""
from __future__ import annotations

import torch

from ..core.types import torch_feed_dtype
from .registry import ExecContext, register_op
from .sequence_ops import _lengths

# index outputs are int64 in the API and run as int32, as in the JAX
# package with x64 off
_INDEX_DTYPE = torch_feed_dtype("int64")


def _split_transition(w):
    return w[0], w[1], w[2:]  # start [N], stop [N], trans [N, N]


def _labels(ctx, slot="Label"):
    label = ctx.input(slot)
    if label.dim() == 3 and label.shape[-1] == 1:
        label = label.reshape(label.shape[:-1])
    return label


def _tag_index(label, N):
    """Labels as gather indices the way jnp indexes: a negative id counts
    from the end, an id past the end clamps (only padding holds such ids,
    and the masks drop what they read)."""
    lbl = label.to(torch.int64)
    return torch.where(lbl < 0, lbl + N, lbl).clamp(0, N - 1)


def _crf_nll(em, lbl, length, w):
    """Negative log-likelihood per sequence [B] (the reference op's
    LogLikelihood output is the cost users feed to mean()). em [B, T, N]
    fp32, lbl [B, T] int64 tag indices, length [B] int32, w [N+2, N]."""
    B, T, N = em.shape
    start, stop, trans = _split_transition(w)
    valid = torch.arange(T, device=em.device)[None, :] < length[:, None]

    # partition function: the alpha recursion in log space
    alpha = start + em[:, 0]
    for t in range(1, 1 if em.is_meta else T):
        nxt = torch.logsumexp(alpha[:, :, None] + trans, dim=1) + em[:, t]
        alpha = torch.where(valid[:, t:t + 1], nxt, alpha)
    log_z = torch.logsumexp(alpha + stop, dim=1)

    # the gold path's score
    zero = torch.zeros((), dtype=em.dtype, device=em.device)
    em_score = torch.where(valid, em.gather(2, lbl[:, :, None])[:, :, 0],
                           zero).sum(1)
    pair = (lbl[:, :-1] * N + lbl[:, 1:]).reshape(-1)
    tr = trans.reshape(-1).index_select(0, pair).reshape(B, T - 1)
    tr_score = torch.where(valid[:, 1:], tr, zero).sum(1)
    last = (length.to(torch.int64) - 1).clamp(min=0)
    score = (start.index_select(0, lbl[:, 0]) + em_score + tr_score
             + stop.index_select(0, lbl.gather(1, last[:, None])[:, 0]))
    return log_z - score


@register_op("linear_chain_crf")
def linear_chain_crf(ctx: ExecContext):
    """inputs: Emission [B, T, N], Transition [N+2, N], Label [B, T] (or
    [B, T, 1]), optional Length [B]. outputs: LogLikelihood [B, 1]."""
    em = ctx.input("Emission").float()
    w = ctx.input("Transition").float()
    B, T, N = em.shape
    length = _lengths(ctx, T, B, em.device)
    nll = _crf_nll(em, _tag_index(_labels(ctx), N), length, w)
    return {"LogLikelihood": nll[:, None]}


@register_op("crf_decoding", grad="none")
def crf_decoding(ctx: ExecContext):
    """Viterbi decode: the best path per sequence. With a Label input the
    output is the per-position mismatch indicator (the reference's
    "compare with ground truth" mode); padding positions emit 0. Ties go
    to the lowest tag, as jnp.argmax and torch.max both pick the first
    maximum."""
    em = ctx.input("Emission").float()
    w = ctx.input("Transition").float()
    B, T, N = em.shape
    dev = em.device
    if em.is_meta:   # a padded T of -1 infers through the sentinel extent
        return {"ViterbiPath": torch.empty((B, T), dtype=_INDEX_DTYPE,
                                           device=dev)}
    length = _lengths(ctx, T, B, dev)
    start, stop, trans = _split_transition(w)
    valid = torch.arange(T, device=dev)[None, :] < length[:, None]
    ident = torch.arange(N, device=dev).expand(B, N)

    v = start + em[:, 0]
    bps = []
    for t in range(1, T):
        best, bp = (v[:, :, None] + trans).max(dim=1)  # over "from"
        live = valid[:, t:t + 1]
        v = torch.where(live, best + em[:, t], v)
        bps.append(torch.where(live, bp, ident))       # identity pointer
    tag = torch.argmax(v + stop, dim=1)
    path = [tag]
    if bps:
        bps = torch.stack(bps)                          # [T-1, B, N]
        for t in range(T - 2, -1, -1):
            tag = bps[t].gather(1, tag[:, None])[:, 0]
            path.append(tag)
    paths = torch.stack(path[::-1], dim=1)
    paths = torch.where(valid, paths, torch.zeros_like(paths))
    if ctx.has_input("Label"):
        mism = (paths != _labels(ctx).to(paths.dtype)) & valid
        return {"ViterbiPath": mism.to(_INDEX_DTYPE)}
    return {"ViterbiPath": paths.to(_INDEX_DTYPE)}
