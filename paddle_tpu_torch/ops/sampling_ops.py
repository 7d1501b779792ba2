"""Large-vocabulary loss ops (the JAX package's sampling_ops.py): NCE,
the hierarchical sigmoid over a complete binary tree, sample_logits (the
sampled softmax's subsampling) and gaussian_random_batch_size_like.

Draws come from the run's `torch.Generator`: the distributions of the JAX
ops, not their streams. An op that draws saves its draws as an output
(nce's SampleLabels, sample_logits' Samples), and its grad replays the op
on them, never drawing again. No op here reads the device from the host.
"""
from __future__ import annotations

import math

import torch

from ..core.types import torch_dtype, torch_feed_dtype
from .registry import ExecContext, register_grad_compute, register_op

# index outputs are int64 in the API and run as int32, as in the JAX
# package with x64 off
_INDEX_DTYPE = torch_feed_dtype("int64")


def _rows(w, idx):
    """w's rows at idx (any shape): index_select, whose backward is an
    index_add_ (an advanced index's backward syncs on CUDA)."""
    return w.index_select(0, idx.reshape(-1).long()).reshape(
        tuple(idx.shape) + tuple(w.shape[1:]))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _nce_loss(x, label, w, b, samples, C, k, sampler):
    """The NCE objective on the drawn negatives `samples` [B, k]: logistic
    loss of the true class and the negatives against the noise
    distribution (uniform, or log-uniform P(c) = log((c+2)/(c+1)) /
    log(C+1))."""
    label = label.reshape(-1)
    if sampler == 1:
        logq = (torch.log(torch.log((samples + 2.0) / (samples + 1.0)))
                - math.log(math.log(C + 1)))
        pos_q = (torch.log(torch.log((label + 2.0) / (label + 1.0)))
                 - math.log(math.log(C + 1)))
    else:
        logq = torch.full(samples.shape, -math.log(C), device=x.device)
        pos_q = torch.full(label.shape, -math.log(C), device=x.device)

    def logits_of(idx):
        out = torch.einsum("bd,bkd->bk", x, _rows(w, idx))
        if b is not None:
            out = out + _rows(b.reshape(-1), idx)
        return out

    pos_s = logits_of(label[:, None])[:, 0] - (pos_q + math.log(k))
    neg_s = logits_of(samples) - (logq + math.log(k))
    return (_softplus(-pos_s) + _softplus(neg_s).sum(dim=1))[:, None].to(x.dtype)


def _nce_attrs(ctx: ExecContext):
    return (int(ctx.attr("num_total_classes")),
            int(ctx.attr("num_neg_samples", 5)), int(ctx.attr("sampler", 0)))


def _nce_grad_maker(op, block, no_grad_set=frozenset()):
    from ..framework import grad_var_name

    ins = {"Input": op.inputs["Input"], "Label": op.inputs["Label"],
           "Weight": op.inputs["Weight"],
           "SampleLabels": op.outputs["SampleLabels"],
           "Cost@GRAD": [grad_var_name(op.outputs["Cost"][0])]}
    outs = {}
    for slot in ("Input", "Weight", "Bias"):
        names = op.inputs.get(slot, [])
        if names and names[0] not in no_grad_set:
            outs[slot + "@GRAD"] = [grad_var_name(names[0])]
    if op.inputs.get("Bias"):
        ins["Bias"] = op.inputs["Bias"]
    if not outs:
        return []
    return [{"type": "nce_grad", "inputs": ins, "outputs": outs,
             "attrs": dict(op.attrs)}]


@register_op("nce", needs_rng=True, grad=_nce_grad_maker)
def nce(ctx: ExecContext):
    """Input [B, D], Label [B, 1], Weight [C, D], Bias [C]? -> Cost [B, 1]
    and the k negatives drawn a row, SampleLabels [B, k] (uniform over C,
    or log-uniform by the inverse CDF exp(u log(C+1)) - 1)."""
    x, label = ctx.input("Input"), ctx.input("Label")
    C, k, sampler = _nce_attrs(ctx)
    B = x.shape[0]
    if ctx.is_meta:
        neg = torch.empty((B, k), dtype=torch.int32, device="meta")
    elif sampler == 1:
        u = ctx.draw(lambda shape: torch.rand(
            shape, generator=ctx.generator, device=ctx.device), (B, k))
        neg = torch.clamp((torch.exp(u * math.log(C + 1)) - 1).to(torch.int32),
                          0, C - 1)
    else:
        neg = ctx.draw(lambda shape: torch.randint(
            0, C, shape, generator=ctx.generator, device=ctx.device,
            dtype=torch.int32), (B, k))
    cost = _nce_loss(x, label, ctx.input("Weight"), ctx.input("Bias"), neg,
                     C, k, sampler)
    return {"Cost": cost, "SampleLabels": neg.to(_INDEX_DTYPE)}


@register_grad_compute("nce")
def nce_grad(ctx: ExecContext):
    """The objective replayed under autograd on the saved SampleLabels."""
    C, k, sampler = _nce_attrs(ctx)
    leaves = {s: ctx.input(s).detach().requires_grad_(True)
              for s in ("Input", "Weight", "Bias") if ctx.input(s) is not None}
    with torch.enable_grad():
        cost = _nce_loss(leaves["Input"], ctx.input("Label"), leaves["Weight"],
                         leaves.get("Bias"), ctx.input("SampleLabels"), C, k,
                         sampler)
        grads = torch.autograd.grad(cost, list(leaves.values()),
                                    ctx.input("Cost@GRAD"))
    return {s + "@GRAD": g for s, g in zip(leaves, grads)
            if s + "@GRAD" in ctx.op.outputs}


@register_op("hierarchical_sigmoid")
def hierarchical_sigmoid(ctx: ExecContext):
    """The hierarchical sigmoid over a complete binary tree (the
    reference's SimpleCode: class c's code is c + C, its path the bits
    below the top one). X [B, D], Label [B, 1], W [C-1, D], Bias [C-1]?
    -> Out [B, 1] (the sum of the path's sigmoid cross entropies) and
    PreOut [B, L]."""
    x, w, bias = ctx.input("X"), ctx.input("W"), ctx.input("Bias")
    label = ctx.input("Label").reshape(-1).to(torch.int32)
    C = int(ctx.attr("num_classes"))
    max_len = max(1, int(math.ceil(math.log2(C))) + 1)
    c = label + C
    bits = torch.arange(max_len, dtype=torch.int32, device=x.device)
    length = torch.floor(torch.log2(c.to(torch.float32))).to(torch.int32)
    valid = bits[None, :] < length[:, None]
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    idx = torch.where(valid, (c[:, None] >> (bits[None, :] + 1)) - 1, zero)
    bit = torch.where(valid, (c[:, None] >> bits[None, :]) & 1, zero)
    pre = torch.einsum("bd,bld->bl", x, _rows(w, idx))
    if bias is not None:
        pre = pre + _rows(bias.reshape(-1), idx)
    per_node = _softplus(pre) - bit * pre
    loss = torch.where(valid, per_node, torch.zeros_like(per_node)).sum(dim=1)
    return {"Out": loss[:, None].to(x.dtype), "PreOut": pre.to(x.dtype)}


@register_op("gaussian_random_batch_size_like", grad="none", needs_rng=True)
def gaussian_random_batch_size_like(ctx: ExecContext):
    """Normal(mean, std) of attr shape, its output_dim_idx extent Input's
    input_dim_idx extent."""
    shape = [int(s) for s in ctx.attr("shape")]
    shape[int(ctx.attr("output_dim_idx", 0))] = \
        ctx.input("Input").shape[int(ctx.attr("input_dim_idx", 0))]
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if ctx.is_meta:
        return {"Out": torch.empty(shape, dtype=dtype, device="meta")}
    z = ctx.draw(lambda s: torch.randn(s, generator=ctx.generator,
                                       dtype=torch.float32,
                                       device=ctx.device), shape)
    return {"Out": (float(ctx.attr("mean", 0.0))
                    + float(ctx.attr("std", 1.0)) * z).to(dtype)}


def _log_uniform_prob(ids, range_max):
    """The log-uniform sampler's class probability log((c+2)/(c+1)) /
    log(range_max + 1)."""
    c = ids.to(torch.float32)
    return torch.log((c + 2.0) / (c + 1.0)) / math.log(float(range_max) + 1.0)


def _sample_logits_grad_maker(op, block, no_grad_set=frozenset()):
    from ..framework import grad_var_name

    lname = op.inputs["Logits"][0]
    if lname in no_grad_set:
        return []
    return [{"type": "sample_logits_grad",
             "inputs": {"Logits": list(op.inputs["Logits"]),
                        "Samples": list(op.outputs["Samples"]),
                        "SampledLogits@GRAD":
                            [grad_var_name(op.outputs["SampledLogits"][0])]},
             "outputs": {"Logits@GRAD": [grad_var_name(lname)]},
             "attrs": dict(op.attrs)}]


@register_op("sample_logits", needs_rng=True, grad=_sample_logits_grad_maker)
def sample_logits(ctx: ExecContext):
    """Logits [B, V], Labels [B, NT] -> Samples [B, NT+S] (the true labels,
    then S log-uniform draws with replacement), SampledLogits (each logit
    less log of its class probability; with remove_accidental_hits a draw
    equal to a true label less 1e20), SampledLabel [B, NT] = 0..NT-1 and
    Probabilities."""
    logits = ctx.input("Logits")
    labels = ctx.input("Labels").to(torch.int32)
    if labels.dim() == 1:
        labels = labels[:, None]
    B, V = logits.shape
    NT = labels.shape[1]
    S = int(ctx.attr("num_samples"))
    if ctx.is_meta:
        draws = torch.empty((B, S), dtype=torch.int32, device="meta")
    else:
        u = 1e-9 + (1.0 - 1e-9) * ctx.draw(lambda shape: torch.rand(
            shape, generator=ctx.generator, device=ctx.device), (B, S))
        draws = torch.clamp((torch.exp(u * math.log(float(V) + 1.0)) - 1.0)
                            .to(torch.int32), 0, V - 1)
    samples = torch.cat([labels, draws], dim=1)
    q = _log_uniform_prob(samples, V)
    adjusted = logits.gather(1, samples.long()) - torch.log(q + 1e-20)
    if bool(ctx.attr("remove_accidental_hits", True)):
        hit = (draws[:, :, None] == labels[:, None, :]).any(-1)
        pad = torch.cat([torch.zeros((B, NT), dtype=torch.bool,
                                     device=hit.device), hit], dim=1)
        adjusted = torch.where(pad, adjusted - 1e20, adjusted)
    return {"Samples": samples.to(_INDEX_DTYPE),
            "SampledLogits": adjusted.to(logits.dtype),
            "SampledLabel": torch.arange(NT, dtype=_INDEX_DTYPE,
                                         device=logits.device)[None, :]
                                 .expand(B, NT).contiguous(),
            "Probabilities": q.to(logits.dtype)}


@register_grad_compute("sample_logits")
def sample_logits_grad(ctx: ExecContext):
    """dLogits: dSampledLogits added back at the saved Samples' columns."""
    logits = ctx.input("Logits")
    g = ctx.input("SampledLogits@GRAD")
    if g is None:
        return {"Logits@GRAD": torch.zeros_like(logits)}
    samples = ctx.input("Samples").long()
    B, V = logits.shape
    flat = (torch.arange(B, device=logits.device)[:, None] * V + samples)
    return {"Logits@GRAD": torch.zeros(B * V, dtype=logits.dtype,
                                       device=logits.device).index_add_(
        0, flat.reshape(-1), g.to(logits.dtype).reshape(-1)).reshape(B, V)}
