"""layer_norm on K3 forward and K5 backward, softmax_with_cross_entropy on
K6 forward and K7 backward, and lookup_table with its dense grad (the JAX
package's nn_ops.py :359-456, :663, :792-829)."""
from __future__ import annotations

import math

import torch

from .cuda_kernels.layer_norm import layer_norm_act
from .cuda_kernels.layer_norm_bwd import layer_norm_act_backward
from .cuda_kernels.xent_bwd import softmax_xent_bwd
from .cuda_kernels.xent_fwd import softmax_xent_fwd
from .registry import ExecContext, register_grad_compute, register_op


def _ln_operands(ctx: ExecContext):
    """x as [R, K] rows and the [K] scale/bias (ones/zeros when absent)."""
    x = ctx.input("X")
    begin = ctx.attr("begin_norm_axis", 1)
    R = math.prod(x.shape[:begin])
    K = math.prod(x.shape[begin:])
    scale = ctx.input("Scale") if ctx.has_input("Scale") else None
    bias = ctx.input("Bias") if ctx.has_input("Bias") else None
    if scale is None:
        scale = torch.ones(K, dtype=torch.float32, device=x.device)
    if bias is None:
        bias = torch.zeros(K, dtype=torch.float32, device=x.device)
    return (x, begin, x.reshape(R, K).contiguous(), scale.reshape(K).contiguous(),
            bias.reshape(K).contiguous())


@register_op("layer_norm")
def layer_norm(ctx: ExecContext):
    """Rows x.shape[:begin_norm_axis] normalized over the rest; Y, Mean and
    Variance all come from the one K3 call."""
    x, begin, x2, scale, bias = _ln_operands(ctx)
    y, mean, var = layer_norm_act(x2, scale, bias,
                                  eps=ctx.attr("epsilon", 1e-5),
                                  act=ctx.attr("act", "") or "identity")
    lead = tuple(x.shape[:begin])
    return {"Y": y.reshape(x.shape), "Mean": mean.reshape(lead),
            "Variance": var.reshape(lead)}


@register_grad_compute("layer_norm")
def layer_norm_grad(ctx: ExecContext):
    """X/Scale/Bias@GRAD from Y@GRAD through K5. Cotangents of the Mean and
    Variance outputs (absent on the BERT path, so zero there) add their
    closed form in plain torch beside the kernel, as the JAX op keeps those
    outputs outside its kernel: dx += dmean / K + dvar 2 (x - mean) / K."""
    x, begin, x2, scale, bias = _ln_operands(ctx)
    R, K = x2.shape
    dy = ctx.input("Y@GRAD")
    dy2 = (torch.zeros_like(x2) if dy is None
           else dy.reshape(R, K).to(x2.dtype).contiguous())
    dx, dscale, dbias = layer_norm_act_backward(
        x2, scale, bias, dy2, eps=ctx.attr("epsilon", 1e-5),
        act=ctx.attr("act", "") or "identity")
    dmean, dvar = ctx.input("Mean@GRAD"), ctx.input("Variance@GRAD")
    if dmean is not None or dvar is not None:
        dx = dx.float()
        if dmean is not None:
            dx = dx + dmean.reshape(R, 1).float() / K
        if dvar is not None:
            xf = x2.float()
            dx = dx + dvar.reshape(R, 1).float() * 2.0 * (
                xf - xf.mean(dim=-1, keepdim=True)) / K
        dx = dx.to(x2.dtype)
    out = {"X@GRAD": dx.reshape(x.shape)}
    if ctx.has_input("Scale"):
        out["Scale@GRAD"] = dscale.reshape(ctx.input("Scale").shape)
    if ctx.has_input("Bias"):
        out["Bias@GRAD"] = dbias.reshape(ctx.input("Bias").shape)
    return {s: g for s, g in out.items() if s in ctx.op.outputs}


def _xent_rows(ctx: ExecContext):
    """Logits as [N, V] rows and the hard labels as [N] int32; the options
    the kernels do not take raise."""
    if ctx.attr("soft_label", False) or ctx.attr("ignore_index", -100) >= 0:
        raise NotImplementedError(
            "softmax_with_cross_entropy with soft_label=True or ignore_index "
            ">= 0 is not ported yet (ROADMAP Queue 1, WMT encoder-decoder)")
    logits, label = ctx.input("Logits"), ctx.input("Label")
    lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    V = logits.shape[-1]
    return (logits, logits.reshape(-1, V).contiguous(),
            lbl.reshape(-1).to(torch.int32).contiguous())


def softmax_with_cross_entropy_grad_maker(op, block, no_grad_set=frozenset()):
    from ..framework import grad_var_name

    logits = op.inputs["Logits"][0]
    if logits in no_grad_set:
        return []
    return [{
        "type": "softmax_with_cross_entropy_grad",
        "inputs": {
            "Softmax": op.outputs["Softmax"],
            # the logits feed K7's in-kernel statistics recompute
            "Logits": op.inputs["Logits"],
            "Label": op.inputs["Label"],
            "Loss@GRAD": [grad_var_name(op.outputs["Loss"][0])],
        },
        "outputs": {"Logits@GRAD": [grad_var_name(logits)]},
        "attrs": dict(op.attrs),
    }]


@register_op("softmax_with_cross_entropy",
             grad=softmax_with_cross_entropy_grad_maker)
def softmax_with_cross_entropy(ctx: ExecContext):
    """Hard-label cross entropy per row on K6. The Softmax output is
    produced from K6's row statistics in one elementwise pass, so a fetch
    or a later op may read it; the grad op does not (K7 recomputes)."""
    logits, x2, lbl = _xent_rows(ctx)
    loss, m, lse = softmax_xent_fwd(x2, lbl)
    sm = torch.exp(x2.float() - (m + lse)[:, None]).to(logits.dtype)
    return {"Softmax": sm.reshape(logits.shape),
            "Loss": loss.reshape(*logits.shape[:-1], 1).to(logits.dtype)}


@register_grad_compute("softmax_with_cross_entropy")
def softmax_with_cross_entropy_grad(ctx: ExecContext):
    """dLogits = (softmax - onehot(label)) * dLoss on K7, with the row
    statistics recomputed from the logits (the grad op gets no saved ones),
    as the JAX op's kernel path does."""
    logits, x2, lbl = _xent_rows(ctx)
    dloss = ctx.input("Loss@GRAD")
    g = (torch.zeros(x2.shape[0], dtype=torch.float32, device=x2.device)
         if dloss is None else dloss.reshape(-1).float().contiguous())
    dx = softmax_xent_bwd(x2, lbl, g)
    return {"Logits@GRAD": dx.reshape(logits.shape)}


def _squeeze_ids(ids):
    """A trailing 1 on Ids is squeezed (a [B, 1] id feed gives [B, H])."""
    return ids.reshape(ids.shape[:-1]) if ids.dim() and ids.shape[-1] == 1 else ids


@register_op("lookup_table")
def lookup_table(ctx: ExecContext):
    """Rows of W at Ids (the decode program feeds flat [B] ids)."""
    w, idsq = ctx.input("W"), _squeeze_ids(ctx.input("Ids"))
    out = w[idsq.long()]
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((idsq == padding_idx)[..., None], 0.0)
    return {"Out": out}


@register_grad_compute("lookup_table")
def lookup_table_grad(ctx: ExecContext):
    """W@GRAD as a dense scatter-add (`index_add_` into zeros). On CUDA its
    atomics add repeated ids in an order that changes from run to run, so
    the word-embedding grad is reproducible to fp32 rounding, not bit for
    bit. `index_put_(accumulate=True)` is not used: it sorts and checks its
    indices with kernels and a host sync of its own."""
    if ctx.attr("is_sparse", False):
        raise NotImplementedError(
            "lookup_table with is_sparse=True (SelectedRows grads) is not "
            "ported yet (ROADMAP Queue 1, data pipeline and embeddings)")
    w, og = ctx.input("W"), ctx.input("Out@GRAD")
    dense = torch.zeros_like(w)
    if og is None:
        return {"W@GRAD": dense}
    rows = _squeeze_ids(ctx.input("Ids")).reshape(-1).long()
    vals = og.reshape(-1, og.shape[-1]).to(w.dtype)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        vals = vals.masked_fill((rows == padding_idx)[:, None], 0.0)
    return {"W@GRAD": dense.index_add_(0, rows, vals)}
