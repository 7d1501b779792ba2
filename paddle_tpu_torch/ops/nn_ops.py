"""Neural-net ops (the JAX package's nn_ops.py): layer_norm on K3 forward
and K5 backward, softmax_with_cross_entropy on K6 forward and K7 backward
for hard labels (soft labels and ignore_index in torch, as the JAX package
computes them on XLA), cross_entropy on probabilities and
sigmoid_cross_entropy_with_logits (torch, grads by replay), softmax and its
causal-masked form, dropout, label_smooth, lookup_table with its dense or
SelectedRows grad and lookup_table_grad_rows, the tiered embeddings'
emb_cache_install and tiered_lookup (gathers and a scatter-add over the
device cache, as the JAX package's jnp.take / .at[] ops), conv2d /
depthwise_conv2d / conv2d_transpose / pool2d on PyTorch's library calls
(the JAX package leaves them to XLA), batch_norm and conv2d_bn whose
apply chain is K8 forward and K9 backward, and accuracy. Under bf16 AMP
the activations are bf16 and every kernel runs its bf16 instantiation;
statistics, running averages and the norms' parameters stay
fp32 inside, as in the JAX ops.

Inside a replayed grad (a recompute segment, an RNN body) each
kernel-backed op runs a torch.autograd.Function whose backward is its
registered grad's kernel: `_LayerNormFn` (K3, K5), `_XentFn` (K6, K7 from
K6's saved statistics) and `_BatchNormFn` (K8, K9; in training K9's chain
mode)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.selected_rows import SelectedRows
from ..framework import GRAD_SUFFIX
from .cuda_kernels.bn_apply import bn_apply_act
from .cuda_kernels.bn_apply_bwd import (bn_apply_act_backward,
                                        bn_apply_act_backward_chain,
                                        bn_apply_act_backward_sums,
                                        bn_param_grads, stat_cotangents)
from .cuda_kernels.layer_norm import layer_norm_act
from .cuda_kernels.layer_norm_bwd import layer_norm_act_backward
from .cuda_kernels.xent_bwd import softmax_xent_bwd
from .cuda_kernels.xent_fwd import softmax_xent_fwd
from .math_ops import rounded
from .registry import (ExecContext, register_grad_compute, register_op,
                       under_autograd)


def _ln_operands(ctx: ExecContext):
    """x as [R, K] rows and the [K] scale/bias in fp32 (ones/zeros when
    absent): under AMP the harmonize-down rule hands the op bf16 views of
    them, which the kernels read in fp32, as the TPU wrapper casts them."""
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
    return (x, begin, x.reshape(R, K).contiguous(),
            scale.reshape(K).float().contiguous(),
            bias.reshape(K).float().contiguous())


@register_op("layer_norm")
def layer_norm(ctx: ExecContext):
    """Rows x.shape[:begin_norm_axis] normalized over the rest; Y, Mean and
    Variance all come from the one K3 call. Inside a replayed grad the call
    goes through `_LayerNormFn`, whose backward is K5."""
    x, begin, x2, scale, bias = _ln_operands(ctx)
    eps = ctx.attr("epsilon", 1e-5)
    act = ctx.attr("act", "") or "identity"
    if under_autograd(x2, scale, bias):
        y, mean, var = _LayerNormFn.apply(x2, scale, bias, eps, act)
    else:
        y, mean, var = layer_norm_act(x2, scale, bias, eps=eps, act=act)
    lead = tuple(x.shape[:begin])
    return {"Y": y.reshape(x.shape), "Mean": mean.reshape(lead),
            "Variance": var.reshape(lead)}


def _ln_backward(x2, scale, bias, dy, dmean, dvar, eps, act):
    """(dx [R, K], dscale, dbias fp32 [K]) through K5. Cotangents of the
    Mean and Variance outputs (absent on the BERT path) add their closed
    form in plain torch beside the kernel, as the JAX op keeps those
    outputs outside its kernel: dx += dmean / K + dvar 2 (x - mean) / K."""
    R, K = x2.shape
    dy2 = (torch.zeros_like(x2) if dy is None
           else dy.reshape(R, K).to(x2.dtype).contiguous())
    dx, dscale, dbias = layer_norm_act_backward(x2, scale, bias, dy2,
                                                eps=eps, act=act)
    if dmean is not None or dvar is not None:
        dx = dx.float()
        if dmean is not None:
            dx = dx + dmean.reshape(R, 1).float() / K
        if dvar is not None:
            xf = x2.float()
            dx = dx + dvar.reshape(R, 1).float() * 2.0 * (
                xf - xf.mean(dim=-1, keepdim=True)) / K
        dx = dx.to(x2.dtype)
    return dx, dscale, dbias


class _LayerNormFn(torch.autograd.Function):
    """K3 forward, K5 backward (`_ln_backward`, as the registered grad
    computes it), for a layer_norm inside a replayed grad."""

    @staticmethod
    def forward(fctx, x2, scale, bias, eps, act):
        fctx.set_materialize_grads(False)
        fctx.save_for_backward(x2, scale, bias)
        fctx.eps, fctx.act = eps, act
        return layer_norm_act(x2, scale, bias, eps=eps, act=act)

    @staticmethod
    def backward(fctx, dy, dmean, dvar):
        x2, scale, bias = fctx.saved_tensors
        dx, dscale, dbias = _ln_backward(x2, scale, bias, dy, dmean, dvar,
                                         fctx.eps, fctx.act)
        return dx, dscale, dbias, None, None


@register_grad_compute("layer_norm")
def layer_norm_grad(ctx: ExecContext):
    """X/Scale/Bias@GRAD from Y@GRAD through K5 (`_ln_backward`)."""
    x, begin, x2, scale, bias = _ln_operands(ctx)
    dx, dscale, dbias = _ln_backward(
        x2, scale, bias, ctx.input("Y@GRAD"), ctx.input("Mean@GRAD"),
        ctx.input("Variance@GRAD"), ctx.attr("epsilon", 1e-5),
        ctx.attr("act", "") or "identity")
    out = {"X@GRAD": dx.reshape(x.shape)}
    for slot, g in (("Scale", dscale), ("Bias", dbias)):
        if ctx.has_input(slot):
            p = ctx.input(slot)
            out[slot + "@GRAD"] = g.reshape(p.shape).to(p.dtype)
    return {s: g for s, g in out.items() if s in ctx.op.outputs}


def _hard_labels(label):
    """Hard labels without their trailing 1."""
    return label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label


def _xent_on_kernels(ctx: ExecContext) -> bool:
    """Hard labels without ignore_index run on K6/K7. Soft labels and
    ignore_index >= 0 take the JAX op's XLA branch, composed in torch: the
    TPU kernel refuses both (the JAX package's `_xent_pallas_eligible`)."""
    return (not ctx.attr("soft_label", False)
            and ctx.attr("ignore_index", -100) < 0)


def _xent_vocab_eligible(attrs) -> bool:
    """The tensor-parallel rewrite marks a cross entropy vocab-parallel
    only where it runs on K6/K7 (`_xent_on_kernels`)."""
    return (not attrs.get("soft_label", False)
            and attrs.get("ignore_index", -100) < 0)


def _vocab_group(ctx: ExecContext):
    from .collective_ops import AXIS_ENV_KEY

    g = (ctx.env.get(AXIS_ENV_KEY) or {}).get(ctx.op.tp_vocab)
    if g is None:
        raise RuntimeError(
            f"{ctx.op.type}: marked vocab-parallel over ring "
            f"{ctx.op.tp_vocab}, which this run binds to no group")
    return g


def _vocab_stats(ctx: ExecContext, g, x2, local):
    """The global row statistics (M, lse) of logits whose class dim is
    split over the ranks of `g`, and the label's logit: K6 on the local
    slice gives (m, lse); M is the max of m over the ranks, lse the log of
    the sum of exp(m - M + lse), and the label's logit the sum of the
    ranks' masked picks (fp32)."""
    from .collective_ops import _all_reduce

    _, m, lse = softmax_xent_fwd(x2, local)
    V = x2.shape[1]
    inside = (local >= 0) & (local < V)
    picked = x2.gather(1, local.clamp(0, V - 1).long()[:, None])[:, 0]
    picked = torch.where(inside, picked.float(), torch.zeros_like(m))
    M = _all_reduce(g, m.clone(), "max", "vocab-parallel xent max")
    both = _all_reduce(g, torch.stack([torch.exp(m - M + lse), picked]),
                       "sum", "vocab-parallel xent sums")
    return M, torch.log(both[0]), both[1]


def _xent_vocab_parallel(ctx: ExecContext):
    """The vocab-parallel forward (the tensor-parallel rewrite's
    `tp_vocab` mark): this rank holds classes [r V, (r + 1) V) of the
    logits; labels are shifted by r V (a label outside the slice picks 0
    in K6 and its plain version) and the loss is M + lse - the label's
    logit over the whole vocabulary. The global (M, lse) go to the grad op
    through the run's stash; the Softmax output is this rank's slice."""
    logits, x2, lbl = _xent_rows(ctx)
    g = _vocab_group(ctx)
    local = (lbl - g.index * x2.shape[1]).contiguous()
    M, lse, picked = _vocab_stats(ctx, g, x2, local)
    if ctx.stash is not None:
        ctx.stash[ctx.op.outputs["Loss"][0]] = (M, lse)
    loss = M + lse - picked
    sm = torch.exp(x2.float() - (M + lse)[:, None]).to(logits.dtype)
    return {"Softmax": sm.reshape(logits.shape),
            "Loss": loss.reshape(*logits.shape[:-1], 1).to(logits.dtype)}


def _xent_vocab_parallel_grad(ctx: ExecContext):
    """K7's saved-stats mode on the local slice with the global (M, lse)
    and the shifted labels (a label outside the slice subtracts nothing);
    the statistics come from the forward's stash, or again from K6 and
    the reductions where the forward ran in another run."""
    logits, x2, lbl = _xent_rows(ctx)
    g = _vocab_group(ctx)
    local = (lbl - g.index * x2.shape[1]).contiguous()
    key = ctx.op.inputs["Loss@GRAD"][0][:-len("@GRAD")]
    saved = ctx.stash.get(key) if ctx.stash is not None else None
    M, lse = saved if saved is not None else _vocab_stats(ctx, g, x2,
                                                          local)[:2]
    dloss = ctx.input("Loss@GRAD")
    gl = (torch.zeros(x2.shape[0], dtype=torch.float32, device=x2.device)
          if dloss is None else dloss.reshape(-1).float().contiguous())
    dx = softmax_xent_bwd(x2, local, gl, M.contiguous(), lse.contiguous())
    return {"Logits@GRAD": dx.reshape(logits.shape)}


def _xent_rows(ctx: ExecContext):
    """Logits as [N, V] rows and the hard labels as [N] int32."""
    logits = ctx.input("Logits")
    V = logits.shape[-1]
    return (logits, logits.reshape(-1, V).contiguous(),
            _hard_labels(ctx.input("Label")).reshape(-1).to(torch.int32)
            .contiguous())


def _xent_composed(ctx: ExecContext):
    """The JAX op's XLA branch: an fp32 log-softmax, the loss in the
    logits' dtype; a hard label equal to ignore_index loses nothing."""
    logits, label = ctx.input("Logits"), ctx.input("Label")
    lsm = torch.log_softmax(logits.float(), dim=-1)
    if ctx.attr("soft_label", False):
        loss = -(label.float() * lsm).sum(dim=-1, keepdim=True)
    else:
        lbl = _hard_labels(label).long()
        loss = -lsm.gather(-1, lbl.clamp(0, lsm.shape[-1] - 1)[..., None])
        loss = loss.masked_fill(
            (lbl == ctx.attr("ignore_index", -100))[..., None], 0.0)
    return {"Softmax": torch.exp(lsm).to(logits.dtype),
            "Loss": loss.to(logits.dtype)}


def _xent_composed_grad(ctx: ExecContext):
    """(Softmax - label) * dLoss with jnp's (and torch's) dtype promotion,
    as the JAX grad computes it: under AMP a bf16 Softmax minus an fp32
    label is fp32."""
    sm, label, dloss = (ctx.input(s) for s in ("Softmax", "Label",
                                                "Loss@GRAD"))
    if dloss is None:
        dloss = torch.zeros(sm.shape[:-1] + (1,), dtype=sm.dtype,
                            device=sm.device)
    if ctx.attr("soft_label", False):
        return {"Logits@GRAD": (sm - label) * dloss}
    lbl = _hard_labels(label).long()
    onehot = (lbl[..., None] == torch.arange(sm.shape[-1], device=sm.device)
              ).to(sm.dtype)
    grad = (sm - onehot) * dloss
    return {"Logits@GRAD": grad.masked_fill(
        (lbl == ctx.attr("ignore_index", -100))[..., None], 0.0)}


def softmax_with_cross_entropy_grad_maker(op, block, no_grad_set=frozenset()):
    from ..framework import grad_var_name

    logits = op.inputs["Logits"][0]
    if logits in no_grad_set:
        return []
    return [{
        "type": "softmax_with_cross_entropy_grad",
        "inputs": {
            # read by the soft-label and ignore_index grad; K7 recomputes
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
    if not _xent_on_kernels(ctx):
        return _xent_composed(ctx)
    if getattr(ctx.op, "tp_vocab", None) is not None and not ctx.is_meta:
        return _xent_vocab_parallel(ctx)
    logits, x2, lbl = _xent_rows(ctx)
    if under_autograd(x2):
        loss, mlse = _XentFn.apply(x2, lbl)
    else:
        loss, m, lse = softmax_xent_fwd(x2, lbl)
        mlse = m + lse
    sm = torch.exp(x2.float() - mlse[:, None]).to(logits.dtype)
    return {"Softmax": sm.reshape(logits.shape),
            "Loss": loss.reshape(*logits.shape[:-1], 1).to(logits.dtype)}


class _XentFn(torch.autograd.Function):
    """K6 forward, K7 backward from K6's saved row statistics (its
    saved-stats mode), for a hard-label cross entropy inside a replayed
    grad. Returns the loss and the row's logsumexp m + lse, from which the
    op makes its Softmax output; a cotangent reaching that adds softmax g
    to dx (absent when nothing differentiates the Softmax)."""

    @staticmethod
    def forward(fctx, x2, lbl):
        fctx.set_materialize_grads(False)
        loss, m, lse = softmax_xent_fwd(x2, lbl)
        fctx.save_for_backward(x2, lbl, m, lse)
        return loss, m + lse

    @staticmethod
    def backward(fctx, dloss, dmlse):
        x2, lbl, m, lse = fctx.saved_tensors
        g = (torch.zeros(x2.shape[0], dtype=torch.float32, device=x2.device)
             if dloss is None else dloss.float().contiguous())
        dx = softmax_xent_bwd(x2, lbl, g, m, lse)
        if dmlse is not None:
            p = torch.exp(x2.float() - (m + lse)[:, None])
            dx = (dx.float() + p * dmlse.float()[:, None]).to(x2.dtype)
        return dx, None


@register_grad_compute("softmax_with_cross_entropy")
def softmax_with_cross_entropy_grad(ctx: ExecContext):
    """dLogits = (softmax - onehot(label)) * dLoss on K7, with the row
    statistics recomputed from the logits (the grad op gets no saved ones),
    as the JAX op's kernel path does."""
    if not _xent_on_kernels(ctx):
        return _xent_composed_grad(ctx)
    if getattr(ctx.op, "tp_vocab", None) is not None:
        return _xent_vocab_parallel_grad(ctx)
    logits, x2, lbl = _xent_rows(ctx)
    dloss = ctx.input("Loss@GRAD")
    g = (torch.zeros(x2.shape[0], dtype=torch.float32, device=x2.device)
         if dloss is None else dloss.reshape(-1).float().contiguous())
    dx = softmax_xent_bwd(x2, lbl, g)
    return {"Logits@GRAD": dx.reshape(logits.shape)}


@register_op("cross_entropy")
def cross_entropy(ctx: ExecContext):
    """-log of the probability X (a softmax's output) gives the label, or
    -sum(label log X) for soft labels, with the JAX op's 1e-12 inside the
    log; a hard label equal to ignore_index (>= 0) loses nothing. The grad
    is derived by replay."""
    x, label = ctx.input("X"), ctx.input("Label")
    eps = 1e-12
    if ctx.attr("soft_label", False):
        return {"Y": -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)}
    lbl = _hard_labels(label).long()
    loss = -torch.log(x.gather(-1, lbl[..., None]) + eps)
    ignore = ctx.attr("ignore_index", -100)
    if ignore is not None and ignore >= 0:
        loss = loss.masked_fill((lbl == ignore)[..., None], 0.0)
    return {"Y": loss}


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(ctx: ExecContext):
    """max(x, 0) - x z + log(1 + exp(-|x|)) elementwise, zero where the
    label equals ignore_index, divided by the count of the other labels
    with `normalize`. torch.maximum splits the gradient at x = 0 as
    jnp.maximum does. The grad is derived by replay."""
    x, label = ctx.input("X"), ctx.input("Label")
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    ignore = ctx.attr("ignore_index", -100)
    loss = loss.masked_fill(label == ignore, 0.0)
    if ctx.attr("normalize", False):
        n = torch.clamp((label != ignore).to(x.dtype).sum(), min=1.0)
        loss = loss / n
    return {"Out": loss}


@register_op("softmax")
def softmax(ctx: ExecContext):
    """The grad is derived by replay."""
    return {"Out": torch.softmax(ctx.input("X"), dim=ctx.attr("axis", -1))}


@register_op("softmax_mask_fuse_upper_triangle")
def softmax_mask_fuse_upper_triangle(ctx: ExecContext):
    """Softmax over the last dim with the entries above the diagonal of
    the last two set to -1e9 (-6e4 in fp16) first. The grad is derived by
    replay."""
    x = ctx.input("X")
    keep = torch.ones(x.shape[-2:], dtype=torch.bool, device=x.device).tril()
    neg = -6e4 if x.dtype == torch.float16 else -1e9
    return {"Out": torch.softmax(x.masked_fill(~keep, neg), dim=-1)}


def dropout_grad_maker(op, block, no_grad_set=frozenset()):
    from ..framework import grad_var_name

    x = op.inputs["X"][0]
    if x in no_grad_set:
        return []
    return [{
        "type": "dropout_grad",
        "inputs": {"Mask": op.outputs["Mask"],
                   "Out@GRAD": [grad_var_name(op.outputs["Out"][0])]},
        "outputs": {"X@GRAD": [grad_var_name(x)]},
        "attrs": dict(op.attrs),
    }]


@register_op("dropout", needs_rng=True, grad=dropout_grad_maker)
def dropout(ctx: ExecContext):
    """Out = X * Mask. In training each element is kept with probability
    1 - dropout_prob, drawn from the run's generator (on the card, CUDA's
    Philox stream, keyed by the program seed and the run counter); Mask
    holds {0, 1 / (1 - p)} under upscale_in_train and {0, 1} under
    downgrade_in_infer, in X's dtype. is_test keeps every element and
    scales by 1 - p under downgrade_in_infer."""
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    upscale = (ctx.attr("dropout_implementation", "downgrade_in_infer")
               == "upscale_in_train")
    if ctx.attr("is_test", False):
        return {"Out": x if upscale else x * rounded(1.0 - p, x.dtype),
                "Mask": torch.ones_like(x)}
    if ctx.is_meta:
        return {"Out": torch.empty_like(x), "Mask": torch.empty_like(x)}
    keep = ctx.draw(lambda shape: torch.rand(
        shape, generator=ctx.generator, device=x.device,
        dtype=torch.float32), x.shape) < 1.0 - p
    mask = keep.to(x.dtype)
    if upscale:
        # 1 / (1 - p) divided in x's dtype, as the JAX op divides
        keep_p = torch.tensor(max(1.0 - p, 1e-8), dtype=x.dtype)
        mask = mask * (torch.ones((), dtype=x.dtype) / keep_p).item()
    return {"Out": x * mask, "Mask": mask}


@register_grad_compute("dropout")
def dropout_grad(ctx: ExecContext):
    dout, mask = ctx.input("Out@GRAD"), ctx.input("Mask")
    return {"X@GRAD": torch.zeros_like(mask) if dout is None else dout * mask}


@register_op("label_smooth")
def label_smooth(ctx: ExecContext):
    """(1 - epsilon) X + epsilon PriorDist, or + epsilon / depth without a
    prior."""
    x, eps = ctx.input("X"), ctx.attr("epsilon", 0.0)
    if ctx.has_input("PriorDist"):
        return {"Out": (1 - eps) * x + eps * ctx.input("PriorDist")}
    return {"Out": (1 - eps) * x + eps / x.shape[-1]}


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


def _row_grads(ctx: ExecContext, width_dtype=None):
    """(rows int32 [K], values [K, W]) of Out@GRAD at Ids, with the rows
    of padding_idx zeroed (kept, so K stays the number of lookups)."""
    og = ctx.input("Out@GRAD")
    rows = _squeeze_ids(ctx.input("Ids")).reshape(-1).to(torch.int32)
    vals = og.reshape(-1, og.shape[-1])
    if width_dtype is not None:
        vals = vals.to(width_dtype)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        vals = vals.masked_fill((rows == padding_idx)[:, None], 0.0)
    return rows, vals


@register_grad_compute("lookup_table")
def lookup_table_grad(ctx: ExecContext):
    """W@GRAD: with is_sparse a SelectedRows (the ids and Out@GRAD's rows,
    height V: the JAX op's row set, no dense [V, W] tensor), else a dense
    scatter-add (`index_add_` into zeros). On CUDA its atomics add repeated
    ids in an order that changes from run to run, so the dense grad is
    reproducible to fp32 rounding, not bit for bit. `index_put_(
    accumulate=True)` is not used: it sorts and checks its indices with
    kernels and a host sync of its own."""
    w, og = ctx.input("W"), ctx.input("Out@GRAD")
    sparse = ctx.attr("is_sparse", False)
    if og is None:
        if sparse:
            return {"W@GRAD": _empty_rows(w.shape[0], w.device)}
        return {"W@GRAD": torch.zeros_like(w)}
    if sparse:
        rows, vals = _row_grads(ctx)
        return {"W@GRAD": SelectedRows(rows, vals, height=w.shape[0])}
    rows, vals = _row_grads(ctx, w.dtype)
    return {"W@GRAD": torch.zeros_like(w).index_add_(0, rows.long(), vals)}


def _empty_rows(height, device):
    return SelectedRows(torch.zeros((0,), dtype=torch.int32, device=device),
                        torch.zeros((0, 1), device=device), height=height)


@register_op("lookup_table_grad_rows", grad="none")
def lookup_table_grad_rows(ctx: ExecContext):
    """The row gradient of a table that is not in this scope (the JAX
    package's distributed lookup, nn_ops.py:945): the SelectedRows of Ids
    and Out@GRAD alone, height from the attr; an empty row set where
    Out@GRAD was never produced."""
    height = int(ctx.attr("height"))
    if ctx.input("Out@GRAD") is None:
        return {"W@GRAD": _empty_rows(height, ctx.device)}
    rows, vals = _row_grads(ctx)
    return {"W@GRAD": SelectedRows(rows, vals, height=height)}


def _no_grad_ops_maker(op, block, no_grad_set=frozenset()):
    """Grad maker for state-plumbing ops that sit ON the gradient path but
    contribute no gradient ops of their own (the tiered cache install: the
    cache gradient is produced entirely by tiered_lookup's grad and applied
    by the optimizer to the post-install value)."""
    return []


@register_op("emb_cache_install", grad=_no_grad_ops_maker)
def emb_cache_install(ctx: ExecContext):
    """Land this batch's prefetched host rows in the device cache (tiered
    embeddings; the JAX op at nn_ops.py:843). `Out` is the cache with the
    rows installed, written back to the SAME cache var; `Evicted` is the
    PRE-install contents of the overwritten slots, gathered before the
    install into a fresh tensor (never a view of the cache): exactly the
    evicted rows, carrying every optimizer update they ever received, which
    the engine writes back to the host tier once the step completes.
    Padding entries point at the masked scratch slot and install zeros."""
    cache, rows, slots = (ctx.input("Cache"), ctx.input("Rows"),
                          ctx.input("Slots"))
    idx = slots.reshape(-1).long()
    evicted = cache.index_select(0, idx)
    out = cache.index_copy(0, idx, rows.reshape(-1, cache.shape[-1])
                           .to(cache.dtype))
    return {"Out": out, "Evicted": evicted}


@register_op("tiered_lookup")
def tiered_lookup(ctx: ExecContext):
    """lookup_table over the hot-ID cache: ids were mapped to cache slots
    by the host-side resolver (embedding/engine.py), so the step is one
    gather from device memory. Slot `scratch_slot` (the cache's last row)
    marks padding / unresolvable positions and reads as zeros."""
    cache, idsq = ctx.input("Cache"), _squeeze_ids(ctx.input("SlotIds"))
    out = cache[idsq.long()]
    scratch = int(ctx.attr("scratch_slot"))
    return {"Out": out.masked_fill((idsq == scratch)[..., None], 0.0)}


@register_grad_compute("tiered_lookup")
def tiered_lookup_grad(ctx: ExecContext):
    """Cache@GRAD: a dense scatter-add (`index_add_`) over the [slots+1,
    dim] cache — small by construction (the cache, not the table).
    Scratch-slot positions (padding) contribute nothing, mirroring
    lookup_table's padding_idx contract. On CUDA the atomics add repeated
    slots in an order that changes from run to run (ROADMAP Queue 3)."""
    cache, og = ctx.input("Cache"), ctx.input("Out@GRAD")
    if og is None:
        return {"Cache@GRAD": torch.zeros_like(cache)}
    rows = _squeeze_ids(ctx.input("SlotIds")).reshape(-1).long()
    vals = og.reshape(-1, og.shape[-1]).to(cache.dtype)
    scratch = int(ctx.attr("scratch_slot"))
    vals = vals.masked_fill((rows == scratch)[:, None], 0.0)
    return {"Cache@GRAD": torch.zeros_like(cache).index_add_(0, rows, vals)}


# ---------------------------------------------------------------------------
# conv2d, depthwise_conv2d, pool2d: library calls outside any kernel
# ---------------------------------------------------------------------------


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _conv_pads(praw):
    """((top, bottom), (left, right)) from [ph, pw] or the 4-element
    [top, bottom, left, right] of the space-to-depth stem."""
    if isinstance(praw, (list, tuple)) and len(praw) == 4:
        return (praw[0], praw[1]), (praw[2], praw[3])
    p = _pair(praw)
    return (p[0], p[0]), (p[1], p[1])


class _Conv:
    """One conv op's operands in PyTorch's terms. NCHW vars and OIHW
    filters pass as they are. An NHWC var [N, H, W, C] permuted to NCHW
    already is channels-last memory, so it goes in and its result comes out
    without a copy; its HWIO filter is copied once per call into a
    channels-last OIHW tensor (a small copy next to the activations, made
    here in the open and not inside the library). Asymmetric paddings have
    no spelling in F.conv2d: the input is padded explicitly and the conv
    runs unpadded."""

    def __init__(self, ctx: ExecContext):
        x, w = ctx.input("Input"), ctx.input("Filter")
        self.nhwc = ctx.attr("data_format", "NCHW") == "NHWC"
        self.strides = _pair(ctx.attr("strides", [1, 1]))
        self.dilations = _pair(ctx.attr("dilations", [1, 1]))
        self.groups = ctx.attr("groups", 1)
        (top, bottom), (left, right) = _conv_pads(
            ctx.attr("paddings", [0, 0]))
        if self.nhwc:
            x = x.permute(0, 3, 1, 2)
            w = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        self.halo = None
        if getattr(ctx.op, "sp_halo", None) is not None and not ctx.is_meta:
            # H split over the sp ranks (parallel/spatial.py): the rows the
            # rank's output rows read, padding only at the global edges
            from ..parallel.spatial import halo_input

            x, (top, bottom), plan, g = halo_input(
                ctx, x, w.shape[2], self.strides[0], self.dilations[0],
                (top, bottom))
            self.halo = (plan, g)
        self.explicit_pad = None
        self.padding = (top, left)
        if top != bottom or left != right:
            self.explicit_pad = (left, right, top, bottom)
            self.padding = (0, 0)
            x = F.pad(x, self.explicit_pad)
        self.x, self.w = x, w

    def _to_var(self, t):
        """An NCHW-shaped result in the var's own layout, contiguous."""
        return (t.permute(0, 2, 3, 1) if self.nhwc else t).contiguous()

    def forward(self):
        return self._to_var(F.conv2d(self.x, self.w, None, self.strides,
                                     self.padding, self.dilations,
                                     self.groups))

    def backward(self, dout, need_x: bool, need_w: bool):
        """(dInput, dFilter) in the vars' layouts from dOutput in the
        var's layout, by one library call (no forward is redone)."""
        if self.nhwc:
            dout = dout.permute(0, 3, 1, 2)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dout, self.x, self.w, None, self.strides, self.padding,
            self.dilations, False, [0, 0], self.groups,
            [need_x, need_w, False])
        if need_x:
            if self.explicit_pad is not None:
                left, right, top, bottom = self.explicit_pad
                dx = dx[:, :, top:dx.shape[2] - bottom,
                        left:dx.shape[3] - right]
            if self.halo is not None:
                plan, g = self.halo
                dx = plan.return_grads(g, dx.contiguous(), 2)
            dx = self._to_var(dx)
        if need_w:
            dw = (dw.permute(2, 3, 1, 0) if self.nhwc else dw).contiguous()
        return (dx if need_x else None), (dw if need_w else None)


@register_op("conv2d")
def conv2d(ctx: ExecContext):
    return {"Output": _Conv(ctx).forward()}


@register_grad_compute("conv2d")
def conv2d_grad(ctx: ExecContext):
    need_x = "Input@GRAD" in ctx.op.outputs
    need_w = "Filter@GRAD" in ctx.op.outputs
    dout = ctx.input("Output@GRAD")
    if dout is None:
        dx = torch.zeros_like(ctx.input("Input")) if need_x else None
        dw = torch.zeros_like(ctx.input("Filter")) if need_w else None
    else:
        dx, dw = _Conv(ctx).backward(dout, need_x, need_w)
    out = {"Input@GRAD": dx, "Filter@GRAD": dw}
    return {s: g for s, g in out.items() if g is not None}


# the reference registers depthwise as its own type; groups == C_in
register_op("depthwise_conv2d")(conv2d)
register_grad_compute("depthwise_conv2d")(conv2d_grad)


@register_op("conv2d_transpose")
def conv2d_transpose(ctx: ExecContext):
    """The transposed convolution (the gradient of a conv with respect to
    its input), NCHW, filter (C_in, C_out / groups, kh, kw) as the JAX op
    and F.conv_transpose2d both take it: output extent (in - 1) s - 2 p +
    d (k - 1) + 1. The grad is derived by replay."""
    return {"Output": F.conv_transpose2d(
        ctx.input("Input"), ctx.input("Filter"), None,
        _pair(ctx.attr("strides", [1, 1])), _pair(ctx.attr("paddings", [0, 0])),
        0, ctx.attr("groups", 1), _pair(ctx.attr("dilations", [1, 1])))}


@register_op("pool2d")
def pool2d(ctx: ExecContext):
    """Max or average pooling in either layout; `exclusive` averages over
    the window's cells inside the input only. The grad is derived by
    replay."""
    x = ctx.input("X")
    nhwc = ctx.attr("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    k = _pair(ctx.attr("ksize", [2, 2]))
    s = _pair(ctx.attr("strides", [2, 2]))
    p = _pair(ctx.attr("paddings", [0, 0]))
    if getattr(ctx.op, "sp_halo", None) is not None and not ctx.is_meta:
        out = _pool_split(ctx, x, k, s, p)
        return {"Out": (out.permute(0, 2, 3, 1) if nhwc else out).contiguous()}
    if ctx.attr("global_pooling", False):
        k = (x.shape[2], x.shape[3])
        s, p = k, (0, 0)
    if ctx.attr("pooling_type", "max") == "max":
        out = F.max_pool2d(x, k, s, p)
    else:
        out = F.avg_pool2d(x, k, s, p,
                           count_include_pad=not ctx.attr("exclusive", True))
    return {"Out": (out.permute(0, 2, 3, 1) if nhwc else out).contiguous()}


def _pool_split(ctx: ExecContext, x, k, s, p):
    """pool2d of an NCHW x whose H the sequence-parallel rewrite split over
    its ranks (`Operator.sp_halo`, parallel/spatial.py). A global pool is
    this rank's sum (max) over H x W, summed (maxed) over the ranks, the
    sum divided by the global H x W. A windowed pool reads its halo rows
    from the ranks that hold them and pads (with -inf for max, excluded
    from an exclusive average's count) only at the global edges."""
    from ..parallel import spatial

    mark = ctx.op.sp_halo
    is_max = ctx.attr("pooling_type", "max") == "max"
    if mark.get("global"):
        g = spatial.ring_group(ctx, mark["ring"], "pool")
        if is_max:
            return spatial.extreme_over(x, (2, 3), True, "max", [g])
        total = spatial.sum_over(g, x.float().sum(dim=(2, 3), keepdim=True),
                                 "sp global pool")
        return (total / (mark["extent_in"] * x.shape[3])).to(x.dtype)
    xe, (top, bottom), _, _ = spatial.halo_input(ctx, x, k[0], s[0], 1,
                                                 (p[0], p[0]))
    xe = F.pad(xe, (0, 0, top, bottom),
               value=float("-inf") if is_max else 0.0)
    if is_max:
        return F.max_pool2d(xe, k, s, (0, p[1]))
    out = F.avg_pool2d(xe, k, s, (0, p[1]), count_include_pad=True)
    if ctx.attr("exclusive", True):
        real = torch.ones((1, 1, xe.shape[2], xe.shape[3]), dtype=xe.dtype,
                          device=xe.device)
        real[:, :, :top] = 0
        real[:, :, xe.shape[2] - bottom:] = 0
        out = out / F.avg_pool2d(real, k, s, (0, p[1]),
                                 count_include_pad=True)
    return out


# ---------------------------------------------------------------------------
# batch_norm, conv2d_bn: torch reductions for the statistics, K8/K9 for
# the apply chain
# ---------------------------------------------------------------------------


def _bn_rows(x, nhwc: bool):
    """x in K8/K9's canonical 2-D layout: (mode, x2, C)."""
    x = x.contiguous()
    if nhwc:
        C = x.shape[-1]
        return "cl", x.reshape(-1, C), C
    N, C = x.shape[0], x.shape[1]
    return "cr", x.reshape(N * C, -1), C


def _per_channel(t2, mode, C):
    """t2 [R, row] viewed so that a [C] vector broadcasts over it, and the
    dims to reduce for a per-channel sum."""
    if mode == "cl":
        return t2, (0,), (1, C)
    return t2.reshape(-1, C, t2.shape[1]), (0, 2), (1, C, 1)


def _batch_stats(x2, mode, C):
    """Per-channel mean and the one-pass variance E[x^2] - E[x]^2 in fp32,
    the JAX op's formula."""
    xv, dims, _ = _per_channel(x2.float(), mode, C)
    mean = xv.mean(dim=dims)
    return mean, (xv * xv).mean(dim=dims) - mean * mean


def _sync_group(ctx: ExecContext):
    """The group whose ranks a training batch norm takes its statistics
    over: the with_data_parallel rewrite marks the op (and its grad op)
    with its ring (`Operator.dp_sync`, parallel/sharding.py); None for an
    op it did not mark. A marked op in a run that binds no group for that
    ring raises: it never falls back to local statistics."""
    from .collective_ops import AXIS_ENV_KEY

    ring = getattr(ctx.op, "dp_sync", None)
    if ring is None:
        return None
    g = (ctx.env.get(AXIS_ENV_KEY) or {}).get(ring)
    if g is None:
        raise RuntimeError(
            f"{ctx.op.type}: marked to sync its batch statistics over ring "
            f"{ring}, which this run binds to no group")
    return g


def _sync_sum(g, t, what):
    """t summed over the group's ranks (every rank gets the same bits)."""
    from .collective_ops import _all_reduce

    return _all_reduce(g, t.contiguous(), "sum", what)


def _sp_sync(ctx: ExecContext):
    """(group, the split dim in x's layout, its global extent) for a batch
    norm the sequence-parallel rewrite marked (`Operator.sp_sync`,
    parallel/spatial.py), else None."""
    mark = getattr(ctx.op, "sp_sync", None)
    if mark is None:
        return None
    from ..parallel.spatial import ring_group

    return (ring_group(ctx, mark[0], "sync its batch statistics"),) + \
        tuple(mark[1:])


def _global_count(x_shape, mode, dp, sp) -> int:
    """The rows of a channel over every rank a synced batch norm spans:
    the rank's rows with the split dim at its global extent, times the
    data-parallel ranks (whose shares are equal)."""
    cdim = len(x_shape) - 1 if mode == "cl" else 1
    n = 1
    for i, d in enumerate(x_shape):
        if i == sp[1]:
            n *= sp[2]
        elif i != cdim:
            n *= d
    return n * (dp.size if dp is not None else 1)


def _split_stats(dp, sp, x2, x_shape, mode, C):
    """The global statistics of a batch norm split over sp (uneven shares:
    the sums of x and x^2 over the ranks divided by the global count)."""
    xv, dims, _ = _per_channel(x2.float(), mode, C)
    t = torch.stack([xv.sum(dim=dims), (xv * xv).sum(dim=dims)])
    for g in (dp, sp[0]):
        if g is not None:
            t = _sync_sum(g, t, "sync batch norm stats")
    t = t / _global_count(x_shape, mode, dp, sp)
    return t[0], t[1] - t[0] * t[0]


def _synced_stats(g, x2, mode, C):
    """The global batch's mean and E[x^2] - mean^2, from each rank's means
    of x and x^2 averaged over the ranks (their shares are equal, so this
    is the global mean; with one rank, `_batch_stats`' bits)."""
    xv, dims, _ = _per_channel(x2.float(), mode, C)
    m = _sync_sum(g, torch.stack([xv.mean(dim=dims), (xv * xv).mean(dim=dims)]),
                  "sync batch norm stats")
    m = m / g.size
    return m[0], m[1] - m[0] * m[0]


def _bn_forward(ctx: ExecContext, x, nhwc: bool, training: bool):
    """What batch_norm and conv2d_bn share after x exists: statistics (over
    the ranks for an op the data-parallel rewrite synced), running-stat
    updates, the K8 apply (with the act and Residual a pass folded in), and
    the stash for the grad op."""
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    mean, var = ctx.input("Mean"), ctx.input("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    mode, x2, C = _bn_rows(x, nhwc)
    sync = _sync_group(ctx) if training else None
    sp = _sp_sync(ctx) if training else None
    if training:
        # from x2 detached: inside a replay, K9's chain mode carries the
        # statistics' own gradient
        if sp is not None:
            use_mean, use_var = _split_stats(sync, sp, x2.detach(), x.shape,
                                             mode, C)
        elif sync is None:
            use_mean, use_var = _batch_stats(x2.detach(), mode, C)
        else:
            use_mean, use_var = _synced_stats(sync, x2.detach(), mode, C)
        mean_out = mean * momentum + use_mean.to(mean.dtype) * (1 - momentum)
        var_out = var * momentum + use_var.to(var.dtype) * (1 - momentum)
        inv = 1.0 / torch.sqrt(use_var + eps)
        saved_mean, saved_var = use_mean.to(mean.dtype), inv.to(var.dtype)
    else:
        use_mean, mean_out, var_out = mean.float(), mean, var
        inv = 1.0 / torch.sqrt(var.float() + eps)
        saved_mean, saved_var = torch.zeros_like(mean), torch.zeros_like(var)
    res = ctx.input("Residual") if ctx.has_input("Residual") else None
    res2 = None if res is None else res.contiguous().reshape(x2.shape)
    args = (x2, scale.float().contiguous(), bias.float().contiguous(),
            use_mean.contiguous(), inv.contiguous(), res2)
    act = ctx.attr("act", "") or "identity"
    if under_autograd(*args):
        if sync is not None or sp is not None:
            raise NotImplementedError(
                f"{ctx.op.type}: a batch norm synced over ranks inside a "
                f"replayed grad (ROADMAP Queue 1, \"parallel and "
                f"distributed\")")
        y2 = _BatchNormFn.apply(*args, act, mode,
                                x2.numel() // C if training else None)
    else:
        y2 = bn_apply_act(*args[:5], act, res2, mode)
    if ctx.stash is not None:
        ctx.stash[ctx.op.outputs["Y"][0]] = (x2, use_mean, inv, mode, x.shape)
    return {"Y": y2.reshape(x.shape), "MeanOut": mean_out,
            "VarianceOut": var_out, "SavedMean": saved_mean,
            "SavedVariance": saved_var}


def _bn_backward(ctx: ExecContext, training: bool):
    """dx of the op's x (the conv output for conv2d_bn) and the
    Scale/Bias/Residual grads, all from one K9 call: it sums P1 and P2,
    folds them into dscale and dbias and, in training, the coefficients of
    the statistics' own chain (`bn_fold`: var = E[x^2] - mean^2, M the
    count per channel), which it adds to dx in its registers before dx's one
    rounding, as the JAX op adds it in fp32 and casts once; most of dx
    cancels in it, so a bf16 dx_apply would carry its rounding into the
    result many times over. Cotangents of the statistics outputs (SavedMean,
    SavedVariance, MeanOut, VarianceOut) join the chain's dmean and dvar in
    the fold. In test mode the statistics are inputs and only the apply
    part flows (those outputs do not depend on x then). A batch norm synced
    over ranks runs K9's split mode: this rank's sums, their sum over the
    ranks, then the chain from the summed sums with the global M, so
    dscale and dbias come out global on every rank."""
    y_name = ctx.op.inputs["Y" + GRAD_SUFFIX][0][:-len(GRAD_SUFFIX)]
    saved = None if ctx.stash is None else ctx.stash.get(y_name)
    if saved is None:
        raise RuntimeError(
            f"{ctx.op.type}: the forward op that wrote '{y_name}' did not "
            f"run in this executor run, so its statistics are not stashed")
    x2, use_mean, inv, mode, x_shape = saved
    scale = ctx.input("Scale").float().contiguous()
    bias = ctx.input("Bias").float().contiguous()
    dy = ctx.input("Y" + GRAD_SUFFIX)
    dy2 = (torch.zeros_like(x2) if dy is None
           else dy.to(x2.dtype).contiguous().reshape(x2.shape))
    res = ctx.input("Residual") if ctx.has_input("Residual") else None
    res2 = None if res is None else res.contiguous().reshape(x2.shape)
    act = ctx.attr("act", "") or "identity"
    args = (x2, scale, bias, use_mean.contiguous(), inv.contiguous(), dy2)
    count = x2.numel() // scale.shape[0] if training else None
    extra = None
    if training:
        extra = stat_cotangents(
            inv, ctx.attr("momentum", 0.9),
            *(ctx.input(s + GRAD_SUFFIX) for s in
              ("SavedMean", "SavedVariance", "MeanOut", "VarianceOut")))
    sync = _sync_group(ctx) if training else None
    sp = _sp_sync(ctx) if training else None
    if sync is None and sp is None:
        dx2, dres2, _, _, dscale, dbias = bn_apply_act_backward(
            *args, act, res2, mode, count,
            **({} if extra is None else {"extra": extra}))
    else:
        sums = bn_apply_act_backward_sums(*args, act, res2, mode)[:2]
        for g in (sync, None if sp is None else sp[0]):
            if g is not None:
                sums = _sync_sum(g, sums, "sync batch norm sums")
        total = (count * sync.size if sp is None
                 else _global_count(x_shape, mode, sync, sp))
        dx2, dres2, _, _, dscale, dbias = bn_apply_act_backward_chain(
            *args, sums, total, act, res2, mode, extra)
    out = {"Scale@GRAD": dscale.to(ctx.input("Scale").dtype),
           "Bias@GRAD": dbias.to(ctx.input("Bias").dtype)}
    if res is not None:
        out["Residual@GRAD"] = dres2.reshape(res.shape)
    return dx2.reshape(x_shape), out


class _BatchNormFn(torch.autograd.Function):
    """The K8 apply, K9 its backward (as the registered grad runs it), for
    a batch norm inside a replayed grad. With `count` (M, the rows of a
    channel: training) K9 runs its chain mode, which adds the batch
    statistics' own chain to dx, so mean and inv come in detached; in test
    mode they derive from the running statistics and take their gradients
    from K9's sums (`bn_param_grads`)."""

    @staticmethod
    def forward(fctx, x2, scale, bias, mean, inv, res2, act, mode, count):
        fctx.save_for_backward(x2, scale, bias, mean, inv, res2)
        fctx.act, fctx.mode, fctx.count = act, mode, count
        return bn_apply_act(x2, scale, bias, mean, inv, act, res2, mode)

    @staticmethod
    def backward(fctx, dy2):
        x2, scale, bias, mean, inv, res2 = fctx.saved_tensors
        dx2, dres2, p1, p2, dscale, dbias = bn_apply_act_backward(
            x2, scale, bias, mean, inv, dy2.to(x2.dtype).contiguous(),
            fctx.act, res2, fctx.mode, fctx.count)
        dmean = dinv = None
        if fctx.count is None and any(fctx.needs_input_grad[3:5]):
            _, _, dmean, dinv = bn_param_grads(p1, p2, scale, inv)
        return dx2, dscale, dbias, dmean, dinv, dres2, None, None, None


@register_op("batch_norm")
def batch_norm(ctx: ExecContext):
    """Training mode normalizes by the batch statistics and moves the
    running ones; is_test normalizes by the running ones. Either way the
    apply chain is one K8 call."""
    return _bn_forward(ctx, ctx.input("X"),
                       ctx.attr("data_layout", "NCHW") != "NCHW",
                       not ctx.attr("is_test", False))


@register_grad_compute("batch_norm")
def batch_norm_grad(ctx: ExecContext):
    out_x, out = _bn_backward(ctx, not ctx.attr("is_test", False))
    out["X@GRAD"] = out_x
    return {s: g for s, g in out.items() if s in ctx.op.outputs}


@register_op("conv2d_bn")
def conv2d_bn(ctx: ExecContext):
    """conv2d -> batch_norm(training) as one op (passes.fuse_conv_bn_stats
    builds it). The statistics come from the fp32 conv output; the program
    has no var for that output, so it is stashed for the grad op beside the
    statistics (no more memory than the unfused program's conv output var
    holds for its run)."""
    return _bn_forward(ctx, _Conv(ctx).forward(),
                       ctx.attr("data_format", "NCHW") != "NCHW", True)


@register_grad_compute("conv2d_bn")
def conv2d_bn_grad(ctx: ExecContext):
    """K9 and the statistics chain give the conv output's grad; one
    library call turns it into Input@GRAD and Filter@GRAD."""
    dconv, out = _bn_backward(ctx, True)
    conv = _Conv(ctx)
    dx, dw = conv.backward(dconv, "Input@GRAD" in ctx.op.outputs,
                           "Filter@GRAD" in ctx.op.outputs)
    out["Input@GRAD"], out["Filter@GRAD"] = dx, dw
    return {s: g for s, g in out.items()
            if s in ctx.op.outputs and g is not None}


@register_op("accuracy", grad="none")
def accuracy(ctx: ExecContext):
    """The share of rows whose top-k Indices hold the Label."""
    idx, label = ctx.input("Indices"), ctx.input("Label")
    lbl = label.reshape(-1, 1)
    num_correct = (idx == lbl).any(dim=1).sum().to(torch.int32)
    total = torch.full((), lbl.shape[0], dtype=torch.int32, device=idx.device)
    return {"Accuracy": (num_correct / total).float().reshape(1),
            "Correct": num_correct.reshape(1), "Total": total.reshape(1)}


# ---------------------------------------------------------------------------
# The long tail of the JAX package's nn_ops.py: torch compositions, as the
# JAX ops are XLA; grads by replay unless registered.
# ---------------------------------------------------------------------------


@register_op("log_softmax")
def log_softmax(ctx: ExecContext):
    return {"Out": F.log_softmax(ctx.input("X"), dim=ctx.attr("axis", -1))}


@register_op("smooth_l1_loss")
def smooth_l1_loss(ctx: ExecContext):
    """Per row sum of the smooth L1 of (X - Y) * InsideWeight (quadratic
    below 1 / sigma^2), times OutsideWeight; Diff the weighted difference."""
    x, y = ctx.input("X"), ctx.input("Y")
    s2 = ctx.attr("sigma", 1.0) ** 2
    d = x - y
    if ctx.has_input("InsideWeight"):
        d = d * ctx.input("InsideWeight")
    a = torch.abs(d)
    loss = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    if ctx.has_input("OutsideWeight"):
        loss = loss * ctx.input("OutsideWeight")
    return {"Out": torch.sum(loss, dim=-1, keepdim=True), "Diff": d}


def _channel_affine(ctx: ExecContext, y, c, nd):
    bshape = [1, c] + [1] * (nd - 2)
    if ctx.has_input("Scale"):
        y = y * ctx.input("Scale").reshape(bshape)
    if ctx.has_input("Bias"):
        y = y + ctx.input("Bias").reshape(bshape)
    return y


@register_op("group_norm")
def group_norm(ctx: ExecContext):
    """NCHW group norm in fp32: each sample's `groups` channel groups
    normalized by their own mean and (population) variance, then the
    per-channel Scale and Bias; Mean and Variance [N, groups]."""
    x = ctx.input("X")
    groups, eps = ctx.attr("groups"), ctx.attr("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:])).to(torch.float32)
    axes = tuple(range(2, xg.dim()))
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.var(xg, dim=axes, keepdim=True, unbiased=False)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    y = _channel_affine(ctx, y, c, x.dim())
    return {"Y": y.to(x.dtype), "Mean": mean.reshape(n, groups),
            "Variance": var.reshape(n, groups)}


@register_op("instance_norm")
def instance_norm(ctx: ExecContext):
    """NCHW instance norm in fp32: each (sample, channel) map normalized
    by its own statistics, then Scale and Bias."""
    x = ctx.input("X")
    xf = x.to(torch.float32)
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.var(xf, dim=axes, keepdim=True, unbiased=False)
    y = (xf - mean) / torch.sqrt(var + ctx.attr("epsilon", 1e-5))
    return {"Y": _channel_affine(ctx, y, x.shape[1], x.dim()).to(x.dtype)}


# lookup_table_v2 is lookup_table (its dense or SelectedRows grad too)
register_op("lookup_table_v2")(lookup_table)
register_grad_compute("lookup_table_v2")(lookup_table_grad)


@register_op("prelu")
def prelu(ctx: ExecContext):
    """where(x >= 0, x, alpha x), alpha one scalar ("all"), one a channel
    ("channel") or one an element of a sample ("element")."""
    x, alpha = ctx.input("X"), ctx.input("Alpha")
    mode = ctx.attr("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    else:
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {"Out": torch.where(x >= 0, x, x * a)}


def _data_norm_stats(ctx: ExecContext):
    bsize = ctx.input("BatchSize").to(torch.float32)
    bsum = ctx.input("BatchSum").to(torch.float32)
    bsq = ctx.input("BatchSquareSum").to(torch.float32)
    return bsize, bsum, bsq, bsum / bsize, torch.sqrt(bsize / bsq)


def _data_norm_grad_maker(op, block, no_grad_set=frozenset()):
    from ..framework import grad_var_name

    outs = {s + "@GRAD": [grad_var_name(op.inputs[s][0])]
            for s in ("X", "BatchSize", "BatchSum", "BatchSquareSum")
            if op.inputs[s][0] not in no_grad_set}
    if not outs:
        return []
    ins = {s: list(op.inputs[s])
           for s in ("X", "BatchSize", "BatchSum", "BatchSquareSum")}
    ins["Y@GRAD"] = [grad_var_name(op.outputs["Y"][0])]
    return [{"type": "data_norm_grad", "inputs": ins, "outputs": outs,
             "attrs": dict(op.attrs)}]


@register_op("data_norm", grad=_data_norm_grad_maker)
def data_norm(ctx: ExecContext):
    """CTR data normalization from accumulated counters: means =
    BatchSum / BatchSize, scales = sqrt(BatchSize / BatchSquareSum), Y =
    (X - means) scales."""
    x = ctx.input("X")
    _, _, _, means, scales = _data_norm_stats(ctx)
    y = (x.to(torch.float32) - means[None, :]) * scales[None, :]
    return {"Y": y.to(x.dtype), "Means": means, "Scales": scales}


@register_grad_compute("data_norm")
def data_norm_grad(ctx: ExecContext):
    """dX = dY scales; the counters' "grads" are this batch's statistics
    (N, the column sums, sum (x - mean)^2 + N epsilon), which the
    optimizer's step folds into the accumulators: not a replay."""
    x = ctx.input("X").to(torch.float32)
    bsize, _, _, means, scales = _data_norm_stats(ctx)
    gy = ctx.input("Y@GRAD")
    N = x.shape[0]
    outs = ctx.op.outputs
    out = {}
    if "X@GRAD" in outs:
        out["X@GRAD"] = (gy.to(torch.float32) * scales[None, :]).to(gy.dtype)
    if "BatchSize@GRAD" in outs:
        out["BatchSize@GRAD"] = torch.full_like(bsize, float(N))
    if "BatchSum@GRAD" in outs:
        out["BatchSum@GRAD"] = x.sum(dim=0)
    if "BatchSquareSum@GRAD" in outs:
        out["BatchSquareSum@GRAD"] = (((x - means[None, :]) ** 2).sum(dim=0)
                                      + float(N) * float(ctx.attr("epsilon", 1e-4)))
    return out


@register_op("spectral_norm")
def spectral_norm(ctx: ExecContext):
    """Weight / sigma_max(Weight) by power_iters rounds of power iteration
    on Weight reshaped to [h, w] around `dim`, from U [h] and V [w]; UOut
    and VOut (U's and V's vars) carry the vectors to the next run. The
    gradient flows to Weight only."""
    w = ctx.input("Weight")
    u = ctx.input("U").reshape(-1).to(torch.float32).detach()
    v = ctx.input("V").reshape(-1).to(torch.float32).detach()
    dim = int(ctx.attr("dim", 0))
    eps = float(ctx.attr("eps", 1e-12))
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    wm = w.permute(perm).reshape(w.shape[dim], -1).to(torch.float32)
    wd = wm.detach()
    for _ in range(int(ctx.attr("power_iters", 1))):
        v = wd.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wd @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ wm @ v
    return {"Out": (w.to(torch.float32) / sigma).to(w.dtype),
            "UOut": u.to(w.dtype), "VOut": v.to(w.dtype)}


@register_op("tree_conv")
def tree_conv(ctx: ExecContext):
    """Tree-based convolution (TBCNN) as the JAX op builds it: per sample
    dense [N+1, N+1] eta matrices (relative depth from powers of the
    adjacency, the continuous left/right weights from each child's index
    among its siblings), one product a component, then the filter.
    NodesVector [B, N, F], EdgeSet [B, E, 2] (parent, child; 1-based, 0
    pads), Filter [F, 3, O, M] -> [B, N, O, M]."""
    feat = ctx.input("NodesVector")
    edges = ctx.input("EdgeSet").long()
    filt = ctx.input("Filter").to(torch.float32)
    D = int(ctx.attr("max_depth", 2))
    B, N, Fd = feat.shape
    E = edges.shape[1]
    dev = feat.device
    u, v = edges[..., 0], edges[..., 1]
    valid = (u > 0) & (v > 0)
    uc = torch.where(valid, u, torch.zeros_like(u))
    vc = torch.where(valid, v, torch.zeros_like(v))
    validf = valid.to(torch.float32)
    # adjacency [B, N+1, N+1] by index_add_ over the linearized (u, v)
    lin = (torch.arange(B, device=dev)[:, None] * (N + 1) + uc) * (N + 1) + vc
    A = torch.zeros(B * (N + 1) * (N + 1), dtype=torch.float32,
                    device=dev).index_add_(0, lin.reshape(-1), validf.reshape(-1))
    A = A.reshape(B, N + 1, N + 1)
    A[:, 0, 0] = 0.0
    eye = torch.eye(N + 1, dtype=torch.bool, device=dev)
    reach = eye.to(torch.float32).expand(B, N + 1, N + 1)
    rel = torch.where(eye, 0, D).expand(B, N + 1, N + 1)
    for r in range(1, D):
        reach = reach @ A
        rel = torch.where((reach > 0) & (rel == D), r, rel)
    in_patch = rel < D
    same = (u[:, :, None] == u[:, None, :]) & valid[:, None, :] & valid[:, :, None]
    ar = torch.arange(E, device=dev)
    earlier = same & (ar[None, :] < ar[:, None])[None]
    idx_e = earlier.sum(dim=2).to(torch.float32) + 1.0
    pclen_e = same.sum(dim=2).to(torch.float32)
    ones = torch.ones(B, N + 1, dtype=torch.float32, device=dev)
    node_index = ones.scatter(1, vc, torch.where(valid, idx_e, 1.0))
    node_pclen = ones.scatter(1, vc, torch.where(valid, pclen_e, 1.0))
    temp = torch.where(node_pclen <= 1.0, 0.5,
                       (node_index - 1.0) / torch.clamp(node_pclen - 1.0, min=1.0))
    eta_t = (D - rel.to(torch.float32)) / float(D)
    temp_uv = torch.where(eye, 0.5, temp[:, None, :])
    eta_l = (1.0 - eta_t) * temp_uv
    eta_r = (1.0 - eta_t) * (1.0 - temp_uv)
    zeros = torch.zeros(B, N + 1, dtype=torch.float32, device=dev)
    exists = zeros.scatter_reduce(1, uc, validf, "amax").scatter_reduce(
        1, vc, validf, "amax")
    exists[:, 1] = 1.0
    exists[:, 0] = 0.0
    mask = in_patch.to(torch.float32) * exists[:, None, :] * exists[:, :, None]
    fpad = torch.cat([torch.zeros(B, 1, Fd, dtype=torch.float32, device=dev),
                      feat.to(torch.float32)], dim=1)
    patch = torch.stack([(eta_l * mask) @ fpad, (eta_r * mask) @ fpad,
                         (eta_t * mask) @ fpad], dim=-1)[:, 1:]
    return {"Out": torch.einsum("bnfc,fcom->bnom", patch, filt).to(feat.dtype)}
