"""Math ops (the JAX package's math_ops.py): mul and its grad, matmul,
the elementwise family (mod and floordiv floor toward minus infinity, as
jnp.mod and jnp.floor_divide), scale, sum, mean, the reductions, the clip
ops, dot, norm, cos_sim, isfinite, mean_iou, the losses (square_error_cost,
cross_entropy2, log, huber, kldiv, rank, margin_rank, bpr, center,
teacher_student_sigmoid), pow and cast. The fc and matmul products go to
torch.matmul, as the JAX package leaves them to XLA. Output dtypes follow
torch's type promotion, which for bfloat16 and float32 is jnp's. No op
here reads a value back to the host."""
from __future__ import annotations

import math

import torch

from ..core.selected_rows import SelectedRows, is_selected_rows
from ..core.types import torch_feed_dtype
from .registry import ExecContext, register_grad_compute, register_op


def _mul_2d(ctx: ExecContext):
    """X and Y of the mul op flattened to the 2-D product's operands."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    return (x, y, x.reshape(math.prod(x.shape[:xn]), -1),
            y.reshape(math.prod(y.shape[:yn]), -1), xn, yn)


@register_op("mul")
def mul(ctx: ExecContext):
    """X flattened at x_num_col_dims times Y flattened at y_num_col_dims;
    the result keeps X's leading and Y's trailing dims."""
    x, y, x2, y2, xn, yn = _mul_2d(ctx)
    out = torch.matmul(x2, y2)
    return {"Out": out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))}


@register_grad_compute("mul")
def mul_grad(ctx: ExecContext):
    """dX = dOut Y^T and dY = X^T dOut as two products: a replay under
    autograd would redo the forward product inside the grad op as well."""
    x, y, x2, y2, _, _ = _mul_2d(ctx)
    dout = ctx.input("Out@GRAD")
    if dout is None:
        dout2 = torch.zeros((x2.shape[0], y2.shape[1]), dtype=x.dtype,
                            device=x.device)
    else:
        dout2 = dout.reshape(x2.shape[0], y2.shape[1])
    out = {}
    if "X@GRAD" in ctx.op.outputs:
        out["X@GRAD"] = torch.matmul(dout2, y2.t()).reshape(x.shape)
    if "Y@GRAD" in ctx.op.outputs:
        out["Y@GRAD"] = torch.matmul(x2.t(), dout2).reshape(y.shape)
    return out


def rounded(v: float, dtype) -> float:
    """v rounded to `dtype`: the value a `jnp.asarray(v, dtype)` operand
    holds."""
    return torch.tensor(v, dtype=dtype).item()


@register_op("matmul")
def matmul(ctx: ExecContext):
    """Batched X @ Y with torch's (numpy's) broadcasting over the leading
    dims, each operand optionally transposed in its last two, times
    `alpha` rounded to the product's dtype first, as the JAX op multiplies
    by `jnp.asarray(alpha, out.dtype)`. The grad is derived by replay."""
    x, y = ctx.input("X"), ctx.input("Y")
    if ctx.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * rounded(alpha, out.dtype)
    return {"Out": out}


def _bcast_y(x, y, axis: int):
    """Align y's dims to x[axis : axis + y.ndim], padding trailing 1s."""
    if x.shape == y.shape:
        return y
    if y.dim() > x.dim():
        raise ValueError(f"elementwise op: Y rank {y.dim()} exceeds X rank "
                         f"{x.dim()} ({tuple(y.shape)} vs {tuple(x.shape)})")
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    new_shape = [1] * x.dim()
    for i, d in enumerate(y.shape):
        new_shape[axis + i] = d
    return y.reshape(new_shape)


def _ew(fn):
    def compute(ctx: ExecContext):
        x, y = ctx.input("X"), ctx.input("Y")
        return {"Out": fn(x, _bcast_y(x, y, ctx.attr("axis", -1)))}

    return compute


register_op("elementwise_add")(_ew(torch.add))
register_op("elementwise_sub")(_ew(torch.sub))
register_op("elementwise_mul")(_ew(torch.mul))
register_op("elementwise_div")(_ew(torch.div))
register_op("elementwise_max")(_ew(torch.maximum))
register_op("elementwise_min")(_ew(torch.minimum))
register_op("elementwise_pow")(_ew(torch.pow))
register_op("elementwise_mod", grad="none")(_ew(torch.remainder))
register_op("elementwise_floordiv", grad="none")(
    _ew(lambda x, y: torch.div(x, y, rounding_mode="floor")))


@register_op("scale")
def scale(ctx: ExecContext):
    x = ctx.input("X")
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


@register_op("sum")
def sum_op(ctx: ExecContext):
    """Adds its inputs; inputs never produced are skipped, as in the JAX
    op. SelectedRows inputs merge by row concatenation: all sparse stays
    sparse (the rows of several lookups of one table), a sparse/dense mix
    densifies."""
    xs = [x for x in ctx.inputs("X") if x is not None]
    if any(is_selected_rows(x) for x in xs):
        if all(is_selected_rows(x) for x in xs):
            return {"Out": SelectedRows(torch.cat([x.rows for x in xs]),
                                        torch.cat([x.values for x in xs]),
                                        xs[0].height)}
        xs = [x.to_dense() if is_selected_rows(x) else x for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean")
def mean(ctx: ExecContext):
    return {"Out": torch.mean(ctx.input("X"))}


def _reduce(fn):
    def compute(ctx: ExecContext):
        x = ctx.input("X")
        if ctx.attr("reduce_all", False):
            axes = tuple(range(x.dim()))
        else:
            dims = ctx.attr("dim", [0])
            axes = tuple(d % x.dim() for d in
                         (dims if isinstance(dims, (list, tuple)) else [dims]))
        keep = ctx.attr("keep_dim", False)
        if getattr(ctx.op, "global_reduce", None) and not ctx.is_meta:
            # X is split over ranks along a reduced dim (a parallel
            # rewrite's mark): the reduction runs over every rank's share
            from ..parallel.spatial import global_reduce

            return {"Out": global_reduce(ctx, x, ctx.op.type[len("reduce_"):],
                                         axes, keep, fn)}
        return {"Out": fn(x, dim=axes, keepdim=keep)}

    return compute


def _prod(x, dim, keepdim):
    """torch.prod over several dims, one at a time from the last, in X's
    dtype (torch would widen an int32 product to int64; jnp keeps int32)."""
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim, dtype=x.dtype)
    return x


register_op("reduce_sum")(_reduce(torch.sum))
register_op("reduce_mean")(_reduce(torch.mean))
# amax/amin share a tie's gradient evenly, as jnp.max's does
register_op("reduce_max")(_reduce(torch.amax))
register_op("reduce_min")(_reduce(torch.amin))
register_op("reduce_prod")(_reduce(_prod))
register_op("reduce_all", grad="none")(_reduce(torch.all))
register_op("reduce_any", grad="none")(_reduce(torch.any))


@register_op("clip")
def clip(ctx: ExecContext):
    return {"Out": torch.clamp(ctx.input("X"), ctx.attr("min"), ctx.attr("max"))}


@register_op("clip_by_norm")
def clip_by_norm(ctx: ExecContext):
    x = ctx.input("X")
    max_norm = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": torch.where(norm > max_norm, x * (max_norm / norm), x)}


@register_op("squared_l2_norm")
def squared_l2_norm(ctx: ExecContext):
    return {"Out": torch.sum(torch.square(ctx.input("X"))).reshape(1)}


@register_op("square_error_cost")
def square_error_cost(ctx: ExecContext):
    return {"Out": torch.square(ctx.input("X") - ctx.input("Y"))}


@register_op("cross_entropy2")
def cross_entropy2(ctx: ExecContext):
    """Hard-label cross entropy on probabilities (reference
    cross_entropy_op.cc's cross_entropy2 kernel) that also emits MatchX =
    x[label], 1 where the label equals ignore_index (loss 0, no gradient),
    and an empty XShape; -log of max(MatchX, 1e-20), torch.maximum
    splitting a tie's gradient as jnp.maximum does. The grad is derived by
    replay."""
    x, label = ctx.input("X"), ctx.input("Label")
    if label.dim() == x.dim():
        label = label.reshape(label.shape[:-1])
    label = label.long()
    ignore = label == int(ctx.attr("ignore_index", -100))
    match = x.gather(-1, label.masked_fill(ignore, 0)[..., None])
    match = match.masked_fill(ignore[..., None], 1.0)
    loss = -torch.log(torch.maximum(match, torch.full_like(match, 1e-20)))
    return {"Y": loss.to(x.dtype), "MatchX": match,
            "XShape": torch.zeros(0, dtype=x.dtype, device=x.device)}


@register_op("pow")
def pow_op(ctx: ExecContext):
    """X to the power `factor`, the factor rounded to X's dtype first (the
    JAX op's jnp.asarray(factor, x.dtype))."""
    x = ctx.input("X")
    return {"Out": torch.pow(x, rounded(ctx.attr("factor", 1.0), x.dtype))}


@register_op("cast")
def cast(ctx: ExecContext):
    """X as out_dtype (a 64-bit dtype narrows to 32 bits, the feed rule).
    The grad is derived by replay: autograd's grad of `x.to(dtype)` is the
    cotangent cast back to X's dtype, so a bf16 view of an fp32 parameter
    hands the parameter an fp32 gradient."""
    return {"Out": ctx.input("X").to(torch_feed_dtype(ctx.attr("out_dtype")))}


@register_op("dot")
def dot(ctx: ExecContext):
    return {"Out": torch.sum(ctx.input("X") * ctx.input("Y"), dim=-1,
                             keepdim=True)}


@register_op("norm")
def norm(ctx: ExecContext):
    """X / sqrt(sum(X^2, axis) + epsilon) and that norm (l2_normalize)."""
    x = ctx.input("X")
    n = torch.sqrt(torch.sum(torch.square(x), dim=ctx.attr("axis", -1),
                             keepdim=True) + ctx.attr("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


@register_op("cos_sim")
def cos_sim(ctx: ExecContext):
    """Row cosine of X and Y over the last dim, with the two norms (no
    epsilon: a zero row gives NaN, as in the JAX op)."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    return {"Out": torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn),
            "XNorm": xn, "YNorm": yn}


@register_op("isfinite", grad="none")
def isfinite(ctx: ExecContext):
    """One bool [1]: every element finite (kept on the device)."""
    return {"Out": torch.isfinite(ctx.input("X")).all().reshape(1)}


@register_op("log_loss")
def log_loss(ctx: ExecContext):
    p, y = ctx.input("Predicted"), ctx.input("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    return {"Loss": -y * torch.log(p + eps) - (1.0 - y) * torch.log(1.0 - p + eps)}


@register_op("huber_loss")
def huber_loss(ctx: ExecContext):
    x, y = ctx.input("X"), ctx.input("Y")
    delta = ctx.attr("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    out = torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))
    return {"Out": out, "Residual": r}


@register_op("kldiv_loss")
def kldiv_loss(ctx: ExecContext):
    """target * (log(target) - X), X log-probabilities, reduced by
    `reduction` (mean, sum, batchmean or none)."""
    x, t = ctx.input("X"), ctx.input("Target")
    loss = t * (torch.log(torch.clamp(t, min=1e-10)) - x)
    red = ctx.attr("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss)
    elif red == "sum":
        loss = torch.sum(loss)
    elif red == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    return {"Loss": loss}


@register_op("rank_loss")
def rank_loss(ctx: ExecContext):
    """RankNet's pairwise loss log(1 + e^d) - label d, d = left - right."""
    label = ctx.input("Label")
    d = ctx.input("Left") - ctx.input("Right")
    return {"Out": torch.logaddexp(torch.zeros_like(d), d) - label * d}


@register_op("margin_rank_loss")
def margin_rank_loss(ctx: ExecContext):
    label, x1, x2 = ctx.input("Label"), ctx.input("X1"), ctx.input("X2")
    out = torch.clamp(-label * (x1 - x2) + float(ctx.attr("margin", 0.0)),
                      min=0.0)
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("bpr_loss")
def bpr_loss(ctx: ExecContext):
    """Bayesian personalized ranking over logits [B, C] with the positive
    column Label [B, 1]: the mean over the C - 1 negatives of
    -log(sigmoid(pos - x) + 1e-10)."""
    x = ctx.input("X")
    lbl = ctx.input("Label").reshape(-1).long()
    diff = x.gather(1, lbl[:, None]) - x
    lse = -torch.log(torch.sigmoid(diff) + 1e-10)
    C = x.shape[1]
    neg = torch.arange(C, device=x.device) != lbl[:, None]
    return {"Y": (lse * neg.to(x.dtype)).sum(dim=1, keepdim=True) / (C - 1)}


@register_op("mean_iou", grad="none")
def mean_iou(ctx: ExecContext):
    """Mean intersection over union across num_classes, counted by
    index_add_ on the device (no host read); OutWrong counts a mismatch
    for both its predicted and its label class, as the reference does."""
    pred = ctx.input("Predictions").reshape(-1).long()
    label = ctx.input("Labels").reshape(-1).long()
    n = int(ctx.attr("num_classes"))

    def count(idx, vals):
        return torch.zeros(n, dtype=torch.float32,
                           device=pred.device).index_add_(0, idx, vals)

    ones = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
    inter = count(pred, (pred == label).to(torch.float32))
    pred_c, lbl_c = count(pred, ones), count(label, ones)
    union = pred_c + lbl_c - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1.0),
                      torch.zeros_like(union))
    miou = iou.sum() / torch.clamp(valid.sum().to(torch.float32), min=1.0)
    return {"OutMeanIou": miou, "OutWrong": (pred_c - inter) + (lbl_c - inter),
            "OutCorrect": inter}


@register_op("center_loss")
def center_loss(ctx: ExecContext):
    """0.5 ||x_i - c_{y_i}||^2 a row, and with need_update CentersOut =
    Centers - alpha sum_i (c_{y_i} - x_i) / (1 + count(y_i)) (written back
    to the Centers var: one update a run). alpha is CenterUpdateRate's
    element, read on the device. The centers take no gradient."""
    x = ctx.input("X")
    label = ctx.input("Label").reshape(-1).long()
    centers = ctx.input("Centers")
    diff = x - centers.detach().index_select(0, label)
    loss = 0.5 * torch.sum(diff.to(torch.float32) ** 2, dim=1, keepdim=True)
    out = {"Loss": loss.to(x.dtype), "SampleCenterDiff": diff}
    if bool(ctx.attr("need_update", True)):
        rate = ctx.input("CenterUpdateRate")
        alpha = (rate.reshape(-1)[0] if rate is not None
                 else float(ctx.attr("alpha", 0.1)))
        cnt = torch.ones(centers.shape[0], dtype=torch.float32,
                         device=x.device).index_add_(
            0, label, torch.ones(label.shape, dtype=torch.float32,
                                 device=x.device))
        acc = torch.zeros_like(centers).index_add_(
            0, label, -diff.detach().to(centers.dtype))
        out["CentersOut"] = (centers - (alpha / cnt)[:, None] * acc).detach()
    else:
        out["CentersOut"] = centers
    return out


class _TeacherStudentFn(torch.autograd.Function):
    """The distillation CTR loss: softplus(x) (label < -1), softplus(x) - x
    (label < 0), else 2 softplus(x) - x label; its backward is the
    reference's, with the sigmoid's argument clipped to [lo, up] and dX
    zero at saturation (the JAX op's custom vjp)."""

    @staticmethod
    def forward(ctx, x, label, lo, up):
        ctx.save_for_backward(x, label)
        ctx.bounds = (lo, up)
        sp = torch.logaddexp(torch.zeros_like(x), x)
        return torch.where(label < -1.0, sp,
                           torch.where(label < 0.0, sp - x, 2.0 * sp - x * label))

    @staticmethod
    def backward(ctx, dy):
        x, label = ctx.saved_tensors
        lo, up = ctx.bounds
        pred = torch.sigmoid(torch.clamp(x, lo, up))
        dydx = torch.where(label < -1.0, pred,
                           torch.where(label < 0.0, pred - 1.0, 2.0 * pred - label))
        dydx = torch.where((x >= up) | (x <= lo), torch.zeros_like(dydx), dydx)
        return dydx * dy, torch.zeros_like(label), None, None


@register_op("teacher_student_sigmoid_loss")
def teacher_student_sigmoid_loss(ctx: ExecContext):
    x = ctx.input("X")
    label = ctx.input("Label").reshape(-1).to(torch.float32)
    y = _TeacherStudentFn.apply(
        x.reshape(-1).to(torch.float32), label,
        float(ctx.attr("soft_max_lower_bound", -15.0)),
        float(ctx.attr("soft_max_up_bound", 15.0)))
    return {"Y": y.reshape(-1, 1).to(x.dtype)}
