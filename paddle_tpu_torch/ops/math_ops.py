"""Math ops (the JAX package's math_ops.py): mul and its grad, matmul,
the elementwise family, scale, sum, mean, reduce_sum/reduce_mean, the clip
ops, square_error_cost, cross_entropy2, pow and cast. The fc and matmul
products go to torch.matmul, as the JAX package leaves them to XLA. Output
dtypes follow torch's type promotion, which for bfloat16 and float32 is
jnp's."""
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
        return {"Out": fn(x, dim=axes, keepdim=ctx.attr("keep_dim", False))}

    return compute


register_op("reduce_sum")(_reduce(torch.sum))
register_op("reduce_mean")(_reduce(torch.mean))


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
