"""Math ops (the JAX package's math_ops.py): mul and its grad, the
elementwise family, scale, sum, reduce_sum and the clip ops. The fc
products go to torch.matmul, as the JAX package leaves them to XLA."""
from __future__ import annotations

import math

import torch

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
register_op("elementwise_mul")(_ew(torch.mul))
register_op("elementwise_div")(_ew(torch.div))
register_op("elementwise_max")(_ew(torch.maximum))


@register_op("scale")
def scale(ctx: ExecContext):
    x = ctx.input("X")
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


@register_op("sum")
def sum_op(ctx: ExecContext):
    """Adds its inputs (dense only; the JAX package's SelectedRows merge is
    not ported). Inputs never produced are skipped, as in the JAX op."""
    xs = [x for x in ctx.inputs("X") if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("reduce_sum")
def reduce_sum(ctx: ExecContext):
    x = ctx.input("X")
    if ctx.attr("reduce_all", False):
        axes = tuple(range(x.dim()))
    else:
        dims = ctx.attr("dim", [0])
        axes = tuple(d % x.dim() for d in
                     (dims if isinstance(dims, (list, tuple)) else [dims]))
    return {"Out": torch.sum(x, dim=axes, keepdim=ctx.attr("keep_dim", False))}


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
