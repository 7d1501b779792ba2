"""Tensor manipulation and creation ops (the JAX package's tensor_ops.py).
The grads of the manipulation ops are derived by replay (ops/registry.py).

The random op draws from the run's `torch.Generator` (executor.py), keyed
by the program's random_seed and the run counter."""
from __future__ import annotations

import torch

from ..core.types import torch_dtype, torch_feed_dtype
from .registry import ExecContext, register_op

# index outputs are int64 in the API and narrow to int32 at run time, as in
# the JAX package with x64 off
_INDEX_DTYPE = torch_feed_dtype("int64")


@register_op("fill_constant", grad="none")
def fill_constant(ctx: ExecContext):
    shape = tuple(ctx.attr("shape", []))
    dtype = torch_feed_dtype(ctx.attr("dtype", "float32"))
    return {"Out": torch.full(shape, ctx.attr("value", 0.0), dtype=dtype,
                              device=ctx.device)}


@register_op("uniform_random", grad="none", needs_rng=True)
def uniform_random(ctx: ExecContext):
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if ctx.is_meta:
        return {"Out": torch.empty(shape, dtype=dtype, device="meta")}
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    u = torch.rand(shape, generator=ctx.generator, dtype=torch.float32,
                   device=ctx.device)
    return {"Out": (u * (hi - lo) + lo).to(dtype)}


@register_op("gaussian_random", grad="none", needs_rng=True)
def gaussian_random(ctx: ExecContext):
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if ctx.is_meta:
        return {"Out": torch.empty(shape, dtype=dtype, device="meta")}
    z = torch.randn(shape, generator=ctx.generator, dtype=torch.float32,
                    device=ctx.device)
    return {"Out": (z * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0)).to(dtype)}


@register_op("fill_any_like", grad="none")
def fill_any_like(ctx: ExecContext):
    return {"Out": torch.full_like(ctx.input("X"), ctx.attr("value", 0.0))}


@register_op("assign")
def assign(ctx: ExecContext):
    """A copy: Out never shares storage with X, since scope tensors are
    written in place (`increment`, weights.load_params)."""
    return {"Out": ctx.input("X").clone()}


@register_op("increment")
def increment(ctx: ExecContext):
    """X + step in X's dtype. Where Out is X's var (the step counters of
    the schedules, Lookahead, ModelAverage and EMA) the sum is written
    into X's tensor, so the scope keeps one storage across runs."""
    x = ctx.input("X")
    step = ctx.attr("step", 1.0)
    step = step if x.is_floating_point() else int(step)
    if ctx.op.outputs.get("Out") == ctx.op.inputs.get("X"):
        return {"Out": x.add_(step)}
    return {"Out": x + step}


def _cmp(fn):
    def compute(ctx: ExecContext):
        return {"Out": fn(ctx.input("X"), ctx.input("Y"))}

    return compute


# comparisons and logical ops: bool outputs, no grad
for _type, _fn in (("equal", torch.eq), ("not_equal", torch.ne),
                   ("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    register_op(_type, grad="none")(_cmp(_fn))


@register_op("logical_not", grad="none")
def logical_not(ctx: ExecContext):
    return {"Out": torch.logical_not(ctx.input("X"))}


@register_op("where")
def where(ctx: ExecContext):
    return {"Out": torch.where(ctx.input("Condition"), ctx.input("X"),
                               ctx.input("Y"))}


@register_op("range", grad="none")
def range_op(ctx: ExecContext):
    """start..end by step in the 32-bit runtime form of `dtype`."""
    return {"Out": torch.arange(ctx.attr("start"), ctx.attr("end"),
                                ctx.attr("step"),
                                dtype=torch_feed_dtype(ctx.attr("dtype", "int64")),
                                device=ctx.device)}


@register_op("concat")
def concat(ctx: ExecContext):
    xs = [x for x in ctx.inputs("X") if x is not None]
    return {"Out": torch.cat(xs, dim=ctx.attr("axis", 0))}


@register_op("split")
def split(ctx: ExecContext):
    """`num` equal parts along `axis`, or parts of the sizes `sections`."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections", [])
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    return {"Out": list(torch.tensor_split(x, ctx.attr("num", 0), dim=axis))}


@register_op("gather")
def gather(ctx: ExecContext):
    """Rows of X at the flattened Index."""
    x, idx = ctx.input("X"), ctx.input("Index").reshape(-1).long()
    if x.dim() == 0:
        raise ValueError("gather: X has no axis 0 (a 0-d tensor)")
    return {"Out": x.index_select(0, idx)}


@register_op("scatter")
def scatter(ctx: ExecContext):
    """X with the rows at Ids set to Updates (overwrite) or added to,
    out of place; Updates broadcasts to the rows' shape, as in the JAX
    op's `x.at[ids]`."""
    x, upd = ctx.input("X"), ctx.input("Updates")
    ids = ctx.input("Ids").reshape(-1).long()
    upd = torch.broadcast_to(upd.to(x.dtype),
                             (ids.shape[0],) + tuple(x.shape[1:]))
    if ctx.attr("overwrite", True):
        return {"Out": x.index_copy(0, ids, upd)}
    return {"Out": x.index_add(0, ids, upd)}


@register_op("piecewise_decay", grad="none")
def piecewise_decay(ctx: ExecContext):
    """values[i], i the number of boundaries <= Step (the JAX op's
    searchsorted, side="right"), gathered on the device: shape [1]."""
    bounds = ctx.const("boundaries", ctx.attr("boundaries"))
    values = ctx.const("values", ctx.attr("values"))
    step = ctx.input("Step").reshape(1).to(bounds.dtype)
    return {"Out": values.index_select(
        0, torch.searchsorted(bounds, step, right=True))}


@register_op("reshape2")
def reshape2(ctx: ExecContext):
    x = ctx.input("X")
    shape = list(ctx.attr("shape"))
    # 0 means "copy this input dim"
    shape = ([x.shape[i] if d == 0 else d for i, d in enumerate(shape[: x.dim()])]
             + shape[x.dim():])
    return {"Out": x.reshape(shape)}


@register_op("transpose2")
def transpose2(ctx: ExecContext):
    return {"Out": ctx.input("X").permute(*ctx.attr("axis"))}


@register_op("slice")
def slice_op(ctx: ExecContext):
    x = ctx.input("Input")
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(ctx.attr("axes"), ctx.attr("starts"), ctx.attr("ends")):
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        idx[ax] = slice(st, en)
    return {"Out": x[tuple(idx)]}


@register_op("squeeze2")
def squeeze2(ctx: ExecContext):
    x = ctx.input("X")
    axes = ctx.attr("axes", [])
    if not axes:
        return {"Out": x.squeeze()}
    return {"Out": x.squeeze(tuple(a % x.dim() for a in axes))}


@register_op("unsqueeze2")
def unsqueeze2(ctx: ExecContext):
    x = ctx.input("X")
    for a in sorted(ctx.attr("axes")):
        x = x.unsqueeze(a)
    return {"Out": x}


@register_op("one_hot", grad="none")
def one_hot(ctx: ExecContext):
    """fp32 [..., depth] rows with a 1 at each id (a trailing 1 on X is
    squeezed); an id outside [0, depth) gives a row of zeros, as
    jax.nn.one_hot does. Compared, not scattered: no index is checked on
    the host."""
    x = ctx.input("X")
    x = x.reshape(x.shape[:-1]) if x.dim() and x.shape[-1] == 1 else x
    depth = ctx.attr("depth")
    ids = torch.arange(depth, dtype=x.dtype, device=x.device)
    return {"Out": (x[..., None] == ids).to(torch.float32)}


@register_op("top_k", grad="none")
def top_k(ctx: ExecContext):
    """The k largest of the last dim, largest first."""
    vals, idx = torch.topk(ctx.input("X"), ctx.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx.to(_INDEX_DTYPE)}


@register_op("arg_max", grad="none")
def arg_max(ctx: ExecContext):
    """First maximal index (torch.argmax's rule, and jnp.argmax's)."""
    out = torch.argmax(ctx.input("X"), dim=ctx.attr("axis", -1))
    return {"Out": out.to(_INDEX_DTYPE)}
