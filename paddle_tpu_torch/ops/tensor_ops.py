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


@register_op("fill_any_like", grad="none")
def fill_any_like(ctx: ExecContext):
    return {"Out": torch.full_like(ctx.input("X"), ctx.attr("value", 0.0))}


@register_op("assign")
def assign(ctx: ExecContext):
    return {"Out": ctx.input("X")}


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


@register_op("arg_max", grad="none")
def arg_max(ctx: ExecContext):
    """First maximal index (torch.argmax's rule, and jnp.argmax's)."""
    out = torch.argmax(ctx.input("X"), dim=ctx.attr("axis", -1))
    return {"Out": out.to(_INDEX_DTYPE)}
