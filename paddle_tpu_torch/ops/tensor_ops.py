"""Tensor manipulation and creation ops (the JAX package's tensor_ops.py).
The grads of the manipulation ops are derived by replay (ops/registry.py).

The random ops draw from the run's `torch.Generator` (executor.py), keyed
by the program's random_seed and the run counter: the same distributions
as the JAX ops, not the same streams.

No op here reads the device from the host except the host ops (`print`,
`unique`, `unique_with_counts`, `filter_by_instag`, `py_func` and their
grads), whose outputs depend on values read back, and merge_selected_rows.
Shapes come from tensor metadata; a multi-index gather or scatter
(gather_nd, scatter_nd_add) runs as `index_select` / `index_add_` over the
linearized index, since advanced-index `index_put_(accumulate=True)`
syncs on CUDA."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.selected_rows import SelectedRows, is_selected_rows
from ..core.types import torch_dtype, torch_feed_dtype
from .registry import ExecContext, register_grad_compute, register_op

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


@register_op("merge_selected_rows", grad="none")
def merge_selected_rows(ctx: ExecContext):
    """Sum the duplicate rows of a SelectedRows (the JAX package's
    tensor_ops.py:570): rows come out unique and ascending. The JAX op runs
    on the host; here `torch.unique` runs on the tensor's device and reads
    the number of unique rows back to the host, so it syncs."""
    sr = _selected_rows(ctx)
    uniq, inv = torch.unique(sr.rows, sorted=True, return_inverse=True)
    merged = torch.zeros((uniq.shape[0],) + tuple(sr.values.shape[1:]),
                         dtype=sr.values.dtype, device=sr.values.device)
    return {"Out": SelectedRows(uniq.to(torch.int32),
                                merged.index_add_(0, inv, sr.values),
                                sr.height)}


@register_op("get_tensor_from_selected_rows", grad="none")
def get_tensor_from_selected_rows(ctx: ExecContext):
    """The value tensor of a SelectedRows (tensor_ops.py:588)."""
    return {"Out": _selected_rows(ctx).values}


def _selected_rows(ctx: ExecContext):
    """X, which must be a SelectedRows (shape inference, which sees a
    dense var, fails here as the JAX op's does)."""
    sr = ctx.input("X")
    if not is_selected_rows(sr):
        raise TypeError(f"{ctx.op.type} needs a SelectedRows X (a sparse "
                        f"gradient), got {type(sr).__name__}")
    return sr


def _on_device(ctx: ExecContext, values, dtype) -> torch.Tensor:
    """A host list or array as a tensor on the op's device, copied without
    waiting on the device."""
    return torch.as_tensor(np.asarray(values), dtype=dtype).to(
        ctx.device, non_blocking=True)


def _batch_like_shape(ctx: ExecContext):
    """attr shape with output_dim_idx taken from Input's input_dim_idx
    extent (metadata, no host read)."""
    shape = [int(d) for d in ctx.attr("shape")]
    shape[int(ctx.attr("output_dim_idx", 0))] = \
        ctx.input("Input").shape[int(ctx.attr("input_dim_idx", 0))]
    return tuple(shape)


@register_op("fill_zeros_like", grad="none")
def fill_zeros_like(ctx: ExecContext):
    return {"Out": torch.zeros_like(ctx.input("X"))}


@register_op("truncated_gaussian_random", grad="none", needs_rng=True)
def truncated_gaussian_random(ctx: ExecContext):
    """Normal(mean, std) truncated to 2 std, by the inverse CDF of a
    uniform draw between the two cut-offs' probabilities."""
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if ctx.is_meta:
        return {"Out": torch.empty(shape, dtype=dtype, device="meta")}
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=ctx.generator, dtype=torch.float32,
                   device=ctx.device)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    z = torch.clamp(z, -2.0, 2.0)
    return {"Out": (z * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0)).to(dtype)}


@register_op("uniform_random_batch_size_like", grad="none", needs_rng=True)
def uniform_random_batch_size_like(ctx: ExecContext):
    shape = _batch_like_shape(ctx)
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if ctx.is_meta:
        return {"Out": torch.empty(shape, dtype=dtype, device="meta")}
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    u = ctx.draw(lambda s: torch.rand(s, generator=ctx.generator,
                                      dtype=torch.float32,
                                      device=ctx.device), shape)
    return {"Out": (u * (hi - lo) + lo).to(dtype)}


@register_op("fill_constant_batch_size_like", grad="none")
def fill_constant_batch_size_like(ctx: ExecContext):
    return {"Out": torch.full(_batch_like_shape(ctx), ctx.attr("value", 0.0),
                              dtype=torch_dtype(ctx.attr("dtype", "float32")),
                              device=ctx.device)}


@register_op("shape", grad="none")
def shape_op(ctx: ExecContext):
    """X's shape as int32, from its metadata."""
    return {"Out": _on_device(ctx, list(ctx.input("X").shape), torch.int32)}


@register_op("flatten2")
def flatten2(ctx: ExecContext):
    x = ctx.input("X")
    axis = ctx.attr("axis", 1)
    return {"Out": x.reshape(math.prod(x.shape[:axis]) if axis > 0 else 1, -1)}


@register_op("strided_slice")
def strided_slice(ctx: ExecContext):
    """Python slicing a listed axis (starts, ends, strides); a negative
    stride walks the flipped axis, as torch slices only forward."""
    x = ctx.input("Input")
    for ax, st, en, sd in zip(ctx.attr("axes"), ctx.attr("starts"),
                              ctx.attr("ends"), ctx.attr("strides")):
        ax = ax % x.dim()
        lead = (slice(None),) * ax
        if sd > 0:
            x = x[lead + (slice(st, en, sd),)]
            continue
        r = range(*slice(st, en, sd).indices(x.shape[ax]))
        if not len(r):
            x = x.narrow(ax, 0, 0)
            continue
        first = x.shape[ax] - 1 - r[0]
        x = x.flip(ax)[lead + (slice(first, first + (len(r) - 1) * -sd + 1,
                                     -sd),)]
    return {"Out": x}


@register_op("stack")
def stack(ctx: ExecContext):
    xs = [x for x in ctx.inputs("X") if x is not None]
    return {"Y": torch.stack(xs, dim=ctx.attr("axis", 0))}


@register_op("unstack")
def unstack(ctx: ExecContext):
    return {"Y": list(ctx.input("X").unbind(ctx.attr("axis", 0)))}


@register_op("expand")
def expand(ctx: ExecContext):
    """X tiled expand_times along each dim (jnp.tile)."""
    return {"Out": torch.tile(ctx.input("X"), tuple(ctx.attr("expand_times")))}


def _linear_index(x_shape, idx):
    """(flat row index [...], the trailing shape): the last dim of `idx`
    indexes X's leading idx.shape[-1] dims, linearized over them."""
    k = idx.shape[-1]
    strides = [math.prod(x_shape[i + 1:k]) for i in range(k)]
    flat = torch.zeros(idx.shape[:-1], dtype=torch.long, device=idx.device)
    for i, st in enumerate(strides):
        flat = flat + idx[..., i].long() * st
    return flat, tuple(x_shape[k:])


@register_op("gather_nd")
def gather_nd(ctx: ExecContext):
    x, idx = ctx.input("X"), ctx.input("Index")
    flat, rest = _linear_index(x.shape, idx)
    rows = x.reshape((math.prod(x.shape[:idx.shape[-1]]),) + rest)
    return {"Out": rows.index_select(0, flat.reshape(-1)).reshape(
        tuple(idx.shape[:-1]) + rest)}


def _scatter_nd_add(x, idx, upd):
    flat, rest = _linear_index(x.shape, idx)
    rows = x.reshape((math.prod(x.shape[:idx.shape[-1]]),) + rest)
    return rows.index_add(0, flat.reshape(-1),
                          upd.to(x.dtype).reshape((-1,) + rest)).reshape(x.shape)


@register_op("scatter_nd_add")
def scatter_nd_add(ctx: ExecContext):
    """X with Updates added at the multi-indices of Index (repeats add)."""
    return {"Out": _scatter_nd_add(ctx.input("X"), ctx.input("Index"),
                                   ctx.input("Updates"))}


@register_op("scatter_nd", grad="none")
def scatter_nd(ctx: ExecContext):
    upd = ctx.input("Updates")
    z = torch.zeros([int(s) for s in ctx.attr("shape")], dtype=upd.dtype,
                    device=upd.device)
    return {"Out": _scatter_nd_add(z, ctx.input("Index"), upd)}


@register_op("cum")
def cum(ctx: ExecContext):
    """cumsum along axis, optionally reversed and exclusive (shifted one
    along, a zero first)."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1) % max(x.dim(), 1)
    rev = ctx.attr("reverse", False)
    out = torch.cumsum(x.flip(axis) if rev else x, dim=axis)
    if rev:
        out = out.flip(axis)
    if ctx.attr("exclusive", False):
        pad = [0, 0] * (x.dim() - 1 - axis) + [1, 0]
        out = F.pad(out, pad).narrow(axis, 0, x.shape[axis])
    return {"Out": out}


@register_op("arg_min", grad="none")
def arg_min(ctx: ExecContext):
    """First minimal index (jnp.argmin's rule)."""
    out = torch.argmin(ctx.input("X"), dim=ctx.attr("axis", -1))
    return {"Out": out.to(_INDEX_DTYPE)}


@register_op("argsort", grad="none")
def argsort(ctx: ExecContext):
    """Ascending sort and its indices; stable, so ties keep their order as
    in jnp.argsort."""
    vals, idx = torch.sort(ctx.input("X"), dim=ctx.attr("axis", -1),
                           stable=True)
    return {"Out": vals, "Indices": idx.to(_INDEX_DTYPE)}


@register_op("pad2d")
def pad2d(ctx: ExecContext):
    """NCHW padding [top, bottom, left, right]: constant, reflect or edge."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    mode = ctx.attr("mode", "constant")
    pads = (p[2], p[3], p[0], p[1])
    if mode == "constant":
        return {"Out": F.pad(x, pads, value=ctx.attr("pad_value", 0.0))}
    return {"Out": F.pad(x, pads, mode={"reflect": "reflect",
                                        "edge": "replicate"}[mode])}


@register_op("pad")
def pad(ctx: ExecContext):
    """Constant padding (before, after) of every dim."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    pads = []
    for i in reversed(range(x.dim())):
        pads += [p[2 * i], p[2 * i + 1]]
    return {"Out": F.pad(x, pads, value=ctx.attr("pad_value", 0.0))}


@register_op("linspace", grad="none")
def linspace(ctx: ExecContext):
    return {"Out": torch.linspace(ctx.attr("start"), ctx.attr("stop"),
                                  ctx.attr("num"),
                                  dtype=torch_dtype(ctx.attr("dtype", "float32")),
                                  device=ctx.device)}


@register_op("assign_value", grad="none")
def assign_value(ctx: ExecContext):
    """The attr's values (a numpy array given to `assign`) on the device."""
    dtype = torch_feed_dtype(ctx.attr("dtype", "float32"))
    vals = np.asarray(ctx.attr("values")).reshape(ctx.attr("shape"))
    return {"Out": _on_device(ctx, vals, dtype)}


# -- print: a host op that logs its input and passes it through -------------

def _print_value(ctx: ExecContext, x, phase_tag=""):
    """The JAX op's line: `message[phase]  shape=... dtype=... values=...`
    for the first `first_n` runs (the count kept on the op)."""
    count = getattr(ctx.op, "_print_count", 0)
    first_n = int(ctx.attr("first_n", -1))
    if first_n < 0 or count < first_n:
        ctx.op._print_count = count + 1
        msg = ctx.attr("message", "") or ""
        arr = x.detach().cpu().numpy()
        summarize = int(ctx.attr("summarize", 20))
        flat = arr.reshape(-1)
        shown = flat if summarize < 0 else flat[:summarize]
        print(f"{msg}{phase_tag}  shape={arr.shape} dtype={arr.dtype} "
              f"values={np.array2string(shown, precision=6)}", flush=True)


def _print_grad_maker(op, block, no_grad_set=frozenset()):
    from ..framework import grad_var_name

    x = op.inputs["In"][0]
    if x in no_grad_set:
        return []
    return [{"type": "print_grad",
             "inputs": {"Out@GRAD": [grad_var_name(op.outputs["Out"][0])]},
             "outputs": {"In@GRAD": [grad_var_name(x)]},
             "attrs": dict(op.attrs)}]


@register_op("print", host=True, grad=_print_grad_maker)
def print_op(ctx: ExecContext):
    x = ctx.input("In")
    if ctx.attr("print_phase", "both") in ("forward", "both"):
        _print_value(ctx, x)
    return {"Out": x}


@register_grad_compute("print", host=True)
def print_grad(ctx: ExecContext):
    """The grad passes through, printed in the backward phase."""
    g = ctx.input("Out@GRAD")
    if ctx.attr("print_phase", "both") in ("backward", "both"):
        _print_value(ctx, g, phase_tag=" [backward]")
    return {"In@GRAD": g}


# -- hash: the JAX op's splitmix-style mix in 32-bit words ------------------

_M32 = 0xFFFFFFFF


def _mul32(a, k: int):
    """(a * k) mod 2^32 for int64 a in [0, 2^32): two 16-bit halves of k, so
    no product leaves int64."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


@register_op("hash", grad="none")
def hash_op(ctx: ExecContext):
    """num_hash buckets [..., num_hash, 1] of each row of int ids, mod
    mod_by: the JAX op's uint32 mix (seed, two xor-shift-multiply rounds,
    a *31 fold over the row) carried in int64 with 32-bit masks, so every
    shift is logical. Ids run as int32 (the feed rule), whose upper half
    is zero, as in the JAX op with x64 off; an id past 2^31 hashes by its
    low 32 bits."""
    x = ctx.input("X")
    num_hash = int(ctx.attr("num_hash", 1))
    mod_by = int(ctx.attr("mod_by", 100000))
    lo32 = x.to(torch.int64) & _M32
    outs = []
    for seed in range(num_hash):
        h = lo32 ^ ((0x9E3779B9 * (seed + 1)) & _M32)
        h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
        h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
        h = h ^ (h >> 16)
        row = torch.zeros(h.shape[:-1], dtype=torch.int64, device=x.device)
        for j in range(x.shape[-1]):
            row = (_mul32(row, 31) + h[..., j]) & _M32
        outs.append((row % mod_by).to(_INDEX_DTYPE))
    return {"Out": torch.stack(outs, dim=-1)[..., None]}


# -- cvm: the continuous-value-model transform and its straight-through grad

def _cvm_grad_maker(op, block, no_grad_set=frozenset()):
    from ..framework import grad_var_name

    xname = op.inputs["X"][0]
    if xname in no_grad_set:
        return []
    return [{"type": "cvm_grad",
             "inputs": {"X": list(op.inputs["X"]),
                        "CVM": list(op.inputs.get("CVM", [])),
                        "Y@GRAD": [grad_var_name(op.outputs["Y"][0])]},
             "outputs": {"X@GRAD": [grad_var_name(xname)]},
             "attrs": dict(op.attrs)}]


@register_op("cvm", grad=_cvm_grad_maker)
def cvm(ctx: ExecContext):
    """X [B, D] whose first two columns are (show, click): use_cvm keeps
    the width, column 0 = log(show + 1), column 1 = log(click + 1) - column
    0; otherwise both columns are dropped."""
    x = ctx.input("X")
    if bool(ctx.attr("use_cvm", True)):
        c0 = torch.log(x[:, :1] + 1.0)
        c1 = torch.log(x[:, 1:2] + 1.0) - c0
        return {"Y": torch.cat([c0, c1, x[:, 2:]], dim=1)}
    return {"Y": x[:, 2:]}


@register_grad_compute("cvm")
def cvm_grad(ctx: ExecContext):
    """dX: the two CVM columns take CVM's raw values (the reference's
    straight-through, not a chain-rule term), the rest dY's body."""
    x, gy, cvm_in = ctx.input("X"), ctx.input("Y@GRAD"), ctx.input("CVM")
    if cvm_in is None:
        cvm_in = torch.zeros((x.shape[0], 2), dtype=x.dtype, device=x.device)
    body = gy[:, 2:] if bool(ctx.attr("use_cvm", True)) else gy
    return {"X@GRAD": torch.cat([cvm_in[:, :2].to(x.dtype), body], dim=1)}


# -- the host ops with data-dependent extents --------------------------------

def _unique_ordered(ctx: ExecContext):
    """(unique values in first-occurrence order, each element's index into
    them, the number of unique values): torch.unique sorts, so the first
    position of each value (a scatter-min over the inverse) orders them.
    Reads the unique count back: a host op."""
    x = ctx.input("X").reshape(-1)
    uniq, inv = torch.unique(x, sorted=True, return_inverse=True)
    n = x.shape[0]
    first = torch.full(uniq.shape, n, dtype=torch.long, device=x.device)
    first = first.scatter_reduce(0, inv, torch.arange(n, device=x.device),
                                 "amin")
    order = torch.argsort(first)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=x.device)
    idx_dt = (torch.int64 if str(ctx.attr("dtype", "int32")).endswith("64")
              else torch.int32)
    return uniq[order], rank[inv].to(idx_dt)


@register_op("unique", grad="none", host=True)
def unique(ctx: ExecContext):
    ordered, index = _unique_ordered(ctx)
    return {"Out": ordered, "Index": index}


@register_op("unique_with_counts", grad="none", host=True)
def unique_with_counts(ctx: ExecContext):
    ordered, index = _unique_ordered(ctx)
    count = torch.zeros(ordered.shape, dtype=_INDEX_DTYPE,
                        device=index.device).index_add_(
        0, index.long(), torch.ones(index.shape, dtype=_INDEX_DTYPE,
                                    device=index.device))
    return {"Out": ordered, "Index": index, "Count": count}


@register_op("filter_by_instag", grad="none", host=True)
def filter_by_instag(ctx: ExecContext):
    """The rows of Ins [B, D] whose tags Ins_tag [B, T] (-1 padded) meet
    Filter_tag [K]: Out, LossWeight [kept, 1] of ones and IndexMap [kept,
    2] (out row, in row); one zero row when none is kept. The kept count
    is read back: a host op."""
    ins, tags = ctx.input("Ins"), ctx.input("Ins_tag")
    filt = ctx.input("Filter_tag").reshape(-1)
    hit = (tags.reshape(tags.shape[0], -1)[..., None] == filt).any(-1).any(-1)
    keep = torch.nonzero(hit).reshape(-1)
    dev = ins.device
    if keep.shape[0] == 0:
        return {"Out": torch.zeros((1,) + tuple(ins.shape[1:]), dtype=ins.dtype,
                                   device=dev),
                "LossWeight": torch.zeros((1, 1), dtype=torch.float32, device=dev),
                "IndexMap": torch.zeros((1, 2), dtype=_INDEX_DTYPE, device=dev)}
    k = keep.shape[0]
    return {"Out": ins.index_select(0, keep),
            "LossWeight": torch.ones((k, 1), dtype=torch.float32, device=dev),
            "IndexMap": torch.stack(
                [torch.arange(k, device=dev), keep], dim=1).to(_INDEX_DTYPE)}


# -- py_func: a user's Python callable inside the program --------------------

PY_FUNC_REGISTRY: list = []


def register_py_func(fn) -> int:
    """Keep `fn` for py_func ops of this process; its id goes in the op's
    attrs."""
    PY_FUNC_REGISTRY.append(fn)
    return len(PY_FUNC_REGISTRY) - 1


def _to_numpy(v):
    return None if v is None else v.detach().cpu().numpy()


def _from_numpy(ctx: ExecContext, r):
    return None if r is None else torch.as_tensor(np.asarray(r)).to(ctx.device)


def _py_func_grad_maker(op, block, no_grad_set=frozenset()):
    from ..framework import grad_var_name

    if int(op.attrs.get("backward_callable_id", -1)) < 0:
        return []
    gouts = ["" if n in no_grad_set else grad_var_name(n)
             for n in op.inputs.get("X", [])]
    if not any(gouts):
        return []
    return [{"type": "py_func_grad",
             "inputs": {"X": list(op.inputs["X"]),
                        "Out": list(op.outputs["Out"]),
                        "Out@GRAD": [grad_var_name(n) for n in op.outputs["Out"]]},
             "outputs": {"X@GRAD": gouts},
             "attrs": dict(op.attrs)}]


@register_op("py_func", host=True, grad=_py_func_grad_maker)
def py_func(ctx: ExecContext):
    """The registered callable on X's values as numpy arrays; its results
    map onto the Out slot in order and go back to the op's device."""
    fn = PY_FUNC_REGISTRY[int(ctx.attr("forward_callable_id"))]
    res = fn(*[_to_numpy(v) for v in ctx.inputs("X")])
    if res is None:
        res = ()
    if not isinstance(res, (list, tuple)):
        res = (res,)
    outs = list(ctx.op.outputs.get("Out", []))
    if len(res) != len(outs):
        raise ValueError(f"py_func returned {len(res)} values for "
                         f"{len(outs)} output variables")
    return {"Out": [_from_numpy(ctx, r) for r in res]}


@register_op("py_func_grad", host=True, grad="none")
def py_func_grad(ctx: ExecContext):
    """backward_func(*(X + Out + Out@GRAD) less skip_names) -> the grads
    of X in order."""
    fn = PY_FUNC_REGISTRY[int(ctx.attr("backward_callable_id"))]
    skip = set(ctx.attr("skip_names", []) or [])
    args = []
    for slot in ("X", "Out", "Out@GRAD"):
        for n, v in zip(ctx.op.inputs.get(slot, []), ctx.inputs(slot)):
            if n not in skip:
                args.append(_to_numpy(v))
    res = fn(*args)
    if not isinstance(res, (list, tuple)):
        res = (res,)
    width = len(ctx.op.outputs.get("X@GRAD", []))
    res = list(res) + [None] * (width - len(res))
    return {"X@GRAD": [_from_numpy(ctx, r) for r in res[:width]]}
