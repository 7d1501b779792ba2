"""Collective ops: the `c_*` family over `torch.distributed` groups.

The JAX package's ops/collective_ops.py lowers these to `lax.psum`,
`all_gather`, `psum_scatter` and `ppermute` over a mesh axis bound by
shard_map. Here an op finds its group in the run's environment: under
`CompiledProgram.with_collective` the executor binds every ring id to an
axis of the mesh (`parallel.mesh.CommContext.axis_env`) and sets the env
key `AXIS_ENV_KEY`; with no binding (a plain `Program` run, whether or not
a process group exists, and `with_data_parallel`, whose rewrite binds only
its own ring `REWRITE_RING`) every op is the identity, as the JAX ops are
when `_axis(ctx)` is None. `c_allreduce_sum`'s `avg` divides by the group's
size only when it reduces.

Transport is the group's backend, which the caller chose when the
process group was made:
  * nccl: CUDA tensors; the collective is enqueued behind the current
    stream's work and the stream waits for it, with no host sync;
  * gloo: CPU tensors, or CUDA tensors staged through pinned host buffers
    (a sync, device -> host copy, the gloo collective, host -> device
    copy), because gloo carries CUDA tensors for only some collectives. It
    is a transport of its own, not a fallback: nothing switches backend.
An op raises on a group whose backend cannot carry its tensor's device or
dtype; no op computes locally in place of a collective. `c_reducescatter`
over gloo is an all-reduce of which the rank keeps its rows, and
`c_collective_permute` an all-gather of which it keeps its source rank's
value (a 2-rank send/receive ring over gloo can hang).

`comm_stats()` counts the collectives a process ran, their bytes and their
time: host time for gloo (`host_s`: the staging copies and the collective;
`wait_s` apart: the sync before the staging, which waits for the work
already queued on the stream); device time from CUDA events for nccl when
`reset_comm_stats(timing=True)` asked for it.
"""
from __future__ import annotations

import time

import torch

from .registry import ExecContext, register_grad_compute, register_op

AXIS_ENV_KEY = "__axis_env__"
# the ring the with_data_parallel rewrite (parallel/sharding.py) puts its
# collectives on: the only ring bound when such a program runs
REWRITE_RING = 1 << 16
# the ring of the tensor-parallel rewrite's collectives (parallel/
# tensor_parallel.py), bound to the mesh's `tp` group
TP_RING = REWRITE_RING + 1
# the ring of the sequence-parallel rewrite's (parallel/spatial.py), bound
# to the mesh's `sp` group
SP_RING = REWRITE_RING + 2

_STATS = {"calls": 0, "bytes": 0, "host_s": 0.0, "wait_s": 0.0,
          "timing": False, "events": [], "by_what": {}}


def reset_comm_stats(timing: bool = False) -> None:
    """Zero the counters; timing=True records CUDA events around each nccl
    collective (read by comm_stats after the device is synchronized)."""
    _STATS.update(calls=0, bytes=0, host_s=0.0, wait_s=0.0,
                  timing=bool(timing), events=[], by_what={})


def comm_stats() -> dict:
    """{"calls", "bytes", "host_s", "wait_s", "device_ms", "by_what"} since
    the last reset; device_ms sums the nccl collectives' event pairs (None
    untimed); by_what splits calls, bytes, host_s and wait_s by the
    caller's name of the collective (an op type, "sync batch norm stats",
    "sync batch norm sums", "fetch")."""
    dev_ms = None
    if _STATS["events"]:
        dev_ms = sum(a.elapsed_time(b) for a, b in _STATS["events"])
    return {"calls": _STATS["calls"], "bytes": _STATS["bytes"],
            "host_s": _STATS["host_s"], "wait_s": _STATS["wait_s"],
            "device_ms": dev_ms,
            "by_what": {k: dict(v) for k, v in _STATS["by_what"].items()}}


def _group(ctx: ExecContext):
    env = ctx.env.get(AXIS_ENV_KEY)
    if env is None:
        return None
    ring = ctx.attr("ring_id", 0)
    return env.get(ring, env.get(0))


def _check(g, tensors, what):
    for t in tensors:
        if t.dtype == torch.bool:
            raise TypeError(f"{what}: the {g.backend} group cannot carry a "
                            f"{t.dtype} tensor")
        if g.backend == "nccl" and t.device.type != "cuda":
            raise TypeError(f"{what}: the nccl group carries CUDA tensors "
                            f"only, got one on {t.device}; make a gloo group "
                            f"for CPU ranks")
        if g.backend == "gloo" and t.device.type not in ("cpu", "cuda"):
            raise TypeError(f"{what}: the gloo group cannot carry a tensor "
                            f"on {t.device}")


def _transport(g, tensors, what, fn, inplace=False):
    """Run fn(the tensors on the transport's device) -> list of tensors,
    and return the results on the inputs' device. fn reads its tensors
    and builds its outputs; with `inplace` it may overwrite them, and then
    gets private copies (the staged host buffers on gloo with CUDA
    tensors). Counts the call."""
    _check(g, tensors, what)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    mine = _STATS["by_what"].setdefault(
        what, {"calls": 0, "bytes": 0, "host_s": 0.0, "wait_s": 0.0})
    for d in (_STATS, mine):
        d["calls"] += 1
        d["bytes"] += nbytes
    dev = tensors[0].device
    if g.backend == "gloo" and dev.type == "cuda":
        t_wait = time.perf_counter()
        torch.cuda.current_stream(dev).synchronize()
        t0 = time.perf_counter()
        _STATS["wait_s"] += t0 - t_wait
        mine["wait_s"] += t0 - t_wait
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            host.append(h)
        outs = [o.to(dev, non_blocking=True) for o in fn(host)]
    else:
        ev = None
        if g.backend == "nccl" and _STATS["timing"]:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        outs = fn([t.clone(memory_format=torch.contiguous_format)
                   for t in tensors] if inplace else list(tensors))
        if ev is not None:
            ev[1].record()
            _STATS["events"].append(ev)
    _STATS["host_s"] += time.perf_counter() - t0
    mine["host_s"] += time.perf_counter() - t0
    return outs


def _all_reduce(g, x, red="sum", what="c_allreduce"):
    import torch.distributed as dist

    if g.pg is None:
        return x
    op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
          "min": dist.ReduceOp.MIN}[red]

    def fn(ts):
        dist.all_reduce(ts[0], op=op, group=g.pg)
        return ts

    return _transport(g, [x], what, fn, inplace=True)[0]


def _all_reduce_many(g, xs, what):
    """One flat all-reduce for a list of same-dtype tensors."""
    import torch.distributed as dist

    if g.pg is None:
        return list(xs)

    def fn(ts):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=g.pg)
        return list(torch.split(flat, [t.numel() for t in ts]))

    outs = _transport(g, list(xs), what, fn)
    return [o.reshape(x.shape) for o, x in zip(outs, xs)]


def _all_gather(g, x, what="c_allgather"):
    """[value of the group's rank 0, ..., rank size-1]."""
    import torch.distributed as dist

    if g.pg is None:
        return [x]

    def fn(ts):
        x = ts[0].contiguous()
        outs = [torch.empty_like(x) for _ in range(g.size)]
        dist.all_gather(outs, x, group=g.pg)
        return outs

    return _transport(g, [x], what, fn)


def _rows(x, g):
    k = x.shape[0] // g.size
    return x[g.index * k:(g.index + 1) * k]


def _reduce_scatter(g, x, what="c_reducescatter"):
    import torch.distributed as dist

    if g.pg is None:
        return x
    if x.shape[0] % g.size:
        raise ValueError(f"{what}: leading dim {x.shape[0]} does not divide "
                         f"over the group's {g.size} ranks")
    if g.backend == "nccl":
        def fn(ts):
            chunks = list(torch.chunk(ts[0], g.size))
            out = torch.empty_like(chunks[0])
            dist.reduce_scatter(out, [c.contiguous() for c in chunks],
                                group=g.pg)
            return [out]

        return _transport(g, [x], what, fn)[0]
    return _rows(_all_reduce(g, x, "sum", what), g).clone()


def _selected_rows_refused(what, xs):
    from ..core.selected_rows import is_selected_rows

    for x in xs:
        if is_selected_rows(x):
            raise TypeError(
                f"{what}: SelectedRows gradients cannot ride a collective — "
                "use the parameter-server path for is_sparse=True "
                "embeddings, or build the model with is_sparse=False for "
                "collective mode")


def _allreduce(red):
    def compute(ctx: ExecContext):
        x = ctx.input("X")
        _selected_rows_refused(f"c_allreduce_{red}", [x])
        g = _group(ctx)
        if g is None:
            return {"Out": x}
        if red == "prod":
            # gather + prod, as the JAX op: exact on zero and negative values
            return {"Out": torch.prod(torch.stack(_all_gather(
                g, x, "c_allreduce_prod")), dim=0)}
        out = _all_reduce(g, x, red, f"c_allreduce_{red}")
        if red == "sum" and ctx.attr("avg", False) and g.pg is not None:
            out = out / g.size
        return {"Out": out}

    return compute


register_op("c_allreduce_sum")(_allreduce("sum"))
register_op("c_allreduce_max", grad="none")(_allreduce("max"))
register_op("c_allreduce_min", grad="none")(_allreduce("min"))
register_op("c_allreduce_prod", grad="none")(_allreduce("prod"))
register_op("allreduce")(_allreduce("sum"))  # legacy dygraph DP op


def _sum_grad(ctx: ExecContext):
    """The adjoint of a sum over ranks: every rank's value reached every
    rank's output, so its gradient is the sum of theirs (divided by the
    group's size under `avg`)."""
    gy = ctx.input("Out@GRAD")
    g = _group(ctx)
    if g is None or gy is None:
        return {"X@GRAD": gy}
    out = _all_reduce(g, gy, "sum", ctx.op.type)
    if ctx.attr("avg", False) and g.pg is not None:
        out = out / g.size
    return {"X@GRAD": out}


register_grad_compute("c_allreduce_sum")(_sum_grad)
register_grad_compute("allreduce")(_sum_grad)


@register_op("c_allreduce_coalesced", grad="none")
def c_allreduce_coalesced(ctx: ExecContext):
    """A bucket's mean-allreduce: the X list rides one flat all-reduce per
    dtype, so a bucket costs one collective. Each element is summed over
    the same ranks as by c_allreduce_sum, and with two ranks the sum is
    the same bits whatever the bucket's layout."""
    xs = ctx.inputs("X")
    _selected_rows_refused("c_allreduce_coalesced", xs)
    g = _group(ctx)
    if g is None:
        return {"Out": list(xs)}
    outs = [None] * len(xs)
    by_dtype: dict = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        red = _all_reduce_many(g, [xs[i] for i in idx],
                               "c_allreduce_coalesced")
        for i, r in zip(idx, red):
            outs[i] = r
    if ctx.attr("avg", False) and g.pg is not None:
        outs = [o / g.size for o in outs]
    return {"Out": outs}


def _var(op, name):
    """The program var `name` as `op`'s block sees it, or None."""
    try:
        return op.block.var(name)
    except (AttributeError, KeyError):
        return None


def _stored_shard(ctx: ExecContext, x, g) -> bool:
    """True where `x`, the value of the op's X var, is already this rank's
    shard: a ZeRO-1 optimizer state kept sharded in the scope. The Out
    var (`<name>@ZERO1_SHARD`) has the shard's rows; the X var's own shape
    says nothing, since shape inference of the gather after the update
    gives it the shard's shape too (in both packages)."""
    var = _var(ctx.op, ctx.op.input("X")[0])
    out = _var(ctx.op, ctx.op.output("Out")[0])
    return (g.size > 1 and var is not None and out is not None
            and getattr(var, "is_opt_state", False) and len(out.shape) > 0
            and x.shape[0] == out.shape[0])


@register_op("zero1_shard", grad="none")
def zero1_shard(ctx: ExecContext):
    """This rank's leading-dim slice of X (ZeRO-1, parallel/sharding.py):
    the rank at index i of the ring's group owns rows [i*k, (i+1)*k). An
    optimizer state already held as the rank's shard passes through.
    Unbound, the identity."""
    x = ctx.input("X")
    g = _group(ctx)
    if g is None or g.size == 1 or _stored_shard(ctx, x, g):
        return {"Out": x}
    return {"Out": _rows(x, g)}


@register_op("c_allgather")
def c_allgather(ctx: ExecContext):
    """The group's values concatenated on dim 0. The gather of a ZeRO-1
    optimizer state (an `is_opt_state` output) is elided: the rank keeps
    its shard in the scope, which is ZeRO-1's memory saving; the
    parameters' gathers run."""
    x = ctx.input("X")
    g = _group(ctx)
    if g is None:
        return {"Out": x}
    out_var = _var(ctx.op, ctx.op.output("Out")[0])
    if (out_var is not None and getattr(out_var, "is_opt_state", False)
            and g.size > 1):
        return {"Out": x}
    return {"Out": torch.cat(_all_gather(g, x), dim=0)}


@register_grad_compute("c_allgather")
def c_allgather_grad(ctx: ExecContext):
    gy = ctx.input("Out@GRAD")
    g = _group(ctx)
    if g is None or gy is None:
        return {"X@GRAD": gy}
    return {"X@GRAD": _reduce_scatter(g, gy, "c_allgather_grad")}


@register_op("c_reducescatter")
def c_reducescatter(ctx: ExecContext):
    x = ctx.input("X")
    _selected_rows_refused("c_reducescatter", [x])
    g = _group(ctx)
    if g is None:
        return {"Out": x}
    out = _reduce_scatter(g, x)
    if ctx.attr("avg", False) and g.pg is not None:
        out = out / g.size
    return {"Out": out}


@register_grad_compute("c_reducescatter")
def c_reducescatter_grad(ctx: ExecContext):
    gy = ctx.input("Out@GRAD")
    g = _group(ctx)
    if g is None or gy is None:
        return {"X@GRAD": gy}
    out = torch.cat(_all_gather(g, gy, "c_reducescatter_grad"), dim=0)
    if ctx.attr("avg", False) and g.pg is not None:
        out = out / g.size
    return {"X@GRAD": out}


def _broadcast(g, x, root, what="c_broadcast"):
    import torch.distributed as dist

    if g.pg is None:
        return x

    def fn(ts):
        dist.broadcast(ts[0], src=g.ranks[root], group=g.pg)
        return ts

    return _transport(g, [x], what, fn, inplace=True)[0]


@register_op("c_broadcast")
def c_broadcast(ctx: ExecContext):
    """The value of the group's rank at index `root` on every rank."""
    x = ctx.input("X")
    g = _group(ctx)
    if g is None:
        return {"Out": x}
    return {"Out": _broadcast(g, x, int(ctx.attr("root", 0)))}


@register_grad_compute("c_broadcast")
def c_broadcast_grad(ctx: ExecContext):
    gy = ctx.input("Out@GRAD")
    g = _group(ctx)
    if g is None or gy is None:
        return {"X@GRAD": gy}
    s = _all_reduce(g, gy, "sum", "c_broadcast_grad")
    root = int(ctx.attr("root", 0))
    return {"X@GRAD": s if g.index == root else torch.zeros_like(s)}


def _permute(g, x, shift, what="c_collective_permute"):
    if g.pg is None:
        return x
    return _all_gather(g, x, what)[(g.index - shift) % g.size]


@register_op("c_collective_permute")
def c_collective_permute(ctx: ExecContext):
    """Ring permute: `shift` 1 sends each rank's value to the next rank, so
    rank i receives rank i - shift's."""
    x = ctx.input("X")
    g = _group(ctx)
    if g is None:
        return {"Out": x}
    return {"Out": _permute(g, x, int(ctx.attr("shift", 1)))}


@register_grad_compute("c_collective_permute")
def c_collective_permute_grad(ctx: ExecContext):
    gy = ctx.input("Out@GRAD")
    g = _group(ctx)
    if g is None or gy is None:
        return {"X@GRAD": gy}
    return {"X@GRAD": _permute(g, gy, -int(ctx.attr("shift", 1)),
                               "c_collective_permute_grad")}


@register_op("local_sgd_sync", grad="none")
def local_sgd_sync(ctx: ExecContext):
    """LocalSGD's periodic sync, branchless as in the JAX op: every step
    the (param - snapshot) deltas are mean-allreduced; on a step that
    `k_steps` divides they fold back into param and snapshot, on the
    others both pass through. Step is the counter, already incremented."""
    p = ctx.input("Param")
    snap = ctx.input("Snapshot")
    step = ctx.input("Step")
    k = int(ctx.attr("k_steps", 1))
    g = _group(ctx)
    delta = p - snap
    if g is not None and g.pg is not None:
        delta = _all_reduce(g, delta, "sum", "local_sgd_sync") / g.size
    synced = snap + delta
    do_sync = (step.reshape(()) % k) == 0
    return {"ParamOut": torch.where(do_sync, synced, p),
            "SnapshotOut": torch.where(do_sync, synced, snap)}


def _tp_group(ctx: ExecContext):
    g = _group(ctx)
    if g is None:
        raise RuntimeError(f"{ctx.op.type}: the tensor-parallel rewrite's "
                           f"ring {ctx.attr('ring_id')} is bound to no group "
                           f"in this run")
    return g


@register_op("tp_gather", grad="none")
def tp_gather(ctx: ExecContext):
    """The global value of X, sharded over the ring's ranks along `dim` in
    `groups` (parallel/tensor_parallel.py), or with an `extent` attr split
    by the ceil rule of the sequence-parallel rewrite (parallel/spatial.py)."""
    from ..parallel.tensor_parallel import gather_shards

    x = ctx.input("X")
    g = _tp_group(ctx)
    if ctx.attr("extent") is not None:
        # the sequence-parallel rewrite's: ceil shards of `extent` rows
        from ..parallel.spatial import ceil_gather

        return {"Out": ceil_gather(g, x, ctx.attr("dim"), ctx.attr("extent"),
                                   "sp_gather")}
    return {"Out": gather_shards(_all_gather(g, x.contiguous(), "tp_gather"),
                                 ctx.attr("dim"), ctx.attr("groups", 1))}


@register_op("tp_slice", grad="none")
def tp_slice(ctx: ExecContext):
    """This rank's shard of the replicated X along `dim` in `groups` (or of
    `extent` rows under the ceil rule): no communication."""
    from ..parallel.tensor_parallel import shard_tensor

    g = _tp_group(ctx)
    if ctx.attr("extent") is not None:
        from ..parallel.spatial import ceil_shard

        return {"Out": ceil_shard(ctx.input("X"), ctx.attr("dim"),
                                  ctx.attr("extent"), g.size, g.index)}
    return {"Out": shard_tensor(ctx.input("X"), ctx.attr("dim"),
                                ctx.attr("groups", 1), g.size, g.index)}


@register_op("c_sync_calc_stream", grad="none")
def c_sync_calc_stream(ctx: ExecContext):
    """Stream ordering is the executor's (one stream): the identity."""
    return {"Out": ctx.input("X")}


@register_op("c_sync_comm_stream", grad="none")
def c_sync_comm_stream(ctx: ExecContext):
    return {"Out": ctx.input("X")}


@register_op("c_comm_init_all", grad="none")
def c_comm_init_all(ctx: ExecContext):
    """The communicators are the process groups that
    distributed.init_parallel_env and the mesh made: nothing to do."""
    return {}


@register_op("c_gen_nccl_id", grad="none")
def c_gen_nccl_id(ctx: ExecContext):
    return {}
