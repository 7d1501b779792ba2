"""ZeRO-1, the sharding annotations, and the data-parallel rewrite.

`apply_zero1` is the JAX package's parallel/sharding.py rewrite, op for op
(the programs are equal by `to_dict()`): every eligible optimizer op (an
elementwise update, the parameter's leading dim divisible by the ranks)
updates only this rank's rows of its parameter and state, from the
reduce-scattered gradient, and the shards are gathered back after it.
The port keeps each rank's shard of the optimizer state in the scope (the
state's gather is elided, ops/collective_ops.py), which is ZeRO-1's memory
saving; the parameters are gathered.

In the JAX package `with_data_parallel` is one GSPMD program over the
global batch, and XLA's partitioner inserts the collectives. The port runs
one process a rank, so `data_parallel_rewrite` makes that program's
collectives explicit on a private clone: it propagates the batch sharding
from the feeds, tracks each value as sharded on its batch dim (the one
dynamic dim of its shape) or replicated, and puts a `c_allreduce_sum` on the rewrite's own ring after
every op that turns sharded inputs into a partial sum — a reduction over
the batch in the forward (BERT's masked-LM loss divides two of them, so
the ratio is the global one whatever each shard's mask count), and a
parameter's gradient in the backward. A partial read only by ops linear
in it (a cast back to the fp32 master's dtype, a sum of partials) stays
partial through them, so AMP's gradients are summed in fp32; the sum
goes right after the last such op, where the gradient is final. The rewrite runs after
`append_backward`, so nothing differentiates through an inserted op: each
rank's gradient of a forward reduction is its own, and the parameter
gradients are allreduce-summed (the forward reduction already holds the
global normaliser). `mean` is a sum over equal shards divided by the
global count: its reduction is a mean-allreduce, and its grad op's input
is scaled by 1 / ranks. A max, min or product over the batch is reduced
over the ranks inside the op (`Operator.global_reduce`, which its grad op
carries too: the gradient reaches only the global extremum).

Batch statistics and random draws, which GSPMD takes over the global batch
without being asked, get rules that mark the op on the clone (attributes
of the Operator object, outside its attrs, so no `to_dict()` changes). A
batch_norm or conv2d_bn in training is synced: `dp_sync` holds the ring,
over which it takes its statistics and its grad op K9's sums (ops/nn_ops.py
`_sync_group`); Y is sharded, MeanOut, VarianceOut, SavedMean and
SavedVariance replicated, and the grad op's Scale@GRAD and Bias@GRAD are
already global, so they are tracked replicated and not summed again.
data_norm normalises by its replicated counters; the grads of those
counters are sums over the batch, partial like any parameter gradient. An
op that draws random numbers on a sharded input (`_DRAWS`) gets `dp_draw`
= (ring, the draw's batch dim): it draws the global batch's tensor from
the run's generator, seeded alike on every rank, and keeps this rank's
rows (registry.ExecContext.draw), so its rows and every later draw are
the one-process run's. `accuracy` sums its Correct and Total over the
ranks and divides them again. An op with a sharded input and no rule
raises, naming the op: a sub-block over sharded values among them.
"""
from __future__ import annotations

__all__ = ["annotate_sharding", "annotation_spec", "apply_zero1",
           "ZERO1_OP_TYPES", "data_parallel_rewrite", "batch_dim"]

# optimizer ops whose update rule is elementwise in (param, grad, moments):
# a shard's update is then the full update restricted to the shard. LARS
# and LAMB take norms over the whole parameter and stay on the allreduce
ZERO1_OP_TYPES = {"sgd", "momentum", "adam", "adagrad", "rmsprop", "adamax",
                  "adadelta", "decayed_adagrad"}

_SHARD_SUFFIX = "@ZERO1_SHARD"
_GRAD_SUFFIX = "@ZERO1_GRAD"


def apply_zero1(program, nranks: int, ring_id: int = 0,
                replicated_grads: bool = False) -> list[str]:
    """ZeRO-1 as a program rewrite. For every eligible optimizer op the
    per-gradient mean-allreduce becomes

        c_reducescatter(grad)      -> grad shard       [d0/nranks, ...]
        zero1_shard(param/moments) -> state shards     (this rank's rows)
        <optimizer op over the shards>
        c_allgather(shards)        -> full param (and moments)

    The reduce-scatter sits where the gradient is final
    (backward.grad_ready_index), the gathers right after the update.
    Unbound, every inserted op is the identity and the rewrite is the
    plain update. `ring_id` is the ring of the inserted ops;
    `replicated_grads` (the data-parallel rewrite, whose gradients are
    already summed) takes the gradient's shard with `zero1_shard` in place
    of the reduce-scatter. Returns the parameters rewritten; the others
    (an indivisible leading dim, scalars, LARS/LAMB) are left to the
    caller's allreduce."""
    from ..backward import grad_ready_index

    block = program.global_block
    handled: list[str] = []
    opt_ops = [op for op in block.ops if op.type in ZERO1_OP_TYPES]
    if not opt_ops:
        return handled
    first_opt = min(block.ops.index(op) for op in opt_ops)

    for op in reversed(opt_ops):
        pname = op.input("Param")[0]
        gname = op.input("Grad")[0]
        pvar = block.var(pname)
        d0 = pvar.shape[0] if pvar.shape else 0
        if len(pvar.shape) < 1 or d0 < nranks or d0 % nranks != 0:
            continue
        shard0 = d0 // nranks

        # every non-Grad/LR input sharing the param's leading dim shards
        # with it (Param, Velocity, Moment1/2, ...); scalars stay whole
        shard_of: dict[str, str] = {}
        for slot, names in op.inputs.items():
            if slot in ("Grad", "LearningRate"):
                continue
            for n in names:
                if not n or not block.has_var(n):
                    continue
                v = block.var(n)
                if v.shape and v.shape[0] == d0:
                    shard_of[n] = n + _SHARD_SUFFIX

        gshard = gname + _GRAD_SUFFIX
        gvar = block.var(gname)
        block.create_var(name=gshard, shape=[shard0] + list(gvar.shape[1:]),
                         dtype=gvar.dtype)
        for n, sn in shard_of.items():
            v = block.var(n)
            block.create_var(name=sn, shape=[shard0] + list(v.shape[1:]),
                             dtype=v.dtype)

        op.inputs = {
            slot: [gshard if n == gname else shard_of.get(n, n)
                   for n in names]
            for slot, names in op.inputs.items()}
        op.outputs = {slot: [shard_of.get(n, n) for n in names]
                      for slot, names in op.outputs.items()}

        i = block.ops.index(op)
        for n, sn in sorted(shard_of.items(), reverse=True):
            block._insert_op(i + 1, "c_allgather", {"X": [sn]}, {"Out": [n]},
                             {"ring_id": ring_id})
        for n, sn in sorted(shard_of.items(), reverse=True):
            block._insert_op(i, "zero1_shard", {"X": [n]}, {"Out": [sn]},
                             {"ring_id": ring_id})
        ready = grad_ready_index(block, gname, first_opt)
        at = (ready + 1) if ready >= 0 else block.ops.index(op)
        if replicated_grads:
            block._insert_op(at, "zero1_shard", {"X": [gname]},
                             {"Out": [gshard]}, {"ring_id": ring_id})
        else:
            block._insert_op(at, "c_reducescatter", {"X": [gname]},
                             {"Out": [gshard]},
                             {"ring_id": ring_id, "avg": True})
        first_opt += 1
        handled.append(pname)

    handled.reverse()
    return handled


def annotate_sharding(var, spec: tuple):
    """Attach a per-dim mesh-axis annotation to a Variable (metadata the
    tensor-parallel slices will read)."""
    var.sharding = tuple(spec)
    return var


def annotation_spec(mesh, var, strict: bool = False) -> tuple:
    """A Variable's annotation as a per-dim tuple of axis names (None for
    an unsharded dim), padded or cut to its rank. Axes the mesh lacks are
    dropped, or raise with strict=True."""
    if strict:
        missing = [a for a in var.sharding
                   if a is not None and a not in mesh.axis_names]
        if missing:
            raise ValueError(
                f"feed '{var.name}' is annotated with mesh axes {missing} "
                f"that this mesh {mesh.axis_names} does not have")
    axes = [a if a in mesh.axis_names else None for a in var.sharding]
    rank = len(var.shape)
    return tuple((list(axes) + [None] * rank)[:rank])


# -- the data-parallel rewrite ---------------------------------------------

_SHARDED, _REPLICATED, _PARTIAL = "sharded", "replicated", "partial"
_BATCH_NORMS = {"batch_norm", "conv2d_bn", "data_norm"}
_BN_GRADS = {"batch_norm_grad", "conv2d_bn_grad"}
# the ops that draw random numbers with a rule, each with the input whose
# rows its draw follows: the draw's batch dim is that input's (dropout's
# draw has X's shape), the output_dim_idx of a *_batch_size_like op, and
# dim 0 for the others, whose input must then have its batch first
_DRAWS = {"dropout": "X", "uniform_random_batch_size_like": "Input",
          "gaussian_random_batch_size_like": "Input", "sampling_id": "X",
          "nce": "Input", "sample_logits": "Logits", "random_crop": "X",
          "cudnn_lstm": "Input"}
_MEANS = {"mean", "reduce_mean"}
_EXTREMES = {"reduce_max", "reduce_min", "reduce_prod"}


def _keeps_partial(op, state) -> bool:
    """True where `op` is linear in its partial inputs, so its output is a
    partial sum too and the allreduce can wait for its consumer: a cast
    (AMP's bf16 gradient back to the fp32 master's, whose sum is then
    taken in fp32), a bias-free scale, an assign, or a sum of partials."""
    ins = [n for n in op.input_names if n]
    if op.type == "sum":
        return all(state.get(n) == _PARTIAL for n in ins)
    if op.type == "scale" and op.attrs.get("bias", 0.0):
        return False
    if op.type in ("cast", "scale", "assign"):
        return True
    if op.type == "cast_grad":
        return state.get(op.input("Out@GRAD")[0]) == _PARTIAL and all(
            state.get(n) != _SHARDED for n in ins)
    return False


def _unsupported(op, why):
    return NotImplementedError(
        f"with_data_parallel over more than one rank: op '{op.type}' {why}; "
        f"it has no data-parallel rule yet (ROADMAP Queue 1, \"parallel and "
        f"distributed\")")


def _draw_dim(op, block):
    """The dim of `op`'s draw that follows the batch (`_DRAWS`)."""
    src = op.input(_DRAWS[op.type])[0]
    dim = batch_dim(_var_of(block, src))
    if op.type == "dropout":
        return dim
    if op.type.endswith("_batch_size_like"):
        if dim != op.attrs.get("input_dim_idx", 0):
            raise _unsupported(op, "sizes its draw by a dim of Input that is "
                                   "not the batch's")
        return int(op.attrs.get("output_dim_idx", 0))
    if dim != 0:
        raise _unsupported(op, f"draws by the rows of '{src}', whose batch "
                               f"dim is not its first")
    return 0


def batch_dim(var):
    """The dim of `var` that carries the batch: its one dynamic (-1) dim,
    or None where it has none or several."""
    dyn = [i for i, d in enumerate(var.shape) if d == -1]
    return dyn[0] if len(dyn) == 1 else None


def _reduces_batch(op, block) -> bool:
    if op.attrs.get("reduce_all", False) or op.type == "mean":
        return True
    x = block.var(op.input("X")[0])
    dims = op.attrs.get("dim", [0])
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return batch_dim(x) in [d % max(len(x.shape), 1) for d in dims]


def _forward_name(grad_name: str) -> str:
    return grad_name.split("@GRAD")[0]


def _var_of(block, name):
    """The var `name`, or for a gradient temporary the backward declared
    no var for (`x@GRAD@RENAME@0`), its forward var, whose shape it has."""
    try:
        return block.var(name)
    except KeyError:
        return block.var(_forward_name(name))


def data_parallel_rewrite(program, nranks: int, feed_names, ring_id: int,
                          in_place: bool = False):
    """A clone of `program` whose values follow the global batch when each
    of `nranks` ranks feeds its own equal share of it (module docstring);
    `in_place` rewrites `program` itself (a clone the tensor-parallel
    rewrite made, whose collectives keep the batch sharding like any op).
    Returns (the program, the names of the values left sharded)."""
    from ..framework import Operator
    from ..ops.registry import get_op_def

    clone = program if in_place else program.clone()
    block = clone.global_block
    state: dict[str, str] = {}
    for n in feed_names:
        v = block.vars.get(n)
        if v is not None and len(v.shape) >= 1:
            state[n] = _SHARDED
    scaled_means: set[str] = set()
    extremes: dict[str, tuple] = {}
    ops = []

    def allreduce(n, avg=False):
        """Sum `n` over the ranks right after its last writer so far."""
        at = max(i for i, o in enumerate(ops) if n in o.output_names) + 1
        ops.insert(at, Operator(block, "c_allreduce_sum", {"X": [n]},
                                {"Out": [n]}, {"ring_id": ring_id,
                                               "avg": avg}))
        state[n] = _REPLICATED

    summed_later = set()   # partials a linear op read: its output carries them
    for op in block.ops:
        partial = [n for n in op.input_names if n and state.get(n) == _PARTIAL]
        if partial and _keeps_partial(op, state):
            summed_later.update(partial)
            ops.append(op)
            for n in op.output_names:
                if n:
                    state[n] = _PARTIAL
            continue
        for n in dict.fromkeys(partial):
            allreduce(n)
        sharded = [n for n in op.input_names
                   if n and state.get(n) == _SHARDED]
        if not sharded:
            ops.append(op)
            for n in op.output_names:
                if n:
                    state[n] = _REPLICATED
            continue
        train = not op.attrs.get("is_test", False)
        if any(k.startswith("sub_block") or k == "blocks" for k in op.attrs):
            raise _unsupported(op, "runs a sub-block on sharded values")
        if op.type in _BATCH_NORMS:
            if train and op.type != "data_norm":
                op.dp_sync = ring_id
            ops.append(op)
            for slot, names in op.outputs.items():
                for n in filter(None, names):
                    if slot == "Y" and batch_dim(_var_of(block, n)) is None:
                        raise _unsupported(op, f"writes '{n}', in which no "
                                               f"one dim is the batch's")
                    state[n] = _SHARDED if slot == "Y" else _REPLICATED
            continue
        if op.type in _BN_GRADS and train:
            op.dp_sync = ring_id
            ops.append(op)
            for slot, names in op.outputs.items():
                for n in filter(None, names):
                    if slot in ("Scale@GRAD", "Bias@GRAD"):
                        state[n] = _REPLICATED
                    else:
                        sharded_fwd = state.get(_forward_name(n)) == _SHARDED
                        state[n] = _SHARDED if sharded_fwd else _PARTIAL
            continue
        if op.type == "accuracy":
            # Correct and Total are sums over the batch: summed over the
            # ranks, Accuracy is their ratio again
            ops.append(op)
            correct, total = op.output("Correct")[0], op.output("Total")[0]
            allreduce(correct)
            allreduce(total)
            as_float = []
            for n in (correct, total):
                f = n + "@DP_FLOAT"
                block.create_var(name=f, shape=block.var(n).shape,
                                 dtype="float32")
                ops.append(Operator(block, "cast", {"X": [n]}, {"Out": [f]},
                                    {"out_dtype": "float32"}))
                as_float.append(f)
            ops.append(Operator(block, "elementwise_div",
                                {"X": as_float[:1], "Y": as_float[1:]},
                                {"Out": op.output("Accuracy")}, {"axis": -1}))
            for n in op.output_names:
                state[n] = _REPLICATED
            continue
        if get_op_def(op.type).needs_rng and train:
            if op.type not in _DRAWS:
                raise _unsupported(op, "draws random numbers, which the "
                                       "global program draws over the "
                                       "global batch")
            op.dp_draw = (ring_id, _draw_dim(op, block))
        if op.type.endswith("_grad"):
            fwd_out = _forward_name(op.input("Out@GRAD")[0]) \
                if op.inputs.get("Out@GRAD") else None
            if op.type[:-len("_grad")] in _EXTREMES and fwd_out in extremes:
                op.global_reduce = extremes[fwd_out]
            if op.type in ("mean_grad", "reduce_mean_grad") and \
                    _forward_name(op.input("Out@GRAD")[0]) in scaled_means:
                g = op.input("Out@GRAD")[0]
                scaled = g + "@DP_SCALED"
                gv = block.var(g)
                block.create_var(name=scaled, shape=gv.shape, dtype=gv.dtype)
                ops.append(Operator(block, "scale", {"X": [g]},
                                    {"Out": [scaled]},
                                    {"scale": 1.0 / nranks, "bias": 0.0,
                                     "bias_after_scale": True}))
                op.inputs = {s: [scaled if n == g else n for n in names]
                             for s, names in op.inputs.items()}
            ops.append(op)
            for n in op.output_names:
                if n:
                    sharded_fwd = state.get(_forward_name(n)) == _SHARDED
                    state[n] = _SHARDED if sharded_fwd else _PARTIAL
            continue
        if op.type in _EXTREMES and _reduces_batch(op, block):
            # the reduction over every rank's rows runs inside the op, whose
            # grad then reaches only the global extremum (parallel/
            # spatial.py global_reduce); Out is replicated
            op.global_reduce = tuple(getattr(op, "global_reduce", ())) + \
                (ring_id,)
            extremes[op.output("Out")[0]] = op.global_reduce
            ops.append(op)
            state[op.output("Out")[0]] = _REPLICATED
            continue
        if op.type in ("reduce_sum",) + tuple(_MEANS) and \
                _reduces_batch(op, block):
            ops.append(op)
            out = op.output("Out")[0]
            mean = op.type in _MEANS
            if mean:
                scaled_means.add(out)
            allreduce(out, avg=mean)
            continue
        for n in sharded:
            if batch_dim(_var_of(block, n)) is None:
                raise _unsupported(op, f"reads '{n}', in which no one dim "
                                       f"is the batch's")
        ops.append(op)
        for slot, names in op.outputs.items():
            for n in names:
                if not n:
                    continue
                if slot != "XShape" and batch_dim(_var_of(block, n)) is None:
                    raise _unsupported(op, f"turns sharded inputs into "
                                           f"'{n}', in which no one dim is "
                                           f"the batch's")
                state[n] = _SHARDED
    for n in [n for n, st in state.items()
              if st == _PARTIAL and n not in summed_later]:
        allreduce(n)
    block.ops = ops
    return clone, {n for n, s in state.items() if s == _SHARDED}
