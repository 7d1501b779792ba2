"""Tensor parallelism: the Megatron rewrite of a program over a `tp` axis.

In the JAX package `with_data_parallel` over a mesh with a `tp` axis is one
GSPMD program: the weights carry `sharding` annotations (`use_tp` in
models/transformer.py, serving/model.py's `apply_tp_annotations`) and XLA's
partitioner shards them and inserts the collectives. The port runs one
process a rank, so `tensor_parallel_rewrite` makes those collectives
explicit on a private clone, after `append_backward`, as the data-parallel
rewrite does for the batch (parallel/sharding.py).

Each value is tracked as replicated, partial (a sum over the `tp` ranks
still to be taken) or sharded on one dim. A sharded dim of global size D in
`groups` g is laid out [g, tp, D / (g tp)]: rank r holds block r of every
group. A weight's layout comes from its annotation and its first use: a
column-parallel weight whose output a reshape splits into [..., nh, dh]
(the fused `q | k | v` projection [H, 3H], reshaped to [.., 3, nh, dh])
shards on its heads, in as many groups as the reshape has blocks before
them, so that every rank holds the columns of its heads in all three
blocks and q, k and v come out head-sharded with no collective. A dim that
`tp` does not divide, or heads that it does not divide, stay replicated,
as GSPMD leaves them.

The rules, op by op:
  * a `mul` by a column-parallel weight gives a sharded output; by a
    row-parallel weight a partial one, summed (`c_allreduce_sum` on the
    rewrite's ring) before the first op that is not linear in it: the
    bias add of `L.fc` runs after the sum, once;
  * elementwise ops, reshapes (the sharded dim mapped through the reshape,
    its target dim's attr divided by tp), transposes, slices, squeezes and
    the head-parallel ops (`fused_attention`, the paged KV-cache ops and
    paged attention) keep a shard where it is; a replicated operand that
    meets a shard at full size is sliced locally (`tp_slice`);
  * a reduction over a sharded dim gives a partial (`reduce_sum`,
    `squared_l2_norm`), a mean an averaged one and a max a max over ranks;
  * `softmax_with_cross_entropy` over logits sharded on their class dim is
    marked vocab-parallel (`Operator.tp_vocab`, ops/nn_ops.py): each rank
    runs K6/K7 on its slice and the row statistics are reduced over tp;
  * an op with a sharded input and no rule gathers it (`tp_gather`) and
    runs replicated, GSPMD's own fallback; a sub-block over sharded
    values raises; `lamb` / `lars_momentum` on a sharded parameter update
    each shard, their norms over the whole parameter summed over tp
    (`Operator.tp_norms`, ops/optimizer_ops.py).
A grad op reads what its forward op read (the same slices and gathers) and
its outputs follow the forward's inputs: the gradient of a sharded value is
sharded, that of a replicated value is partial where the grad op read a
shard (Megatron's f: a column-parallel `mul_grad`'s dX) and replicated
otherwise (layer norms, embeddings, row-parallel biases: never summed over
tp). The optimizer updates each shard of a sharded parameter, whose
moments are sharded with it. AMP's found-inf flag is OR-reduced over tp
(`Operator.tp_found`) before the unscale zeroes a step.

The scope holds each rank's shard of every sharded persistable var
(`layouts`); `shard_scope` cuts a scope's global tensors to them before a
run, and `global_value` gathers one back (io's saves).
"""
from __future__ import annotations

import numpy as np

__all__ = ["tensor_parallel_rewrite", "shard_tensor", "gather_shards",
           "shard_scope", "global_value", "local_value", "reshape_shard",
           "TPLayout"]

MODEL_AXIS = "tp"
_P = "partial"
_BIG = 1000003   # a prime standing for a dynamic (-1) extent in reshapes

UNARY = {"gelu", "relu", "tanh", "sigmoid", "exp", "log", "sqrt", "rsqrt",
         "square", "abs", "scale", "cast", "assign", "softsign", "swish",
         "leaky_relu", "elu", "relu6", "hard_swish", "hard_sigmoid", "silu",
         "sin", "cos", "floor", "ceil", "round", "reciprocal", "clip", "pow",
         "logsigmoid", "softplus", "brelu", "stanh", "thresholded_relu",
         "soft_relu", "erf", "fill_zeros_like", "fill_any_like", "sign"}
BINARY = {"elementwise_add", "elementwise_sub", "elementwise_mul",
          "elementwise_div", "elementwise_max", "elementwise_min",
          "elementwise_pow"}
# ops that run per head: {type: ({input slot: its heads dim}, {output slot:
# its heads dim})}; the pools are [pages, ps, nh, dh]
HEAD_OPS = {
    "fused_attention": ({"Q": 1, "K": 1, "V": 1}, {"Out": 1}),
    "kv_cache_append": ({"KPool": 2, "VPool": 2, "K": 1, "V": 1},
                        {"KPoolOut": 2, "VPoolOut": 2}),
    "kv_cache_prefill_write": ({"KPool": 2, "VPool": 2, "K": 1, "V": 1},
                               {"KPoolOut": 2, "VPoolOut": 2}),
    "kv_cache_copy_page": ({"KPool": 2, "VPool": 2},
                           {"KPoolOut": 2, "VPoolOut": 2}),
    "paged_decode_attention": ({"Q": 1, "KPool": 2, "VPool": 2}, {"Out": 1}),
    "paged_prefill_attention": ({"Q": 1, "KPool": 2, "VPool": 2}, {"Out": 1}),
}
_OPTIMIZERS = {"sgd", "momentum", "adam", "adagrad", "rmsprop", "adamax",
               "adadelta", "decayed_adagrad", "ftrl", "lamb",
               "lars_momentum", "dgc_momentum"}
_WHOLE_PARAM = {"lamb", "lars_momentum"}


class TPLayout:
    """Where a sharded persistable var's shard lies: `dim`, `groups`, the
    var's global shape, and the tp group (an AxisGroup) it is split over."""

    def __init__(self, dim, groups, shape, group):
        self.dim, self.groups = int(dim), int(groups)
        self.shape = tuple(int(s) for s in shape)
        self.group = group

    @property
    def local_shape(self):
        s = list(self.shape)
        s[self.dim] //= self.group.size
        return tuple(s)


def shard_tensor(t, dim, groups, size, index):
    """Rank `index` of `size`'s shard of `t` along `dim` laid out in
    `groups` (module docstring), contiguous."""
    dim = dim % t.dim()
    parts = t.unflatten(dim, (groups, size, t.shape[dim] // (groups * size)))
    return parts.select(dim + 1, index).flatten(dim, dim + 1).contiguous()


def gather_shards(parts, dim, groups):
    """The global tensor of the ranks' shards `parts` (rank order)."""
    import torch

    dim = dim % parts[0].dim()
    split = [p.unflatten(dim, (groups, p.shape[dim] // groups))
             for p in parts]
    return torch.stack(split, dim=dim + 1).flatten(dim, dim + 2)


def shard_scope(scope, layouts: dict) -> None:
    """Cut every scope tensor of a sharded var that still has its global
    shape to this rank's shard, and record the layouts on the scope. A
    tensor of neither the global nor the shard's shape raises."""
    held = scope.__dict__.setdefault("tp_layouts", {})
    for name, lay in layouts.items():
        held[name] = lay
        t = scope.find_var(name)
        if t is None or not hasattr(t, "shape"):
            continue
        if tuple(t.shape) == lay.local_shape:
            continue
        if tuple(t.shape) != lay.shape:
            raise ValueError(
                f"tensor parallelism: scope var '{name}' has shape "
                f"{tuple(t.shape)}, neither its global {lay.shape} nor its "
                f"shard's {lay.local_shape}")
        scope.set_var(name, shard_tensor(t, lay.dim, lay.groups,
                                         lay.group.size, lay.group.index))


def global_value(scope, name, value):
    """`value` (the scope's tensor of `name`) as the global tensor: a
    tp-sharded var is gathered over its group (collective: every rank of
    the group calls it), any other returned as it is."""
    from ..ops.collective_ops import _all_gather

    lay = getattr(scope, "tp_layouts", {}).get(name)
    if lay is None or tuple(value.shape) != lay.local_shape or \
            lay.group.size == 1:
        return value
    return gather_shards(_all_gather(lay.group, value.contiguous(),
                                     "tp save"), lay.dim, lay.groups)


def local_value(scope, name, value):
    """A global tensor for `name` cut to this rank's shard where the scope
    holds `name` tp-sharded (load_params), else `value`."""
    lay = getattr(scope, "tp_layouts", {}).get(name)
    if lay is None or tuple(value.shape) != lay.shape:
        return value
    return shard_tensor(value, lay.dim, lay.groups, lay.group.size,
                        lay.group.index)


def _is_shard(s):
    return isinstance(s, tuple)


def _resolve_reshape(in_shape, attr):
    """(input shape, target shape) as concrete ints for a reshape2 attr
    (0 copies the input dim at its index, -1 is inferred), the dynamic
    extents standing as _BIG."""
    ins = [(_BIG if d < 0 else int(d)) for d in in_shape]
    out = [ins[i] if d == 0 and i < len(ins) else int(d)
           for i, d in enumerate(attr)]
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        out[out.index(-1)] = int(np.prod(ins)) // known
    return ins, out


def _inner(shape, d):
    return int(np.prod(shape[d + 1:])) if d + 1 < len(shape) else 1


def reshape_shard(in_shape, attr, dim, groups, tp):
    """The target (dim, groups) of a reshape of a value sharded on `dim` in
    `groups`, or None where the target cannot hold the shard: the rank's
    elements are those whose flat index mod blk lies in its tp-th of blk
    (blk = D / groups times the inner extent), and a target dim t holds
    the same set where blk is a multiple of its size times its inner
    extent over groups, and blk / tp of its inner extent."""
    ins, outs = _resolve_reshape(in_shape, attr)
    blk = ins[dim] // groups * _inner(ins, dim)
    sub = blk // tp
    for t in range(len(outs)):
        inner = _inner(outs, t)
        span = outs[t] * inner
        if outs[t] > 1 and span % blk == 0 and sub % inner == 0 and \
                (blk // inner) % tp == 0 and blk >= inner:
            return t, span // blk
    return None


class _Rewrite:
    KIND, AXIS = "tensor", MODEL_AXIS   # what the refusals name

    def __init__(self, program, tp, ring, group, in_place=False):
        self.clone = program if in_place else program.clone()
        self.block = self.clone.global_block
        self.tp, self.ring, self.group = tp, ring, group
        self.st: dict[str, object] = {}
        self.layouts: dict[str, TPLayout] = {}
        self.ops = []
        self.producer = {}
        self.info = {}
        self.cons = {}
        self.n_new = 0
        self.scaled_means = set()
        self.summed_later = set()
        for op in self.block.ops:
            if op.type.endswith("_grad"):
                continue
            for slot, names in op.inputs.items():
                for n in names:
                    if n:
                        self.cons.setdefault(n, []).append((op, slot))
        self.producers = {}
        for op in self.block.ops:
            if not op.type.endswith("_grad"):
                for n in op.output_names:
                    if n:
                        self.producers.setdefault(n, op)

    # -- helpers -----------------------------------------------------------
    def refusal(self, op, why):
        return NotImplementedError(
            f"{self.KIND} parallelism over the '{self.AXIS}' axis: op "
            f"'{op.type}' {why}; it has no {self.KIND}-parallel rule yet "
            f"(ROADMAP Queue 1, \"parallel and distributed\")")

    def var(self, name):
        try:
            return self.block.var(name)
        except KeyError:
            return self.block.var(name.split("@GRAD")[0])

    def shape(self, name):
        return list(self.var(name).shape)

    def new_var(self, base, tag):
        """A new var named after `base`, of its (global) shape and dtype."""
        self.n_new += 1
        v = self.var(base)
        name = f"{base}@TP_{tag}{self.n_new}"
        self.block.create_var(name=name, shape=list(v.shape), dtype=v.dtype)
        return name

    def insert(self, type_, ins, outs, attrs):
        from ..framework import Operator

        attrs = dict(attrs, ring_id=self.ring)
        self.ops.append(Operator(self.block, type_, ins, outs, attrs))

    def allreduce(self, name, red="sum", avg=False):
        t = "c_allreduce_sum" if red == "sum" else "c_allreduce_" + red
        attrs = {"avg": avg} if red == "sum" else {}
        self.insert(t, {"X": [name]}, {"Out": [name]}, attrs)
        self.st[name] = None

    def coerce(self, name, want, into=None):
        """Insert what turns `name` (in its state) into `want`; returns the
        name that holds it (`into` where given, else a new var, or `name`
        itself for an in-place sum)."""
        cur = self.st.get(name)
        if cur == _P:
            self.allreduce(name)
            cur = None
        if cur == want:
            if into is not None and into != name:
                self.insert("assign", {"X": [name]}, {"Out": [into]}, {})
                self.st[into] = want
                return into
            return name
        src = name
        if _is_shard(cur):
            full = into if (want is None and into is not None) else \
                self.new_var(name, "FULL")
            self.insert("tp_gather", {"X": [src]}, {"Out": [full]},
                        {"dim": cur[0], "groups": cur[1]})
            self.st[full] = None
            src = full
            if want is None:
                return full
        out = into or self.new_var(name, f"S{want[0]}G{want[1]}_")
        self.insert("tp_slice", {"X": [src]}, {"Out": [out]},
                    {"dim": want[0], "groups": want[1]})
        self.st[out] = want
        return out

    # -- layouts -----------------------------------------------------------
    def _uses(self, name, seen=()):
        """(op, slot) uses of `name`, looking through casts and assigns."""
        out = []
        for op, slot in self.cons.get(name, []):
            if op.type in ("cast", "assign") and name not in seen:
                out += self._uses(op.output("Out")[0], seen + (name,))
            else:
                out.append((op, slot))
        return out

    def _source_param(self, name):
        """The persistable var `name` is a cast or assign of, or `name`."""
        op = self.producers.get(name)
        while op is not None and op.type in ("cast", "assign"):
            name = op.input("X")[0]
            op = self.producers.get(name)
        return name

    def _heads_groups(self, mul_op, cols):
        """The groups of a column-parallel weight of `cols` columns: its
        output followed through a bias add to a reshape that splits the
        columns into [.., nh, dh] shards on nh (None where tp does not
        divide nh); no such reshape: one group."""
        name = mul_op.output("Out")[0]
        for _ in range(4):
            nxt = self._uses(name)
            if len(nxt) != 1:
                return 1
            op, slot = nxt[0]
            if op.type in ("reshape2", "reshape"):
                _, outs = _resolve_reshape(self.shape(name),
                                           op.attrs.get("shape", []))
                split = [t for t in range(len(outs))
                         if outs[t] * _inner(outs, t) <= cols]
                if len(split) < 2:
                    return 1
                t = split[-2]
                if outs[t] % self.tp:
                    return None
                return cols // (outs[t] * _inner(outs, t))
            if op.type in BINARY and slot == "X":
                name = op.output("Out")[0]
                continue
            return 1
        return 1

    def _decide(self, name, spec, memo):
        if name in memo:
            return memo[name]
        memo[name] = None
        v = self.block.vars[name]
        shape = list(v.shape)
        if MODEL_AXIS not in spec:
            return None
        d = list(spec).index(MODEL_AXIS)
        if d >= len(shape) or shape[d] <= 0 or shape[d] % self.tp:
            return None
        g = 1
        uses = self._uses(name)
        for op, slot in uses:
            if op.type == "mul" and slot == "Y" and len(shape) == 2 and \
                    d == 1:
                g = self._heads_groups(op, shape[1])
            elif op.type in BINARY and slot == "Y" and len(shape) == 1:
                prod = self.producers.get(op.input("X")[0])
                w = None
                if prod is not None and prod.type == "mul":
                    w = self._source_param(prod.input("Y")[0])
                wv = self.block.vars.get(w) if w else None
                lay = (self._decide(w, tuple(wv.sharding), memo)
                       if wv is not None and wv.sharding else None)
                if lay is None or lay[0] != 1:
                    return None
                g = lay[1]
            if g is None:
                return None
        if shape[d] % (g * self.tp):
            return None
        memo[name] = (d, g)
        return memo[name]

    def decide_layouts(self):
        memo = {}
        for name, v in self.block.vars.items():
            spec = getattr(v, "sharding", None)
            if v.persistable and spec and MODEL_AXIS in spec:
                lay = self._decide(name, tuple(spec), memo)
                if lay is not None:
                    self.st[name] = lay
                    self.layouts[name] = TPLayout(lay[0], lay[1], v.shape,
                                                  self.group)

    # -- the walk ----------------------------------------------------------
    def run(self):
        self.decide_layouts()
        for op in self.block.ops:
            fwd = self._forward_op_of(op)
            if fwd is not None:
                self.grad_op(op, fwd)
            else:
                self.forward_op(op)
        for n in [n for n, s in self.st.items()
                  if s == _P and n not in self.summed_later]:
            self.allreduce(n)
        self.block.ops = self.ops
        for n, s in self.st.items():
            v = self.block.vars.get(n)
            if _is_shard(s) and v is not None and v.persistable and \
                    n not in self.layouts:
                self.layouts[n] = TPLayout(s[0], s[1], v.shape, self.group)
        return self.clone

    def _forward_op_of(self, op):
        if not op.type.endswith("_grad"):
            return None
        for slot, names in op.inputs.items():
            if slot.endswith("@GRAD"):
                for n in names:
                    f = self.producer.get(n[:-len("@GRAD")]) if \
                        n.endswith("@GRAD") else None
                    if f is not None and f.type == op.type[:-len("_grad")]:
                        return f
        return None

    def _sub_block_reads(self, op):
        """Every var name the sub-blocks of `op` read (nested ones too);
        the op's own input slots may not list them."""
        idx = [v for k, v in op.attrs.items()
               if k.startswith("sub_block") or k == "blocks"]
        todo = [i for v in idx for i in (v if isinstance(v, (list, tuple))
                                         else [v]) if isinstance(i, int)]
        names = set(op.input_names)
        while todo:
            blk = self.clone.blocks[todo.pop()]
            for o in blk.ops:
                names.update(n for n in o.input_names if n)
                todo += [i for k, v in o.attrs.items()
                         if k.startswith("sub_block") or k == "blocks"
                         for i in (v if isinstance(v, (list, tuple)) else [v])
                         if isinstance(i, int)]
        return names if len(idx) else ()

    def _in_states(self, op):
        return {(s, i): self.st.get(n) for s, ns in op.inputs.items()
                for i, n in enumerate(ns) if n}

    def _keeps_partial(self, op, partial):
        """True where `op` is linear in its partial inputs (a cast, a
        bias-free scale, an assign, a sum of partials), so its output is a
        partial too and the sum waits for its consumer."""
        ins = [n for n in op.input_names if n]
        if op.type == "sum" or (op.type == "elementwise_add" and
                                op.attrs.get("axis", -1) == -1):
            return all(self.st.get(n) == _P for n in ins)
        if op.type == "scale" and op.attrs.get("bias", 0.0):
            return False
        if op.type in ("cast", "scale", "assign"):
            return True
        if op.type == "cast_grad":
            return self.st.get(op.input("Out@GRAD")[0]) == _P and all(
                not _is_shard(self.st.get(n)) for n in ins)
        return False

    def _finish(self, op, in_states, want, outs, marks=None):
        """Apply the coercions `want` {(slot, i): state} to `op`, append
        it and set its outputs' states `outs` {(slot, i): state}."""
        renames, orig = {}, {}
        for (slot, i), w in want.items():
            n = op.inputs[slot][i]
            if self.st.get(n) != w:
                new = self.coerce(n, w)
                orig[(slot, i)] = n
                renames[(slot, i)] = new
                op.inputs[slot][i] = new
        read = {k: self.st.get(op.inputs[k[0]][k[1]]) for k in in_states}
        self.info[id(op)] = (in_states, read, renames, orig)
        self.ops.append(op)
        for slot, names in op.outputs.items():
            for i, n in enumerate(names):
                if n:
                    self.st[n] = outs.get((slot, i))
                    self.producer[n] = op
        for k, v in (marks or {}).items():
            setattr(op, k, v)

    def forward_op(self, op):
        in_states = self._in_states(op)
        partial = [n for n in op.input_names if n and self.st.get(n) == _P]
        if partial and self._keeps_partial(op, partial):
            self.summed_later.update(partial)
            self._finish(op, in_states, {}, {
                (s, i): _P for s, ns in op.outputs.items()
                for i, _ in enumerate(ns)})
            return
        for n in dict.fromkeys(partial):
            self.allreduce(n)
        in_states = self._in_states(op)
        if any(self.st.get(n) is not None for n in self._sub_block_reads(op)):
            raise self.refusal(op, f"runs a sub-block on {self.AXIS}-sharded "
                                   f"values")
        if not any(_is_shard(s) for s in in_states.values()):
            self._finish(op, in_states, {}, {})
            return
        rule = getattr(self, "rule_" + op.type, None)
        if rule is None and op.type.endswith("_grad"):
            rule = self.rule_grad_fallback
        if rule is None:
            if op.type in UNARY:
                rule = self.rule_unary
            elif op.type in BINARY or op.type == "sum":
                rule = self.rule_binary
            elif op.type in HEAD_OPS:
                rule = self.rule_heads
            elif op.type in _OPTIMIZERS:
                rule = self.rule_optimizer
            elif op.type in ("reduce_sum", "reduce_mean", "reduce_max",
                             "mean", "squared_l2_norm", "reduce_min"):
                rule = self.rule_reduce
            else:
                rule = self.rule_fallback
        res = rule(op, in_states)
        if res is None:
            res = self.rule_fallback(op, in_states)
        want, outs = res[0], res[1]
        marks = res[2] if len(res) > 2 else None
        self._finish(op, in_states, want, outs, marks)
        post = getattr(op, "_tp_post", None)
        if post:
            post()
            del op._tp_post

    # -- forward rules (each returns (want, outs[, marks]) or None) ---------
    def rule_fallback(self, op, ins):
        return ({k: None for k, s in ins.items() if _is_shard(s)}, {})

    def rule_grad_fallback(self, op, ins):
        """A grad op whose forward op was not found: it runs replicated,
        and each gradient is cut back to its forward var's shard."""
        def post():
            for slot, names in op.outputs.items():
                for i, n in enumerate(names):
                    want = self.st.get(n.split("@GRAD")[0]) if n else None
                    if slot.endswith("@GRAD") and _is_shard(want):
                        tmp = self.new_var(n, "G")
                        names[i] = tmp
                        self.st[tmp] = None
                        self.coerce(tmp, want, into=n)
                        self.st[n] = want
        op._tp_post = post
        return ({k: None for k, s in ins.items() if _is_shard(s)}, {})

    def _one_out(self, op, state):
        return {(s, i): state for s, ns in op.outputs.items()
                for i, n in enumerate(ns) if n and s != "XShape"}

    def rule_unary(self, op, ins):
        s = [v for v in ins.values() if _is_shard(v)]
        if len(ins) != 1:
            return None
        return {}, self._one_out(op, s[0])

    def rule_binary(self, op, ins):
        names = [(k, op.inputs[k[0]][k[1]]) for k in ins]
        ranks = {k: len(self.shape(n)) for k, n in names}
        top = max(ranks.values())
        axis = op.attrs.get("axis", -1)
        target = None
        maps = {}
        for k, n in names:
            r = ranks[k]
            off = 0 if r == top else (axis if axis not in (-1, None)
                                      else top - r)
            maps[k] = off
            s = ins[k]
            if _is_shard(s):
                t = (s[0] + off, s[1])
                if target is None:
                    target = t
                elif target != t:
                    return None
        want = {}
        for k, n in names:
            s, off = ins[k], maps[k]
            local = target[0] - off
            if _is_shard(s):
                continue
            shape = self.shape(n)
            if 0 <= local < len(shape) and shape[local] != 1:
                want[k] = (local, target[1])
        return want, self._one_out(op, target)

    def rule_mul(self, op, ins):
        xn = op.attrs.get("x_num_col_dims", 1)
        yn = op.attrs.get("y_num_col_dims", 1)
        xs, ys = ins.get(("X", 0)), ins.get(("Y", 0))
        xshape = self.shape(op.input("X")[0])
        yshape = self.shape(op.input("Y")[0])
        if yn != 1 or len(yshape) != 2:
            return None
        out_rank = xn + 1
        contr = len(xshape) - 1
        if _is_shard(ys) and ys[0] == 1:
            if _is_shard(xs):
                return None
            return {}, {("Out", 0): (out_rank - 1, ys[1])}
        if _is_shard(ys) and ys[0] == 0:
            if xn != contr:
                return None
            return {("X", 0): (contr, ys[1])}, {("Out", 0): _P}
        if _is_shard(xs):
            if xs[0] == contr and xn == contr:
                return {("Y", 0): (0, xs[1])}, {("Out", 0): _P}
            if xs[0] < xn:
                return {}, {("Out", 0): xs}
        return None

    def rule_reshape2(self, op, ins):
        s = ins.get(("X", 0))
        if not _is_shard(s):
            return None
        shape = list(op.attrs.get("shape", []))
        in_shape = self.shape(op.input("X")[0])
        tgt = reshape_shard(in_shape, shape, s[0], s[1], self.tp)
        if tgt is None:
            return None
        t, g = tgt
        if t < len(shape) and shape[t] > 0:
            shape[t] //= self.tp
            # the grad op, replaying this reshape, takes the same attr
            op.attrs["shape"] = op.tp_attrs = shape
        return {}, self._one_out(op, (t, g))

    rule_reshape = rule_reshape2

    def rule_transpose2(self, op, ins):
        s = ins.get(("X", 0))
        perm = list(op.attrs.get("axis", []))
        return {}, self._one_out(op, (perm.index(s[0]), s[1]))

    rule_transpose = rule_transpose2

    def rule_slice(self, op, ins):
        s = ins.get(("Input", 0))
        axes = list(op.attrs.get("axes", []))
        rank = len(self.shape(op.input("Input")[0]))
        axes = [a % rank for a in axes]
        if not _is_shard(s) or s[0] in axes:
            return None
        d = s[0] - sum(1 for a in op.attrs.get("decrease_axis", []) or []
                       if a % rank < s[0])
        return {}, self._one_out(op, (d, s[1]))

    def rule_squeeze2(self, op, ins):
        s = ins.get(("X", 0))
        shape = self.shape(op.input("X")[0])
        axes = [a % len(shape) for a in op.attrs.get("axes", []) or []] or \
            [i for i, d in enumerate(shape) if d == 1]
        if s[0] in axes:
            return None
        return {}, self._one_out(op, (s[0] - sum(a < s[0] for a in axes),
                                      s[1]))

    def rule_unsqueeze2(self, op, ins):
        s = ins.get(("X", 0))
        d = s[0]
        for a in sorted(op.attrs.get("axes", [])):
            if a <= d:
                d += 1
        return {}, self._one_out(op, (d, s[1]))

    def rule_matmul(self, op, ins):
        xs, ys = ins.get(("X", 0)), ins.get(("Y", 0))
        rx = len(self.shape(op.input("X")[0]))
        ry = len(self.shape(op.input("Y")[0]))
        if rx == ry and rx >= 3 and xs == ys and _is_shard(xs) and \
                xs[0] < rx - 2:
            return {}, {("Out", 0): xs}
        if _is_shard(xs) and not _is_shard(ys) and ry == 2 and \
                xs[0] < rx - 2:
            return {}, {("Out", 0): xs}
        return None

    rule_matmul_v2 = rule_matmul

    def rule_softmax(self, op, ins):
        s = ins.get(("X", 0))
        rank = len(self.shape(op.input("X")[0]))
        if s[0] == op.attrs.get("axis", -1) % rank:
            return None
        return {}, {("Out", 0): s}

    def rule_heads(self, op, ins):
        slots, outs = HEAD_OPS[op.type]
        g = None
        for (slot, i), s in ins.items():
            if slot in slots and _is_shard(s) and s[0] == slots[slot]:
                g = s[1]
                break
        if g is None:
            return None
        want = {}
        for (slot, i), s in ins.items():
            if slot in slots:
                want[(slot, i)] = (slots[slot], g)
            elif slot == "Bias" and (_is_shard(s) or self.shape(
                    op.inputs[slot][i])[1] != 1):
                want[(slot, i)] = (1, g)
            elif _is_shard(s):
                want[(slot, i)] = None
        return want, {(s, 0): (d, g) for s, d in outs.items()
                      if op.outputs.get(s)}

    def rule_softmax_with_cross_entropy(self, op, ins):
        from ..ops.nn_ops import _xent_vocab_eligible

        s = ins.get(("Logits", 0))
        rank = len(self.shape(op.input("Logits")[0]))
        if not (_is_shard(s) and s[0] == rank - 1 and s[1] == 1
                and _xent_vocab_eligible(op.attrs)):
            return None
        want = {k: None for k, v in ins.items()
                if k[0] != "Logits" and _is_shard(v)}
        return want, {("Softmax", 0): s, ("Loss", 0): None}, \
            {"tp_vocab": self.ring}

    def rule_reduce(self, op, ins):
        s = ins.get(("X", 0))
        rank = len(self.shape(op.input("X")[0]))
        if op.type in ("mean", "squared_l2_norm") or \
                op.attrs.get("reduce_all", False):
            dims = list(range(rank))
        else:
            dims = op.attrs.get("dim", [0])
            dims = [d % rank for d in (dims if isinstance(dims, (list, tuple))
                                       else [dims])]
        out = op.output("Out")[0]
        if s[0] not in dims:
            keep = op.attrs.get("keep_dim", False)
            d = s[0] if keep else s[0] - sum(x < s[0] for x in dims)
            return {}, {("Out", 0): (d, s[1])}
        if op.type in ("reduce_sum", "squared_l2_norm"):
            return {}, {("Out", 0): _P}
        red = {"reduce_max": "max", "reduce_min": "min"}.get(op.type, "sum")
        mean = op.type in ("mean", "reduce_mean")
        if mean:
            self.scaled_means.add(out)

        def post():
            self.allreduce(out, red, avg=mean)
        op._tp_post = post
        return {}, {("Out", 0): None}

    def rule_check_finite_and_unscale(self, op, ins):
        """Each output follows its input; the flag is OR-reduced over tp
        inside the op, before it zeroes the outputs (`tp_found`)."""
        outs = {("Out", i): ins.get(("X", i))
                for i, _ in enumerate(op.outputs.get("Out", []))}
        return {}, outs, {"tp_found": self.ring}

    def rule_optimizer(self, op, ins):
        pname = op.input("Param")[0]
        ps = self.st.get(pname)
        want = {}
        if not _is_shard(ps):
            return ({k: None for k, s in ins.items() if _is_shard(s)}, {})
        marks = None
        if op.type in _WHOLE_PARAM:
            # the norms of the parameter and of its update are squared sums
            # over the whole parameter: summed over tp before the root
            marks = {"tp_norms": self.ring}
        pshape = self.shape(pname)
        sharded = set()
        for (slot, i), s in ins.items():
            n = op.inputs[slot][i]
            if slot == "Grad":
                want[(slot, i)] = ps
            elif slot != "LearningRate" and self.shape(n) == pshape:
                if not _is_shard(s):
                    v = self.block.vars[n]
                    if not v.persistable:
                        want[(slot, i)] = ps
                    else:
                        self.st[n] = ps
                        self.layouts[n] = TPLayout(ps[0], ps[1], v.shape,
                                                   self.group)
                sharded.add(n)
            elif _is_shard(s):
                want[(slot, i)] = None
        outs = {(slot, i): ps for slot, ns in op.outputs.items()
                for i, n in enumerate(ns) if n in sharded}
        return want, outs, marks

    # -- grad ops ----------------------------------------------------------
    def grad_op(self, op, fwd):
        in_states, read, renames, orig = self.info[id(fwd)]
        for (slot, i), new in renames.items():
            names = op.inputs.get(slot)
            if names and i < len(names) and names[i] == orig[(slot, i)]:
                names[i] = new
        partial = [n for n in op.input_names if n and self.st.get(n) == _P]
        keep = bool(partial) and self._keeps_partial(op, partial)
        if keep:
            self.summed_later.update(partial)
        else:
            for n in dict.fromkeys(partial):
                self.allreduce(n)
        if op.type in ("mean_grad", "reduce_mean_grad"):
            g = op.input("Out@GRAD")[0]
            if g.split("@GRAD")[0] in self.scaled_means and \
                    _is_shard(read.get(("X", 0))):
                scaled = self.new_var(g, "SCALED")
                from ..framework import Operator

                self.ops.append(Operator(self.block, "scale", {"X": [g]},
                                         {"Out": [scaled]},
                                         {"scale": 1.0 / self.tp,
                                          "bias": 0.0,
                                          "bias_after_scale": True}))
                op.inputs["Out@GRAD"] = [scaled]
        vocab = getattr(fwd, "tp_vocab", None)
        if vocab is not None:
            op.tp_vocab = vocab
        if getattr(fwd, "tp_attrs", None) is not None:
            op.attrs["shape"] = list(fwd.tp_attrs)
        any_shard = any(_is_shard(self.st.get(n)) or self.st.get(n) == _P
                        for n in op.input_names if n)
        posts = []
        for slot, names in op.outputs.items():
            if not slot.endswith("@GRAD"):
                continue
            fslot = slot[:-len("@GRAD")]
            for i, gname in enumerate(names):
                if not gname:
                    continue
                cs = read.get((fslot, i))
                orig_s = in_states.get((fslot, i))
                if orig_s == _P:
                    # the cotangent of a partial is its sum's: replicated
                    orig_s = None
                if keep:
                    gs = _P
                elif _is_shard(cs):
                    gs = cs
                elif any_shard:
                    gs = _P
                else:
                    gs = None
                if gs == orig_s or (gs == _P and orig_s is None):
                    self.st[gname] = gs
                    continue
                tmp = self.new_var(gname, "G")
                names[i] = tmp
                self.st[tmp] = gs
                posts.append((tmp, orig_s, gname))
        self.ops.append(op)
        for n in op.output_names:
            if n:
                self.producer.setdefault(n, op)
        for tmp, want, gname in posts:
            self.coerce(tmp, want, into=gname)
            self.st[gname] = want


def tensor_parallel_rewrite(program, group, ring_id: int):
    """A clone of `program` split Megatron-style over the tp ranks of
    `group` (module docstring). Returns (clone, layouts {persistable var:
    TPLayout}, states {var: (dim, groups) or "partial"} of the values left
    sharded or partial, which a fetch gathers or sums)."""
    rw = _Rewrite(program, group.size, ring_id, group)
    clone = rw.run()
    states = {n: s for n, s in rw.st.items() if s is not None}
    return clone, rw.layouts, states
