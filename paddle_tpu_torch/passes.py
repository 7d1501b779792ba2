"""Whole-program graph rewrites run at minimize() time, before
`append_backward` (the port's copy of the JAX package's passes.py, with
its tuning-database consults: conv+BN fusion per pair and the tiered
embeddings' slot count, under FLAGS_tuning_mode).

  * rewrite_tiered_embeddings: every lookup over a table above
    FLAGS_emb_hbm_budget_mb becomes emb_cache_install + tiered_lookup over
    a device cache of hot rows, the table itself moving to host memory
    (embedding/).
  * fuse_conv_bn_stats: conv2d -> batch_norm(training) pairs become one
    conv2d_bn op, whose statistics are taken from the conv's output where
    it is produced (ops/nn_ops.py).
  * fuse_epilogue_act: norm -> relu and norm -> residual-add -> relu chains
    collapse into the norm op (attr `act`, input `Residual`), so the whole
    apply chain is one visit of the batch-norm apply kernels (K8 forward,
    K9 backward) instead of the kernel plus separate add and relu ops.

All three rewrite the program exactly as the JAX package's passes do, so the two
packages' training programs stay equal through `to_dict()`: FLAGS
bn_fuse_stats is the JAX flag of the same name, and fuse_epilogue=True
builds the structure the JAX package builds under FLAGS_pallas_epilogue=on.
The flags choose the program's structure only. Fused or not, a CUDA
tensor's batch-norm apply runs the hand-written kernels.
"""
from __future__ import annotations

import warnings
import zlib

from . import flags

__all__ = ["fuse_conv_bn_stats", "fuse_epilogue_act",
           "rewrite_tiered_embeddings", "apply_minimize_passes"]


def _writes(op, name: str) -> bool:
    return any(name in ns for ns in op.outputs.values())


def _reads(op, name: str) -> bool:
    return any(name in ns for ns in op.inputs.values())


def _match_bn_consumer(block, conv_idx: int, out_name: str):
    """Index of the single batch_norm(training) consuming `out_name`, or None.

    Requirements for a semantics-preserving merge:
      * out_name has exactly one reader in the block and none elsewhere in
        the program (it disappears from the graph);
      * that reader is a training-mode batch_norm whose layout matches the
        conv's data_format;
      * no op between producer and consumer redefines the conv's inputs or
        touches out_name (the conv's computation is moved to the BN's
        position).
    """
    conv = block.ops[conv_idx]
    readers = []
    for b in block.program.blocks:
        for i, op in enumerate(b.ops):
            if op is not conv and _reads(op, out_name):
                readers.append((b, i, op))
            if op is not conv and _writes(op, out_name):
                return None
    if len(readers) != 1:
        return None
    b, bn_idx, bn = readers[0]
    if b is not block or bn_idx <= conv_idx or bn.type != "batch_norm":
        return None
    if bn.input("X") != [out_name]:
        return None
    if bn.attr("is_test", False):
        return None  # inference BN has no statistics pass to fuse
    if bn.attr("data_layout", "NCHW") != conv.attr("data_format", "NCHW"):
        return None
    moved = set(conv.input("Input") + conv.input("Filter"))
    for mid in block.ops[conv_idx + 1:bn_idx]:
        if any(_writes(mid, n) for n in moved):
            return None
    return bn_idx


def _fusion_wanted(block, conv, out_name: str) -> bool:
    """Per-pair tuner consult (FLAGS_tuning_mode != off): a swept-DB entry
    can retire the fusion for one conv shape while every other shape keeps
    it. The analytic prior is the flag default, fuse, so with no DB entry
    the program is unchanged. FLAGS_bn_fuse_stats stays the master switch:
    the tuner refines per shape, it does not resurrect a retired lever.
    The key is the JAX package's (passes.py:85), the declared shapes with
    their batch -1, so one DB serves both packages."""
    from . import tuning

    if tuning.mode() == "off":
        return True
    in_shape = list(block.var(conv.input("Input")[0]).shape or [])
    w_shape = list(block.var(conv.input("Filter")[0]).shape or [])
    fmt = conv.attr("data_format", "NCHW")
    if len(in_shape) == 4 and len(w_shape) == 4:
        if fmt == "NCHW":
            n, cin = in_shape[0], in_shape[1]
            cout, kh, kw = w_shape[0], w_shape[2], w_shape[3]
        else:
            n, cin = in_shape[0], in_shape[3]
            kh, kw, cout = w_shape[0], w_shape[1], w_shape[3]
    else:  # malformed declaration: leave the decision to the default
        n = cin = cout = kh = kw = -1
    strides = conv.attr("strides", [1, 1])
    dil = conv.attr("dilations", [1, 1])
    out_var = block.var(out_name)
    out_shape = list(out_var.shape or [])
    hout, wout = (out_shape[2], out_shape[3]) if fmt == "NCHW" and \
        len(out_shape) == 4 else (out_shape[1], out_shape[2]) if \
        len(out_shape) == 4 else (-1, -1)
    key = tuning.canonical_key(
        "conv2d_bn_fusion",
        tuning.conv_key(n, hout, wout, cin, cout, kh, kw, strides, dil, fmt),
        str(out_var.dtype.value), tuning.device_kind())
    decision, _tier = tuning.decide(
        "conv2d_bn_fusion", key,
        prior=lambda: {"fuse": True},
        default={"fuse": True},
        validate=lambda dd: isinstance(dd.get("fuse"), bool))
    return bool(decision.get("fuse", True))


def fuse_conv_bn_stats(program) -> int:
    """Rewrite every eligible conv2d -> batch_norm(training) pair into one
    conv2d_bn op (ops/nn_ops.py). Returns the number of pairs fused. The
    orphaned conv-output var stays declared in the block (harmless; it no
    longer has a producer, like any pruned intermediate)."""
    n_fused = 0
    for block in program.blocks:
        i = 0
        while i < len(block.ops):
            conv = block.ops[i]
            if conv.type != "conv2d":
                i += 1
                continue
            out_name = conv.output("Output")[0]
            bn_idx = _match_bn_consumer(block, i, out_name)
            if bn_idx is None or not _fusion_wanted(block, conv, out_name):
                i += 1
                continue
            bn = block.ops[bn_idx]
            inputs = {
                "Input": conv.input("Input"),
                "Filter": conv.input("Filter"),
                "Scale": bn.input("Scale"),
                "Bias": bn.input("Bias"),
                "Mean": bn.input("Mean"),
                "Variance": bn.input("Variance"),
            }
            outputs = {
                "Y": bn.output("Y"),
                "MeanOut": bn.output("MeanOut"),
                "VarianceOut": bn.output("VarianceOut"),
                "SavedMean": bn.output("SavedMean"),
                "SavedVariance": bn.output("SavedVariance"),
            }
            attrs = {
                "strides": conv.attr("strides", [1, 1]),
                "paddings": conv.attr("paddings", [0, 0]),
                "dilations": conv.attr("dilations", [1, 1]),
                "groups": conv.attr("groups", 1),
                "data_format": conv.attr("data_format", "NCHW"),
                "epsilon": bn.attr("epsilon", 1e-5),
                "momentum": bn.attr("momentum", 0.9),
            }
            # replace the BN in place (every fused input's producer precedes
            # it), then drop the conv
            del block.ops[bn_idx]
            block._insert_op(bn_idx, "conv2d_bn", inputs, outputs, attrs)
            del block.ops[i]
            n_fused += 1
            # stay at i: the next op shifted into this slot
    return n_fused


# norm ops the epilogue rewrite folds a trailing activation into, and the
# activations the kernels behind them (K3/K5, K8/K9) carry
_EPILOGUE_NORM_OPS = ("batch_norm", "conv2d_bn", "layer_norm")
_EPILOGUE_ACT_OPS = ("relu",)


def _sole_reader(block, producer, out_name: str):
    """(block_idx, op) of the single op reading `out_name`, or None — and
    None as well if anything else WRITES it (the var must disappear
    cleanly when the chain collapses)."""
    readers = []
    for b in block.program.blocks:
        for i, op in enumerate(b.ops):
            if op is not producer and _reads(op, out_name):
                readers.append((b, i, op))
            if op is not producer and _writes(op, out_name):
                return None
    if len(readers) != 1 or readers[0][0] is not block:
        return None
    return readers[0][1], readers[0][2]


def _inputs_stable(block, names, lo: int, hi: int) -> bool:
    """No op in block.ops(lo, hi] redefines any of `names` (the fused op is
    moved to position hi, so every input must still hold its value there)."""
    for mid in block.ops[lo + 1:hi + 1]:
        if any(_writes(mid, n) for n in names):
            return False
    return True


def fuse_epilogue_act(program) -> int:
    """Collapse norm -> [same-shape residual add ->] relu chains into the
    norm op. Returns the number of chains fused.

    Two patterns, both requiring every intermediate var to have exactly one
    reader (it vanishes from the graph):
      * norm -> relu:          norm gains attr act, adopts relu's output.
      * norm -> add -> relu:   norm additionally gains input Residual (the
        add's other operand) and MOVES to the relu's position — the
        residual branch (e.g. a ResNet shortcut conv) is built after the
        main branch, so its value does not exist at the norm's old index.
    """
    n_fused = 0
    for block in program.blocks:
        i = 0
        while i < len(block.ops):
            norm = block.ops[i]
            if norm.type not in _EPILOGUE_NORM_OPS or norm.attr("act", ""):
                i += 1
                continue
            y_name = norm.output("Y")[0]
            hit = _sole_reader(block, norm, y_name)
            if hit is None:
                i += 1
                continue
            j, consumer = hit
            if j <= i:
                i += 1
                continue
            norm_inputs = [n for ns in norm.inputs.values() for n in ns]
            if consumer.type in _EPILOGUE_ACT_OPS:
                if not _inputs_stable(block, norm_inputs, i, j - 1):
                    i += 1
                    continue
                norm.attrs["act"] = consumer.type
                norm.outputs["Y"] = list(consumer.output("Out"))
                del block.ops[j]
                n_fused += 1
                continue  # re-examine i: the fused op could chain further
            if consumer.type != "elementwise_add" or norm.type == "layer_norm":
                # the residual-add fold exists for the BN apply kernels;
                # layer_norm's lowering carries no Residual slot
                i += 1
                continue
            # residual pattern: the add must be same-shape (axis -1/0) and
            # feed exactly one relu
            xs, ys = consumer.input("X"), consumer.input("Y")
            if len(xs) != 1 or len(ys) != 1:
                i += 1
                continue
            other = ys[0] if xs[0] == y_name else xs[0]
            if other == y_name:
                i += 1
                continue
            try:
                if (tuple(block.var(other).shape)
                        != tuple(block.var(y_name).shape)):
                    i += 1
                    continue
            except KeyError:
                i += 1
                continue
            if consumer.attr("axis", -1) not in (-1, 0):
                i += 1
                continue
            add_out = consumer.output("Out")[0]
            hit2 = _sole_reader(block, consumer, add_out)
            if hit2 is None:
                i += 1
                continue
            k, act_op = hit2
            if act_op.type not in _EPILOGUE_ACT_OPS or k <= j:
                i += 1
                continue
            if not _inputs_stable(block, norm_inputs, i, k) or \
                    not _inputs_stable(block, [other], j, k):
                i += 1
                continue
            norm.attrs["act"] = act_op.type
            norm.inputs["Residual"] = [other]
            norm.outputs["Y"] = list(act_op.output("Out"))
            # move the fused op to the relu's slot (the residual operand is
            # defined by then); drop relu, add, and the original position
            inputs = {s: list(ns) for s, ns in norm.inputs.items()}
            outputs = {s: list(ns) for s, ns in norm.outputs.items()}
            attrs = dict(norm.attrs)
            del block.ops[k]
            block._insert_op(k, norm.type, inputs, outputs, attrs)
            del block.ops[j]
            del block.ops[i]
            n_fused += 1
            # stay at i: the next op shifted into this slot
    return n_fused


# -- tiered giant embeddings ---------------------------------------------------

_LOOKUP_OPS = ("lookup_table", "lookup_table_v2")


def _host_init_spec(startup_program, wname: str):
    """The numpy rendering of `wname`'s startup init op — which this pass
    REMOVES (the host tier owns the giant table; materializing it on the
    device first would be exactly the HBM blow-up tiering exists to avoid).
    Returns (spec tuple, values-or-None) — values for assign_value inits."""
    import numpy as np

    if startup_program is None:
        warnings.warn(
            f"tiered embedding '{wname}': no startup program in scope — "
            f"host tier initializes to zeros", stacklevel=3)
        return ("constant", 0.0), None
    sblock = startup_program.global_block
    for idx, op in enumerate(sblock.ops):
        if wname not in op.output_names:
            continue
        spec, values = None, None
        if op.type == "uniform_random":
            spec = ("uniform", float(op.attr("min", -1.0)),
                    float(op.attr("max", 1.0)))
        elif op.type in ("gaussian_random", "truncated_gaussian_random"):
            spec = ("gaussian", float(op.attr("mean", 0.0)),
                    float(op.attr("std", 1.0)))
        elif op.type == "fill_constant":
            spec = ("constant", float(op.attr("value", 0.0)))
        elif op.type == "assign_value":
            spec = ("constant", 0.0)
            values = np.asarray(op.attr("values"), np.float32).reshape(
                op.attr("shape"))
        if spec is None:
            warnings.warn(
                f"tiered embedding '{wname}': unrecognized init op "
                f"'{op.type}' — host tier initializes to zeros",
                stacklevel=3)
            spec = ("constant", 0.0)
        del sblock.ops[idx]
        return spec, values
    return ("constant", 0.0), None


def _tiered_geometry(wname: str, vocab: int, dim: int, itemsize: int,
                     dtype_str: str, budget_mb: float):
    """(slots, prefetch_rows) for one table: FLAGS_emb_cache_slots is a hard
    force; otherwise the budget-derived count is the analytic prior and a
    swept 'embedding|table=..' DB verdict refines it (the JAX package's
    passes.py:360)."""
    from . import tuning

    row_bytes = max(1, dim * itemsize)
    analytic = max(1, min(int(budget_mb * 2**20 // row_bytes), vocab))
    prefetch = int(flags.get_flag("emb_prefetch_rows"))
    forced = int(flags.get_flag("emb_cache_slots"))
    if forced > 0:
        return forced, prefetch
    if tuning.mode() == "off":
        return analytic, prefetch
    key = tuning.canonical_key(
        "embedding", tuning.embedding_key(wname, vocab, dim), dtype_str,
        tuning.device_kind())
    decision, _tier = tuning.decide(
        "embedding", key,
        prior=lambda: {"slots": analytic, "prefetch_rows": prefetch},
        default={"slots": analytic, "prefetch_rows": prefetch},
        validate=lambda d: isinstance(d.get("slots"), int)
        and d["slots"] > 0)
    return (int(decision.get("slots", analytic)),
            int(decision.get("prefetch_rows", prefetch) or prefetch))


def rewrite_tiered_embeddings(program, startup_program=None) -> int:
    """Rewrite every lookup_table over a table above FLAGS_emb_hbm_budget_mb
    onto the two-tier path. Per oversized table, the program gains:

      * a `[slots+1, dim]` trainable cache Parameter `<W>@CACHE` (row
        `slots` is the masked scratch row), zero-filled by the startup
        program — whose original `<W>` init op is REMOVED and its
        distribution re-drawn into the host tier (numpy, deterministic);
      * one `emb_cache_install` op landing the per-batch prefetch feeds
        (`<W>@PREFETCH_ROWS` / `<W>@PREFETCH_SLOTS`) in the cache and
        emitting the evicted rows (`<W>@EVICTED`, persistable so the engine
        can write them back to the host tier);
      * each lookup rewritten to `tiered_lookup` over a per-ids-feed slot
        feed (`<W>@SLOTS@<ids>`), resolved off the step by the engine.

    Tables at or under the budget are untouched — with no oversized table
    the program is bitwise-identical to the no-tiering build (the opt-in
    contract). The programs equal the JAX package's by `to_dict()`.
    Returns the number of lookups rewritten."""
    budget_mb = float(flags.get_flag("emb_hbm_budget_mb"))
    if budget_mb <= 0:
        return 0
    import numpy as np

    from .core.types import np_dtype
    from .embedding import HostShardedTable, TieredEmbeddingEngine

    if startup_program is None:
        from .framework import default_startup_program

        startup_program = default_startup_program()
    block = program.global_block
    engine = getattr(program, "_tiered_engine", None)
    n = 0
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type not in _LOOKUP_OPS or op.attr("is_distributed", False):
            i += 1
            continue
        wname = op.input("W")[0]
        try:
            w = block.var(wname)
        except KeyError:
            i += 1
            continue
        shape = list(w.shape or [])
        if len(shape) != 2 or any(d is None or d <= 0 for d in shape):
            i += 1
            continue
        vocab, dim = int(shape[0]), int(shape[1])
        itemsize = np.dtype(np_dtype(w.dtype)).itemsize
        if vocab * dim * itemsize <= budget_mb * 2**20:
            i += 1
            continue
        ids_name = op.input("Ids")[0]
        try:
            ids_var = block.var(ids_name)
        except KeyError:
            ids_var = None
        if ids_var is None or not getattr(ids_var, "is_data", False):
            warnings.warn(
                f"tiered embedding: table '{wname}' exceeds the HBM budget "
                f"but its ids ('{ids_name}') are computed in-graph, not "
                f"fed — the host-side resolver cannot see them; leaving "
                f"this lookup dense", stacklevel=3)
            i += 1
            continue

        if engine is None:
            engine = TieredEmbeddingEngine(program)
            program._tiered_engine = engine
        first = wname not in engine.tables
        if first:
            slots, prefetch = _tiered_geometry(
                wname, vocab, dim, itemsize, str(w.dtype.value), budget_mb)
            slots = max(1, min(int(slots), vocab))
            cache_name = wname + "@CACHE"
            rows_name = wname + "@PREFETCH_ROWS"
            slots_name = wname + "@PREFETCH_SLOTS"
            evict_name = wname + "@EVICTED"
            block.create_parameter(
                shape=[slots + 1, dim], dtype=w.dtype, name=cache_name,
                trainable=True)
            block.create_var(name=rows_name, shape=[-1, dim],
                             dtype=w.dtype, stop_gradient=True)
            block.create_var(name=slots_name, shape=[-1], dtype="int32",
                             stop_gradient=True)
            block.create_var(name=evict_name, shape=[-1, dim],
                             dtype=w.dtype, persistable=True,
                             stop_gradient=True)
            if startup_program is not None:
                sblock = startup_program.global_block
                sblock.create_var(name=cache_name, shape=[slots + 1, dim],
                                  dtype=w.dtype, persistable=True)
                sblock.append_op(
                    "fill_constant", outputs={"Out": [cache_name]},
                    attrs={"shape": [slots + 1, dim],
                           "dtype": w.dtype.value, "value": 0.0})
            init_spec, init_values = _host_init_spec(startup_program, wname)
            host = HostShardedTable(
                wname, vocab, dim, dtype=np_dtype(w.dtype),
                num_shards=int(flags.get_flag("emb_host_shards")),
                init=init_spec,
                seed=(program.random_seed or 0)
                ^ zlib.crc32(wname.encode()))
            if init_values is not None:
                host.load_rows(np.arange(vocab), init_values)
                host.clear_dirty()
            engine.add_table(wname, host, slots, cache_name, rows_name,
                             slots_name, evict_name, prefetch)
            if getattr(w, "trainable", None):
                w.trainable = False  # the cache is the trained Parameter
        ts = engine.tables[wname]
        slot_feed = f"{wname}@SLOTS@{ids_name}"
        block.create_var(name=slot_feed, shape=list(ids_var.shape),
                         dtype="int32", stop_gradient=True)
        engine.add_lookup(wname, ids_name, slot_feed,
                          op.attr("padding_idx", -1))
        out_names = list(op.output("Out"))
        del block.ops[i]
        block._insert_op(
            i, "tiered_lookup",
            {"Cache": [ts.cache_var], "SlotIds": [slot_feed]},
            {"Out": out_names},
            {"scratch_slot": ts.scratch, "table": wname})
        if first:
            # the install lands BEFORE the table's first gather; feeds and
            # the cache param are defined from step entry, so position i is
            # always safe
            block._insert_op(
                i, "emb_cache_install",
                {"Cache": [ts.cache_var], "Rows": [ts.rows_var],
                 "Slots": [ts.slots_var]},
                {"Out": [ts.cache_var], "Evicted": [ts.evict_var]},
                {"table": wname})
            i += 1
        n += 1
        i += 1
    return n


def apply_minimize_passes(program) -> None:
    """The flag-gated pass pipeline, run once per program from
    `Optimizer.backward`."""
    if float(flags.get_flag("emb_hbm_budget_mb")) > 0 and not getattr(
            program, "_emb_tiered", False):
        program._emb_tiered = True  # idempotent across re-entry
        rewrite_tiered_embeddings(program)
    if flags.get_flag("bn_fuse_stats") and not getattr(
            program, "_bn_stats_fused", False):
        program._bn_stats_fused = True  # idempotent across re-entry
        fuse_conv_bn_stats(program)
    if flags.get_flag("fuse_epilogue") and not getattr(
            program, "_epilogue_fused", False):
        program._epilogue_fused = True  # idempotent across re-entry
        fuse_epilogue_act(program)
