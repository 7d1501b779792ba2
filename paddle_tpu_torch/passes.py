"""Whole-program graph rewrites run at minimize() time, before
`append_backward` (the port's copy of the JAX package's passes.py, without
the tuning-database consults and without the tiered-embedding rewrite,
which are not ported).

  * fuse_conv_bn_stats: conv2d -> batch_norm(training) pairs become one
    conv2d_bn op, whose statistics are taken from the conv's output where
    it is produced (ops/nn_ops.py).
  * fuse_epilogue_act: norm -> relu and norm -> residual-add -> relu chains
    collapse into the norm op (attr `act`, input `Residual`), so the whole
    apply chain is one visit of the batch-norm apply kernels (K8 forward,
    K9 backward) instead of the kernel plus separate add and relu ops.

Both rewrite the program exactly as the JAX package's passes do, so the two
packages' training programs stay equal through `to_dict()`: FLAGS
bn_fuse_stats is the JAX flag of the same name, and fuse_epilogue=True
builds the structure the JAX package builds under FLAGS_pallas_epilogue=on.
The flags choose the program's structure only. Fused or not, a CUDA
tensor's batch-norm apply runs the hand-written kernels.
"""
from __future__ import annotations

from . import flags

__all__ = ["fuse_conv_bn_stats", "fuse_epilogue_act", "apply_minimize_passes"]


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
            if bn_idx is None:
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


def apply_minimize_passes(program) -> None:
    """The flag-gated pass pipeline, run once per program from
    `Optimizer.backward`."""
    if flags.get_flag("bn_fuse_stats") and not getattr(
            program, "_bn_stats_fused", False):
        program._bn_stats_fused = True  # idempotent across re-entry
        fuse_conv_bn_stats(program)
    if flags.get_flag("fuse_epilogue") and not getattr(
            program, "_epilogue_fused", False):
        program._epilogue_fused = True  # idempotent across re-entry
        fuse_epilogue_act(program)
