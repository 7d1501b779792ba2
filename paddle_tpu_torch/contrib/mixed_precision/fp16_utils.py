"""Program rewriting for mixed precision: casts around white and black ops
(the JAX package's contrib/mixed_precision/fp16_utils.py, whole).

White ops get their float32 inputs cast to the low dtype (one cast var per
(name, dtype), reused); black ops get low-precision inputs cast back to
float32; a gray op that reads both a low-precision and a float32 input is
harmonized down. Parameters stay float32 in the scope: the in-program cast
is the master-weight scheme, the optimizer updating fp32 parameters whose
low-precision view the forward reads. Output dtypes propagate through the
registry's meta-tensor inference (`infer_op`), which is where the rewrite
agrees with the JAX package's shape inference dtype for dtype.
"""
from __future__ import annotations

from ...core.types import DType
from ...framework import Program
from ...ops.registry import infer_op

__all__ = ["rewrite_program", "cast_var_suffix"]

_LOW = {"bfloat16": "@BF16", "float16": "@FP16"}

# Input slots that alias persistable running state (the op's stateful
# outputs write back to the same vars). Harmonize-down never casts these:
# a bf16 running average rounds away increments below about 0.4% of its
# value, and the fp32 statistics vars would change dtype in checkpoints.
_STATE_SLOTS = {
    "batch_norm": {"Mean", "Variance"},
    "conv2d_bn": {"Mean", "Variance"},
    "fake_quantize_dequantize_moving_average_abs_max": {"InScale"},
}


def cast_var_suffix(dest_dtype: str) -> str:
    return _LOW.get(dest_dtype, "@LOW")


def _cast_input(block, op_idx, name, dest_dtype, cache):
    """Insert (or reuse) `cast(name) -> name@SUFFIX` before op_idx; returns
    the cast var name and how many ops were inserted (0 or 1)."""
    try:
        src = block.var(name)
    except KeyError:
        return name, 0
    if dest_dtype == "float32":
        if src.dtype not in (DType.BF16, DType.FP16):
            return name, 0
    elif src.dtype != DType.FP32:
        return name, 0  # only fp32 tensors get a low-precision view
    key = (name, dest_dtype)
    if key in cache:
        return cache[key], 0
    suffix = "@FP32" if dest_dtype == "float32" else cast_var_suffix(dest_dtype)
    cast_name = name + suffix
    if not block.has_var(cast_name):
        block.create_var(name=cast_name, shape=src.shape, dtype=dest_dtype,
                         stop_gradient=src.stop_gradient)
    block._insert_op(
        op_idx, "cast", {"X": [name]}, {"Out": [cast_name]},
        {"in_dtype": src.dtype.value, "out_dtype": dest_dtype},
    )
    cache[key] = cast_name
    return cast_name, 1


def rewrite_program(main_program: Program, amp_lists, dest_dtype="bfloat16"):
    """Walk every block's (forward) op list, casting white-op inputs to
    `dest_dtype` and black-op inputs back to float32. Returns the number of
    casts inserted. Runs before append_backward, so the grad ops derive
    through the casts."""
    n_casts = 0
    for block in main_program.blocks:
        n_casts += _rewrite_block(block, amp_lists, dest_dtype)
        _hoist_casts_through_layout(block)
    return n_casts


# Dtype-transparent single-input ops that only move data. A down-cast below
# such an op is hoisted above it, so the data moves at low precision.
_LAYOUT_OPS = {"reshape2", "transpose2", "squeeze2", "unsqueeze2",
               "flatten2", "space_to_depth", "depth_to_space",
               "pixel_shuffle", "shuffle_channel"}


def _hoist_casts_through_layout(block):
    changed = True
    while changed:
        changed = False
        # producer index and consumer count per var name, current op order
        producer = {}
        consumers: dict = {}
        for idx, op in enumerate(block.ops):
            for n in op.input_names:
                consumers[n] = consumers.get(n, 0) + 1
            for n in op.output_names:
                producer[n] = idx
        for ci, op in enumerate(block.ops):
            if op.type != "cast":
                continue
            if op.attr("out_dtype") not in ("bfloat16", "float16"):
                continue
            (src,) = op.input("X")
            pi = producer.get(src)
            if pi is None:
                continue
            p = block.ops[pi]
            if p.type not in _LAYOUT_OPS or consumers.get(src, 0) != 1:
                continue
            (px,) = p.input("X")
            if not block.has_var(px) or block.var(px).dtype != DType.FP32:
                continue
            (dst,) = op.output("Out")
            # rewire: cast(px) above p; p consumes the cast and writes the
            # cast op's output var; the old cast goes. The hoisted cast var
            # is fresh: px@BF16 may already exist with a producer of its own
            # (a white op elsewhere also reads px), and a second producer
            # would make append_backward add both branches' cast grads into
            # px@GRAD.
            low = px + cast_var_suffix(op.attr("out_dtype")) + "@HOIST"
            n = 0
            while block.has_var(low + (f"{n}" if n else "")):
                n += 1
            low = low + (f"{n}" if n else "")
            src_var = block.var(px)
            block.create_var(name=low, shape=src_var.shape,
                             dtype=op.attr("out_dtype"),
                             stop_gradient=src_var.stop_gradient)
            del block.ops[ci]
            block._insert_op(pi, "cast", {"X": [px]}, {"Out": [low]},
                             {"in_dtype": "float32",
                              "out_dtype": op.attr("out_dtype")})
            p.inputs["X"] = [low]
            p.outputs["Out"] = [dst]
            infer_op(p, block)
            # the layout op's original fp32 output stays fetchable by name
            # through a repair upcast, which no op reads
            p_idx = block.ops.index(p)
            block._insert_op(p_idx + 1, "cast", {"X": [dst]},
                             {"Out": [src]},
                             {"in_dtype": op.attr("out_dtype"),
                              "out_dtype": "float32"})
            changed = True
            break


def _mixed_float_inputs(block, op) -> bool:
    """True when the op reads both a low-precision and an fp32 float
    input, where promotion would drag the activation back up to fp32."""
    seen = set()
    exempt = _STATE_SLOTS.get(op.type, ())
    for slot, names in op.inputs.items():
        if slot in exempt:
            continue
        for n in names:
            if not n or not block.has_var(n):
                continue
            dt = block.var(n).dtype
            if dt in (DType.FP32, DType.BF16, DType.FP16):
                seen.add(dt)
    return DType.FP32 in seen and (DType.BF16 in seen or DType.FP16 in seen)


def _rewrite_block(block, amp_lists, dest_dtype):
    cache: dict = {}
    i = 0
    n_casts = 0
    while i < len(block.ops):
        op = block.ops[i]
        target = None
        if op.type in amp_lists.white_list:
            target = dest_dtype
        elif op.type in amp_lists.black_list:
            target = "float32"
        elif op.type != "cast" and _mixed_float_inputs(block, op):
            # a gray or unlisted op mixing bf16 activations with fp32 side
            # inputs (a bias add, a residual add, a norm's gain and bias):
            # harmonize down, or the stream goes back to fp32 at twice
            # the bytes
            target = dest_dtype
        if target is None:
            # a gray op: no casts, but its output dtype is inferred again
            # so that bf16 propagates through the metadata (a black op
            # downstream must see the bf16 it has to cast back)
            infer_op(op, block)
            _invalidate(cache, op)
            i += 1
            continue
        inserted_here = 0
        exempt = _STATE_SLOTS.get(op.type, ())
        for slot, names in list(op.inputs.items()):
            if slot in exempt:
                continue
            new_names = []
            for name in names:
                if not name:
                    new_names.append(name)
                    continue
                new_name, inserted = _cast_input(block, i, name, target, cache)
                new_names.append(new_name)
                inserted_here += inserted
                i += inserted
            op.inputs[slot] = new_names
        # this op's output dtypes under its new input dtypes
        infer_op(op, block)
        _invalidate(cache, op)
        n_casts += inserted_here
        i += 1
    return n_casts


def _invalidate(cache: dict, op):
    """A redefined var's cached low-precision view is stale: drop it, so
    the next consumer casts the new value."""
    for out in op.output_names:
        if not out:
            continue
        for key in [k for k in cache if k[0] == out]:
            del cache[key]
