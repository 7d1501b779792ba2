"""Quantization-aware training and its freeze (the JAX package's
contrib/slim/quantization/quantization_pass.py, after the reference's
QuantizationTransformPass, QuantizationFreezePass and ConvertToInt8Pass).

The transform walks the program and, in front of each quantizable op
(conv2d, depthwise_conv2d, mul, matmul), inserts a fused
quantize-dequantize on its weight (abs_max) and its activation input
(moving-average abs_max); the inserted ops carry straight-through
gradients, so minimize() after the pass trains quantization-aware. The
freeze pass writes the quantized weights into the scope and drops the fake
ops; ConvertToInt8Pass stores the frozen weights as int8. The passes
rewrite the Program IR as the JAX package's do, op for op. The scope's
values are tensors on their device, quantized there with true divisions,
the JAX package's numpy arithmetic.
"""
from __future__ import annotations

import torch

from ....framework import default_main_program

_QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul")


class QuantizationTransformPass:
    """Weight abs_max + activation moving_average_abs_max, the default W8A8
    configuration (`scope` and `place` are accepted for the reference's
    signature; the transform touches no values)."""

    def __init__(self, scope=None, place=None, weight_bits=8,
                 activation_bits=8, moving_rate=0.9,
                 quantizable_op_type=_QUANTIZABLE,
                 skip_pattern="skip_quant"):
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits
        self._moving_rate = moving_rate
        self._types = tuple(quantizable_op_type)
        self._skip = skip_pattern

    def apply(self, program=None, startup_program=None, for_test=False):
        """Insert q/dq ops in front of every quantizable op (mutates and
        returns `program`). Run it before minimize(), so the backward pass
        differentiates through the straight-through estimators."""
        program = program or default_main_program()
        block = program.global_block
        params = {p.name for p in program.all_parameters()}
        quantized: dict[str, str] = {}  # original name -> q/dq output name

        for op in list(block.ops):
            if op.type not in self._types or op.attrs.get(self._skip):
                continue
            for slot, names in op.inputs.items():
                for i, n in enumerate(names):
                    if n in quantized:
                        names[i] = quantized[n]
                        continue
                    try:
                        var = block.var(n)
                    except KeyError:
                        continue
                    if var.dtype.value not in ("float32", "bfloat16",
                                               "float16"):
                        continue
                    idx = block.ops.index(op)
                    q = self._insert_qdq(block, idx, var,
                                         is_weight=n in params,
                                         for_test=for_test,
                                         startup_program=startup_program)
                    quantized[n] = q
                    names[i] = q
        return program

    def _insert_qdq(self, block, idx, var, is_weight, for_test,
                    startup_program=None):
        from .... import unique_name
        from ....framework import default_startup_program

        out = block.create_var(
            name=unique_name.generate(var.name + ".quantized"),
            shape=var.shape, dtype=var.dtype)
        if is_weight:
            scale = block.create_var(
                name=unique_name.generate(var.name + ".scale"),
                shape=(1,), dtype="float32")
            block._insert_op(
                idx, "fake_quantize_dequantize_abs_max", {"X": [var.name]},
                {"Out": [out.name], "OutScale": [scale.name]},
                {"bit_length": self._weight_bits})
            return out.name
        # the moving-average activation scale: persistable running state,
        # zeroed by the startup program (filling it in the main program
        # would reset the average every step); bound to the programs
        # passed, not to the defaults
        state = block.create_var(
            name=unique_name.generate(var.name + ".ma_scale"),
            shape=(1,), dtype="float32", persistable=True)
        sblk = (startup_program or default_startup_program()).global_block
        sblk.create_var(name=state.name, shape=(1,), dtype="float32",
                        persistable=True)
        sblk.append_op("fill_constant", {}, {"Out": [state.name]},
                       {"shape": [1], "dtype": "float32", "value": 0.0})
        block._insert_op(
            idx, "fake_quantize_dequantize_moving_average_abs_max",
            {"X": [var.name], "InScale": [state.name]},
            {"Out": [out.name], "OutScale": [state.name]},
            {"bit_length": self._activation_bits,
             "moving_rate": self._moving_rate, "is_test": for_test})
        return out.name


_FAKE_WEIGHT_OPS = ("fake_quantize_dequantize_abs_max",)
_FAKE_ACT_OPS = ("fake_quantize_dequantize_moving_average_abs_max",)
_FAKE_STATIC = "fake_quantize_dequantize_static"


def _levels(w, scale, n):
    """round(w / scale * n) clipped to [-n, n], scale a float."""
    s = torch.tensor(scale, dtype=torch.float32, device=w.device)
    return torch.round(w / s * n).clamp(-n, n), s


def _need_scope(scope, what):
    if scope is None:
        raise ValueError(f"{what} needs the scope the program trained in (the "
                         f"port has no global scope)")
    return scope


class QuantizationFreezePass:
    """A QAT-trained (or PTQ-calibrated) program made an inference program:

      * each weight fake q/dq op is removed and the scope's weight
        overwritten with its quantize-dequantized value; its abs-max scale
        goes to a persistable `<w>@quant_scale` var for the int8 step;
      * each activation fake op is removed (its consumers read the raw
        input) and the learned or calibrated scale is recorded on each
        consumer op as an `in_scales` attr.

    Apply it after training, before save_inference_model."""

    def __init__(self, scope, place=None, weight_bits=8, activation_bits=8):
        self._scope = _need_scope(scope, "QuantizationFreezePass")
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits

    def apply(self, program=None):
        program = program or default_main_program()
        block = program.global_block
        params = {p.name for p in program.all_parameters()}
        replace: dict[str, str] = {}       # fake-out name -> original input
        act_scales: dict[str, float] = {}  # rewired input name -> scale
        new_ops = []
        n = float(2 ** (self._weight_bits - 1) - 1)
        for op in block.ops:
            if op.type in _FAKE_WEIGHT_OPS or (
                    op.type == _FAKE_STATIC and op.inputs["X"][0] in params):
                w_name = op.inputs["X"][0]
                w = self._scope.find_var(w_name)
                scale = (float(w.abs().max()) if op.type != _FAKE_STATIC
                         else float(op.attrs["scale"]))
                scale = max(scale, 1e-8)
                q, s = _levels(w, scale, n)
                self._scope.set_var(w_name, (q * s / torch.tensor(
                    n, device=w.device)).to(w.dtype))
                sname = w_name + "@quant_scale"
                block.create_var(name=sname, shape=(1,), dtype="float32",
                                 persistable=True)
                self._scope.set_var(sname, s.reshape(1))
                replace[op.outputs["Out"][0]] = w_name
                continue
            if op.type in _FAKE_ACT_OPS or op.type == _FAKE_STATIC:
                x_name = op.inputs["X"][0]
                if op.type == _FAKE_STATIC:
                    scale = float(op.attrs["scale"])
                else:
                    sv = self._scope.find_var(op.inputs["InScale"][0])
                    if sv is None:
                        raise RuntimeError(
                            f"QuantizationFreezePass: moving-average scale "
                            f"'{op.inputs['InScale'][0]}' not in the scope: "
                            f"pass the scope QAT trained in (a silent 0.0 "
                            f"scale would poison the in_scales metadata)")
                    scale = float(sv.reshape(-1)[0])
                replace[op.outputs["Out"][0]] = x_name
                act_scales[x_name] = scale
                continue
            new_ops.append(op)
        for op in new_ops:
            scales = {}
            for names in op.inputs.values():
                for i, nme in enumerate(names):
                    if nme in replace:
                        names[i] = replace[nme]
                    if names[i] in act_scales:
                        scales[names[i]] = act_scales[names[i]]
            if scales:
                op.attrs = {**op.attrs, "in_scales": scales}
        block.ops = new_ops
        return program


class ConvertToInt8Pass:
    """Frozen weights stored as int8: each weight that the freeze pass
    quantized flips to int8 in the program and the scope, and a
    `dequantize_abs_max` op in front of its consumers restores float32, so
    a saved model carries 1-byte weights."""

    def __init__(self, scope, place=None, weight_bits=8):
        self._scope = _need_scope(scope, "ConvertToInt8Pass")
        self._weight_bits = weight_bits

    def apply(self, program=None):
        from .... import unique_name
        from ....core.types import DType

        program = program or default_main_program()
        block = program.global_block
        n = float(2 ** (self._weight_bits - 1) - 1)
        converted: dict[str, str] = {}  # weight -> dequantized var name
        for w_name in [v for v in list(block.vars)
                       if block.has_var(v + "@quant_scale")]:
            w = self._scope.find_var(w_name)
            scale = float(self._scope.find_var(w_name + "@quant_scale")
                          .reshape(-1)[0])
            q, _ = _levels(w, max(scale, 1e-8), n)
            self._scope.set_var(w_name, q.to(torch.int8))
            block.var(w_name).dtype = DType.INT8
            deq = block.create_var(name=unique_name.generate(w_name + ".deq"),
                                   shape=tuple(w.shape), dtype="float32")
            converted[w_name] = deq.name
        if not converted:
            return program
        # one dequantize a weight at the top; consumers rewired to it
        for i, (w_name, deq_name) in enumerate(sorted(converted.items())):
            block._insert_op(
                i, "dequantize_abs_max",
                {"X": [w_name], "Scale": [w_name + "@quant_scale"]},
                {"Out": [deq_name]}, {"bit_length": self._weight_bits})
        for op in block.ops:
            if op.type == "dequantize_abs_max":
                continue
            for names in op.inputs.values():
                for j, nme in enumerate(names):
                    if nme in converted:
                        names[j] = converted[nme]
        return program
