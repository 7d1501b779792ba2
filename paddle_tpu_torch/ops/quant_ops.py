"""Fake-quantization ops for quantization-aware training (the JAX
package's quant_ops.py): quantize-dequantize in one op, with a
straight-through gradient (the round's zero derivative is bypassed), and
the int8 weight dequantize that ConvertToInt8Pass inserts.

The arithmetic follows what XLA compiles the JAX ops to, so both packages
land on the same levels and values: round half to even (torch.round, as
jnp.round); a division by a compile-time constant becomes a multiply by
its float32 reciprocal, and a product of constants is folded in float32
(`_inv`, `_fold`); a division by a scale computed at run time stays a
division. The moving-average op writes its running scale to OutScale,
which QuantizationTransformPass names as the InScale state var itself.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import ExecContext, register_grad_compute, register_op


def _inv(v):
    """1/v in float32, as a Python float."""
    return float(np.float32(1.0) / np.float32(v))


def _fold(a, b):
    """a * b folded in float32, as a Python float."""
    return float(np.float32(a) * np.float32(b))


def _levels(bits):
    return float(2 ** (bits - 1) - 1)


def _qdq(x, scale, bits):
    """x quantized to the levels of `scale` (a run-time tensor) and back."""
    n = _levels(bits)
    s = scale.clamp(min=1e-8)
    q = torch.round(x / s * n).clamp(-n, n)
    return q * s * _inv(n)


def _ste_grad_maker(op, block, no_grad_set=frozenset()):
    """Every fake-quant op's grad op `<type>_grad` reads only Out@GRAD."""
    from ..framework import grad_var_name

    x = op.input("X")[0]
    if x in no_grad_set:
        return []
    return [{"type": op.type + "_grad",
             "inputs": {"Out@GRAD": [grad_var_name(op.output("Out")[0])]},
             "outputs": {"X@GRAD": [grad_var_name(x)]},
             "attrs": dict(op.attrs)}]


def _straight_through(ctx: ExecContext):
    # d out / d x taken as 1 inside the clip range
    return {"X@GRAD": ctx.input("Out@GRAD")}


@register_op("fake_quantize_dequantize_abs_max", grad=_ste_grad_maker)
def fake_quantize_dequantize_abs_max(ctx: ExecContext):
    """Per-tensor abs-max scale, quantize + dequantize (the reference's
    FakeQuantizeAbsMax + FakeDequantizeMaxAbs pair)."""
    x = ctx.input("X")
    scale = x.abs().amax()
    return {"Out": _qdq(x, scale, int(ctx.attr("bit_length", 8))).to(x.dtype),
            "OutScale": scale.reshape(1)}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             grad=_ste_grad_maker)
def fake_quantize_dequantize_moving_average_abs_max(ctx: ExecContext):
    """Activation quantization with a moving-average scale (the reference's
    FakeQuantizeMovingAverageAbsMax): InScale carries the running scale,
    OutScale its update (the state itself is_test leaves alone)."""
    x = ctx.input("X")
    in_scale = ctx.input("InScale").reshape(())
    rate = float(ctx.attr("moving_rate", 0.9))
    if bool(ctx.attr("is_test", False)):
        scale = in_scale
    else:
        scale = rate * in_scale + (1 - rate) * x.abs().amax()
    return {"Out": _qdq(x, scale, int(ctx.attr("bit_length", 8))).to(x.dtype),
            "OutScale": scale.reshape(1)}


@register_op("fake_quantize_dequantize_static", grad=_ste_grad_maker)
def fake_quantize_dequantize_static(ctx: ExecContext):
    """Quantize-dequantize with a fixed calibrated scale (the post-training
    path): the scale is a constant, so both products are by folded
    constants."""
    x = ctx.input("X")
    n = _levels(int(ctx.attr("bit_length", 8)))
    s = max(float(np.float32(ctx.attr("scale"))), 1e-8)
    q = torch.round(x * _fold(_inv(s), n)).clamp(-n, n)
    return {"Out": (q * _fold(s, _inv(n))).to(x.dtype)}


for _t in ("fake_quantize_dequantize_abs_max",
           "fake_quantize_dequantize_moving_average_abs_max",
           "fake_quantize_dequantize_static"):
    register_grad_compute(_t)(_straight_through)


@register_op("dequantize_abs_max", grad="none")
def dequantize_abs_max(ctx: ExecContext):
    """int8 weight -> float (the reference's FakeDequantizeMaxAbs): Out =
    X * Scale / (2^(bits-1) - 1). ConvertToInt8Pass inserts it so that
    models stored in int8 run."""
    x, scale = ctx.input("X"), ctx.input("Scale")
    n = _levels(int(ctx.attr("bit_length", 8)))
    return {"Out": x.float() * scale.reshape(()) * _inv(n)}
