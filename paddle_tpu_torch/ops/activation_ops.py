"""Activation ops (the JAX package's activation_ops.py). Their grads are
derived by replay (ops/registry.py). An attr enters the arithmetic rounded
to X's dtype, as the JAX ops take `jnp.asarray(attr, x.dtype)`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .math_ops import rounded
from .registry import ExecContext, register_op


def _act(fn):
    def compute(ctx: ExecContext):
        return {"Out": fn(ctx.input("X"))}

    return compute


# the exact erf form (jax.nn.gelu(approximate=False))
register_op("gelu")(_act(lambda x: F.gelu(x, approximate="none")))
register_op("relu")(_act(torch.relu))
register_op("exp")(_act(torch.exp))
register_op("log")(_act(torch.log))
register_op("sigmoid")(_act(torch.sigmoid))
register_op("tanh")(_act(torch.tanh))
register_op("sqrt")(_act(torch.sqrt))
register_op("reciprocal")(_act(torch.reciprocal))
register_op("sign", grad="none")(_act(torch.sign))
register_op("ceil", grad="none")(_act(torch.ceil))
register_op("floor", grad="none")(_act(torch.floor))
register_op("cos")(_act(torch.cos))
register_op("abs")(_act(torch.abs))
register_op("logsigmoid")(_act(F.logsigmoid))
# half to even, as jnp.round
register_op("round", grad="none")(_act(torch.round))
register_op("rsqrt")(_act(lambda x: 1.0 / torch.sqrt(x)))
register_op("sin")(_act(torch.sin))
# jax.nn.softplus is logaddexp(x, 0): no linear cut-off past a threshold
register_op("softplus")(_act(lambda x: torch.logaddexp(x, torch.zeros_like(x))))
register_op("softsign")(_act(lambda x: x / (1.0 + torch.abs(x))))
register_op("square")(_act(torch.square))


def _attr(ctx: ExecContext, name: str, default: float, x) -> float:
    return rounded(ctx.attr(name, default), x.dtype)


@register_op("relu6")
def relu6(ctx: ExecContext):
    x = ctx.input("X")
    return {"Out": torch.clamp(x, 0.0, _attr(ctx, "threshold", 6.0, x))}


@register_op("leaky_relu")
def leaky_relu(ctx: ExecContext):
    x = ctx.input("X")
    return {"Out": torch.where(x >= 0, x, x * _attr(ctx, "alpha", 0.02, x))}


def _elu(x, alpha):
    return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


@register_op("elu")
def elu(ctx: ExecContext):
    x = ctx.input("X")
    return {"Out": _elu(x, _attr(ctx, "alpha", 1.0, x))}


@register_op("hard_sigmoid")
def hard_sigmoid(ctx: ExecContext):
    x = ctx.input("X")
    return {"Out": torch.clamp(x * _attr(ctx, "slope", 0.2, x)
                               + _attr(ctx, "offset", 0.5, x), 0.0, 1.0)}


@register_op("swish")
def swish(ctx: ExecContext):
    x = ctx.input("X")
    return {"Out": x * torch.sigmoid(_attr(ctx, "beta", 1.0, x) * x)}


@register_op("brelu")
def brelu(ctx: ExecContext):
    x = ctx.input("X")
    return {"Out": torch.clamp(x, ctx.attr("t_min", 0.0), ctx.attr("t_max", 24.0))}


@register_op("soft_relu")
def soft_relu(ctx: ExecContext):
    x = ctx.input("X")
    t = ctx.attr("threshold", 40.0)
    return {"Out": torch.log1p(torch.exp(torch.clamp(x, -t, t)))}


@register_op("thresholded_relu")
def thresholded_relu(ctx: ExecContext):
    x = ctx.input("X")
    return {"Out": torch.where(x > ctx.attr("threshold", 1.0), x,
                               torch.zeros_like(x))}


@register_op("hard_swish")
def hard_swish(ctx: ExecContext):
    """x * clip(x + offset, 0, threshold) / scale (MobileNetV3's h-swish
    at the defaults 6, 6, 3)."""
    x = ctx.input("X")
    t = _attr(ctx, "threshold", 6.0, x)
    o = _attr(ctx, "offset", 3.0, x)
    return {"Out": x * torch.clamp(x + o, 0.0, t) / _attr(ctx, "scale", 6.0, x)}


@register_op("stanh")
def stanh(ctx: ExecContext):
    x = ctx.input("X")
    return {"Out": _attr(ctx, "scale_b", 1.7159, x)
            * torch.tanh(_attr(ctx, "scale_a", 2.0 / 3.0, x) * x)}


@register_op("selu")
def selu(ctx: ExecContext):
    x = ctx.input("X")
    return {"Out": _attr(ctx, "scale", 1.0507009873554805, x)
            * _elu(x, _attr(ctx, "alpha", 1.6732632423543772, x))}
