"""Activation ops of the ported paths. Their grads are derived by replay
(ops/registry.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
