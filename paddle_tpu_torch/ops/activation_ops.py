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
register_op("sqrt")(_act(torch.sqrt))
register_op("reciprocal")(_act(torch.reciprocal))
register_op("sign", grad="none")(_act(torch.sign))
