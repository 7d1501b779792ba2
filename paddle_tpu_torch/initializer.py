"""Initializers: each appends one init op writing a parameter into the
*startup* program; the executor runs that block once to materialize the
parameters in the Scope. The random ops draw from a `torch.Generator`
keyed by `Program.random_seed` (ops/tensor_ops.py), so they match the JAX
package in distribution, not bit for bit."""
from __future__ import annotations

import math

__all__ = ["Constant", "Uniform", "Normal", "Xavier"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype.value,
                   "value": self.value})


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype.value,
                   "min": self.low, "max": self.high, "seed": self.seed})


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype.value,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0] if shape else 1), (shape[0] if shape else 1)
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[0] * receptive, shape[1] * receptive


class Xavier(Initializer):
    """Glorot uniform init (the form the layers default to)."""

    def __call__(self, var, block):
        f_in, f_out = _fan_in_out(var)
        limit = math.sqrt(6.0 / (f_in + f_out))
        Uniform(-limit, limit)(var, block)
