"""Initializers: each appends one init op writing a parameter into the
*startup* program; the executor runs that block once to materialize the
parameters in the Scope. The random ops draw from a `torch.Generator`
keyed by `Program.random_seed` (ops/tensor_ops.py), so they match the JAX
package in distribution, not bit for bit."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
           "MSRA", "NumpyArrayInitializer"]


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


class TruncatedNormal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "truncated_gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype.value,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0] if shape else 1), (shape[0] if shape else 1)
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[0] * receptive, shape[1] * receptive


class Xavier(Initializer):
    """Glorot init (the reference's initializer.py:327): uniform on
    +-sqrt(6 / (fan_in + fan_out)) or normal with std sqrt(2 / (fan_in +
    fan_out)), the fans from the var's shape unless given."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        f_in, f_out = _fan_in_out(var)
        f_in = self.fan_in if self.fan_in is not None else f_in
        f_out = self.fan_out if self.fan_out is not None else f_out
        if self.uniform:
            limit = math.sqrt(6.0 / (f_in + f_out))
            Uniform(-limit, limit, self.seed)(var, block)
        else:
            Normal(0.0, math.sqrt(2.0 / (f_in + f_out)), self.seed)(var, block)


class MSRA(Initializer):
    """Kaiming init (the reference's initializer.py:443): uniform on
    +-sqrt(6 / fan_in) or normal with std sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        f_in = self.fan_in if self.fan_in is not None else _fan_in_out(var)[0]
        if self.uniform:
            limit = math.sqrt(6.0 / f_in)
            Uniform(-limit, limit, self.seed)(var, block)
        else:
            Normal(0.0, math.sqrt(2.0 / f_in), self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    """The parameter set to `value` (an assign_value op carrying it)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            "assign_value", outputs={"Out": [var.name]},
            attrs={"shape": list(self.value.shape), "dtype": var.dtype.value,
                   "values": self.value.reshape(-1).tolist()})


ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
XavierInitializer = Xavier
MSRAInitializer = MSRA
