"""Probability distributions (the JAX package's layers/distributions.py):
Uniform, Normal, Categorical and MultivariateNormalDiag, whose sample,
entropy, log_prob and kl_divergence build ops into the program. Draws
come from the random ops (the run's generator)."""
from __future__ import annotations

import math

import numpy as np

from . import control_flow as CF
from . import nn as L
from . import tensor as T

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "MultivariateNormalDiag"]


def _to_var(v, dtype="float32"):
    from ..framework import Variable

    if isinstance(v, Variable):
        return v
    return T.assign(np.asarray(v, dtype=np.float32))


class Distribution:
    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError


class Uniform(Distribution):
    """U(low, high) elementwise."""

    def __init__(self, low, high):
        self.low = _to_var(low)
        self.high = _to_var(high)

    def sample(self, shape, seed=0):
        u = T.uniform_random(shape, min=0.0, max=1.0, seed=seed)
        return L.elementwise_add(
            L.elementwise_mul(u, L.elementwise_sub(self.high, self.low)),
            self.low)

    def log_prob(self, value):
        """log(1[low < value < high] / (high - low)). The comparisons are
        control_flow's (the JAX module asks `nn` for them, which has
        none)."""
        width = L.elementwise_sub(self.high, self.low)
        lb = L.cast(CF.greater_than(value, self.low), "float32")
        ub = L.cast(CF.less_than(value, self.high), "float32")
        return L.log(L.elementwise_div(L.elementwise_mul(lb, ub), width))

    def entropy(self):
        return L.log(L.elementwise_sub(self.high, self.low))


class Normal(Distribution):
    """N(loc, scale) elementwise."""

    def __init__(self, loc, scale):
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)

    def sample(self, shape, seed=0):
        z = T.gaussian_random(shape, mean=0.0, std=1.0, seed=seed)
        return L.elementwise_add(L.elementwise_mul(z, self.scale), self.loc)

    def entropy(self):
        c = 0.5 + 0.5 * math.log(2 * math.pi)
        return L.scale(L.log(self.scale), scale=1.0, bias=c)

    def log_prob(self, value):
        var = L.elementwise_mul(self.scale, self.scale)
        diff = L.elementwise_sub(value, self.loc)
        return L.scale(
            L.elementwise_add(
                L.elementwise_div(L.elementwise_mul(diff, diff), var),
                L.scale(L.log(var), bias=math.log(2 * math.pi))),
            scale=-0.5)

    def kl_divergence(self, other: "Normal"):
        var_p = L.elementwise_mul(self.scale, self.scale)
        var_q = L.elementwise_mul(other.scale, other.scale)
        diff = L.elementwise_sub(self.loc, other.loc)
        t1 = L.log(L.elementwise_div(other.scale, self.scale))
        t2 = L.elementwise_div(
            L.elementwise_add(var_p, L.elementwise_mul(diff, diff)),
            L.scale(var_q, scale=2.0))
        return L.scale(L.elementwise_add(t1, t2), bias=-0.5)


class Categorical(Distribution):
    """Categorical over the last dim of `logits`."""

    def __init__(self, logits):
        self.logits = logits

    def _probs(self):
        return L.softmax(self.logits)

    def entropy(self):
        p = self._probs()
        logp = L.log(L.scale(p, bias=1e-12))
        return L.scale(L.reduce_sum(L.elementwise_mul(p, logp), dim=-1),
                       scale=-1.0)

    def kl_divergence(self, other: "Categorical"):
        p = self._probs()
        logp = L.log(L.scale(p, bias=1e-12))
        logq = L.log(L.scale(other._probs(), bias=1e-12))
        return L.reduce_sum(
            L.elementwise_mul(p, L.elementwise_sub(logp, logq)), dim=-1)

    def log_prob(self, value):
        """value: int indices into the last dim, [B], [B, 1] or batched."""
        p = self._probs()
        onehot = L.one_hot(L.cast(value, "int64"), depth=self.logits.shape[-1])
        return L.log(L.scale(
            L.reduce_sum(L.elementwise_mul(p, onehot), dim=-1), bias=1e-12))

    def sample(self, shape=None, seed=0):
        """One Gumbel-max draw a logits row: argmax(logits + G)."""
        if shape:
            raise NotImplementedError(
                "Categorical.sample draws one sample per logits row; "
                "tile the logits for multiple draws")
        from ..layer_helper import LayerHelper

        helper = LayerHelper("categorical_sample")
        u = helper.create_variable_for_type_inference("float32")
        helper.append_op(
            "uniform_random_batch_size_like", {"Input": [self.logits]},
            {"Out": [u]}, {"shape": list(self.logits.shape), "min": 1e-6,
                           "max": 1.0, "seed": seed})
        g = L.scale(L.log(L.scale(L.log(u), scale=-1.0)), scale=-1.0)
        return L.argmax(L.elementwise_add(self.logits, g), axis=-1)


class MultivariateNormalDiag(Distribution):
    """A multivariate normal whose `scale` is the diagonal covariance
    matrix (its determinant and inverse read the diagonal)."""

    def __init__(self, loc, scale):
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)

    def _diag(self):
        eye = T.assign(np.eye(self.scale.shape[-1], dtype=np.float32))
        return L.reduce_sum(L.elementwise_mul(self.scale, eye), dim=-1)

    def entropy(self):
        k = self.scale.shape[-1]
        logdet = L.reduce_sum(L.log(self._diag()))
        return L.scale(logdet, scale=0.5,
                       bias=0.5 * k * (1 + math.log(2 * math.pi)))

    def kl_divergence(self, other: "MultivariateNormalDiag"):
        dp, dq = self._diag(), other._diag()
        diff = L.elementwise_sub(other.loc, self.loc)
        tr = L.reduce_sum(L.elementwise_div(dp, dq))
        quad = L.reduce_sum(L.elementwise_div(L.elementwise_mul(diff, diff), dq))
        k = float(self.scale.shape[-1])
        logdet = L.elementwise_sub(L.reduce_sum(L.log(dq)),
                                   L.reduce_sum(L.log(dp)))
        return L.scale(L.elementwise_add(L.elementwise_add(tr, quad), logdet),
                       scale=0.5, bias=-0.5 * k)
