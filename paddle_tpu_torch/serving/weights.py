"""Carry model weights into a serving engine's scope.

The JAX engine and the port draw their random initial weights from
different generators, so to compute the same function the port takes the
JAX engine's parameters as numpy arrays, e.g.
`{p.name: np.asarray(jax_engine._scope.find_var(p.name)) for p in
jax_engine._prefill_prog.all_parameters()}`, and writes them here.
"""
from __future__ import annotations

import numpy as np

from .. import weights

__all__ = ["load_params"]


def load_params(engine, params: dict[str, np.ndarray]) -> None:
    """Write `params` into `engine`'s parameters in place. The names must be
    exactly the engine's parameter names, and each array must have the
    parameter's shape and dtype; anything else raises before any write."""
    weights.load_params(engine._scope, engine._prefill_prog, params)
