"""Carry parameters and optimizer state into a port scope.

The JAX package and the port draw their random initial weights from
different generators, so to compute the same function the port takes the
JAX package's parameters as numpy arrays by name, e.g.
`{p.name: np.asarray(jax_scope.find_var(p.name)) for p in
jax_program.all_parameters()}`, and writes them here. `load_state` does the
same for the persistable vars that are not parameters (optimizer
accumulators, beta powers, the schedule's `@LR_DECAY_COUNTER@`, EMA
shadows, Lookahead's slow copies, the loss scale), so that a run can
continue from another package's step.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework import Parameter

__all__ = ["load_params", "load_state"]


def load_params(scope, program, params: dict[str, np.ndarray]) -> None:
    """Write `params` into `scope`'s tensors of `program`'s parameters, in
    place (run the startup program first: the scope's tensors keep their
    device). The names must be exactly the program's parameter names, and
    each array must have the parameter's shape and dtype; anything else
    raises before any write. A bfloat16 parameter takes a numpy array of a
    2-byte dtype named "bfloat16" (e.g. the JAX package's, through
    ml_dtypes), copied bit for bit."""
    _load(scope, program, [p.name for p in program.all_parameters()], params,
          "load_params", "parameter")


def load_state(scope, program, arrays: dict[str, np.ndarray]) -> None:
    """Write `arrays` into `scope`'s tensors of `program`'s persistable vars
    that are not parameters, in place, with load_params's checks: the names
    exactly those vars', each array of its var's shape and dtype, or a raise
    before any write."""
    names = [v.name for v in program.global_block.vars.values()
             if v.persistable and not isinstance(v, Parameter)]
    _load(scope, program, names, arrays, "load_state", "var")


def _load(scope, program, names, arrays, what, kind):
    missing = sorted(set(names) - set(arrays))
    unexpected = sorted(set(arrays) - set(names))
    if missing or unexpected:
        raise KeyError(f"{what}: missing {missing[:8]}, unexpected "
                       f"{unexpected[:8]} (of {len(names)} {kind}s)")
    block = program.global_block
    staged = []
    for n in names:
        arr = np.asarray(arrays[n])
        var = block.var(n)
        dst = scope.find_var(n)
        if dst is None:
            raise KeyError(f"{what}: '{n}' is not in the scope; run the "
                           f"startup program first")
        if tuple(arr.shape) != tuple(var.shape):
            raise ValueError(f"{what}: '{n}' has shape {arr.shape}, the "
                             f"{kind} is {tuple(var.shape)}")
        if var.dtype.value == "bfloat16":
            if arr.dtype.name != "bfloat16" or arr.dtype.itemsize != 2:
                raise TypeError(f"{what}: '{n}' is {arr.dtype}, the "
                                f"{kind} is bfloat16")
            src = torch.from_numpy(np.array(arr).view(np.int16)).view(
                torch.bfloat16)
        elif arr.dtype != var.np_dtype:
            raise TypeError(f"{what}: '{n}' is {arr.dtype}, the "
                            f"{kind} is {var.np_dtype}")
        else:
            src = torch.from_numpy(np.array(arr))
        staged.append((dst, src))
    with torch.no_grad():
        for dst, src in staged:
            dst.copy_(src)
