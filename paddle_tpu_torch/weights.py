"""Carry parameters into a port scope.

The JAX package and the port draw their random initial weights from
different generators, so to compute the same function the port takes the
JAX package's parameters as numpy arrays by name, e.g.
`{p.name: np.asarray(jax_scope.find_var(p.name)) for p in
jax_program.all_parameters()}`, and writes them here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_params"]


def load_params(scope, program, params: dict[str, np.ndarray]) -> None:
    """Write `params` into `scope`'s tensors of `program`'s parameters, in
    place (run the startup program first: the scope's tensors keep their
    device). The names must be exactly the program's parameter names, and
    each array must have the parameter's shape and dtype; anything else
    raises before any write. A bfloat16 parameter takes a numpy array of a
    2-byte dtype named "bfloat16" (e.g. the JAX package's, through
    ml_dtypes), copied bit for bit."""
    names = [p.name for p in program.all_parameters()]
    missing = sorted(set(names) - set(params))
    unexpected = sorted(set(params) - set(names))
    if missing or unexpected:
        raise KeyError(f"load_params: missing {missing[:8]}, unexpected "
                       f"{unexpected[:8]} (of {len(names)} parameters)")
    block = program.global_block
    staged = []
    for n in names:
        arr = np.asarray(params[n])
        var = block.var(n)
        dst = scope.find_var(n)
        if dst is None:
            raise KeyError(f"load_params: '{n}' is not in the scope; run the "
                           f"startup program first")
        if tuple(arr.shape) != tuple(var.shape):
            raise ValueError(f"load_params: '{n}' has shape {arr.shape}, the "
                             f"parameter is {tuple(var.shape)}")
        if var.dtype.value == "bfloat16":
            if arr.dtype.name != "bfloat16" or arr.dtype.itemsize != 2:
                raise TypeError(f"load_params: '{n}' is {arr.dtype}, the "
                                f"parameter is bfloat16")
            src = torch.from_numpy(np.array(arr).view(np.int16)).view(
                torch.bfloat16)
        elif arr.dtype != var.np_dtype:
            raise TypeError(f"load_params: '{n}' is {arr.dtype}, the "
                            f"parameter is {var.np_dtype}")
        else:
            src = torch.from_numpy(np.array(arr))
        staged.append((dst, src))
    with torch.no_grad():
        for dst, src in staged:
            dst.copy_(src)
