"""Carry parameters and optimizer state into a port scope.

The JAX package and the port draw their random initial weights from
different generators, so to compute the same function the port takes the
JAX package's parameters as numpy arrays by name, e.g.
`{p.name: np.asarray(jax_scope.find_var(p.name)) for p in
jax_program.all_parameters()}`, and writes them here. A scope that a
tensor-parallel run holds shards of (parallel/tensor_parallel.py) keeps
this rank's shard of each global array, in the rewrite's layout. `load_state` does the
same for the persistable vars that are not parameters (optimizer
accumulators, beta powers, the schedule's `@LR_DECAY_COUNTER@`, EMA
shadows, Lookahead's slow copies, the loss scale), so that a run can
continue from another package's step.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework import Parameter

__all__ = ["load_params", "load_state", "host_tensor"]


def load_params(scope, program, params: dict[str, np.ndarray]) -> None:
    """Write `params` into `scope`'s tensors of `program`'s parameters, in
    place (run the startup program first: the scope's tensors keep their
    device). The names must be exactly the program's parameter names, and
    each array must have the parameter's shape and dtype; anything else
    raises before any write. A bfloat16 parameter takes a numpy array of a
    2-byte dtype named "bfloat16" (e.g. the JAX package's, through
    ml_dtypes), or the same 2-byte words as read back from a file (`V2` or
    uint16), copied bit for bit."""
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
    from .parallel.tensor_parallel import local_value

    block = program.global_block
    staged = []
    for n in names:
        dst = scope.find_var(n)
        if dst is None:
            raise KeyError(f"{what}: '{n}' is not in the scope; run the "
                           f"startup program first")
        # a scope a tensor-parallel run holds shards of keeps this rank's
        staged.append((dst, local_value(scope, n, host_tensor(
            arrays[n], block.var(n), what, kind))))
    with torch.no_grad():
        for dst, src in staged:
            dst.copy_(src)


def _bf16_words(arr: np.ndarray) -> bool:
    """A bfloat16 array: ml_dtypes' (named "bfloat16"), or its 2-byte words
    as numpy reads them back from a file (numpy has no bfloat16: `np.save`
    of ml_dtypes' array writes descr '<V2', read back as void) or uint16."""
    return arr.dtype.itemsize == 2 and (
        arr.dtype.name == "bfloat16" or arr.dtype.kind == "V"
        or arr.dtype == np.uint16)


def host_tensor(arr, var, what="load", kind="var") -> torch.Tensor:
    """`arr` as a CPU tensor for `var`: of the var's shape (a -1 dim takes
    any extent) and of its dtype
    (a 64-bit var also takes the 32-bit array the runtime holds), else a
    ValueError or TypeError naming the var. A bfloat16 var takes 2-byte
    words (`_bf16_words`) bit for bit, and only a bfloat16 var does."""
    arr = np.asarray(arr)
    n = var.name
    if len(arr.shape) != len(var.shape) or any(
            d != -1 and a != d for a, d in zip(arr.shape, var.shape)):
        raise ValueError(f"{what}: '{n}' has shape {arr.shape}, the "
                         f"{kind} is {tuple(var.shape)}")
    if var.dtype.value == "bfloat16":
        if not _bf16_words(arr):
            raise TypeError(f"{what}: '{n}' is {arr.dtype}, the "
                            f"{kind} is bfloat16")
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    if arr.dtype not in (var.np_dtype, var.np_feed_dtype):
        raise TypeError(f"{what}: '{n}' is {arr.dtype}, the "
                        f"{kind} is {var.np_dtype}")
    return torch.from_numpy(np.array(arr))
