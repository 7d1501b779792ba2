"""Scope and an eager Executor: runs one block op by op on an explicit
device.

The JAX package lowers a whole block into one XLA computation and donates
the read-write state buffers. Here each op's torch compute runs as it comes;
state (parameters, optimizer accumulators, the KV pools) lives in the Scope
as device tensors. An op whose output slot names one of its inputs writes
that var back to the scope: the optimizer ops return new tensors (adam's
ParamOut is Param), the KV cache writes update their pools in place.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .framework import (GRAD_SUFFIX, OpError, Program, Variable,
                        default_main_program)
from .ops.registry import ExecContext, get_op_def

__all__ = ["Scope", "Executor", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With none named and no CUDA present this raises; it never
    falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Scope:
    """Flat name -> tensor store."""

    def __init__(self):
        self._vars: dict[str, Any] = {}
        self._run_counter = 0

    def has_var(self, name: str) -> bool:
        return name in self._vars

    def find_var(self, name: str):
        return self._vars.get(name)

    def set_var(self, name: str, value):
        self._vars[name] = value


def _run_generator(device: torch.device, seed: int, counter: int):
    """The random stream of one run: keyed by (program seed, run counter),
    so two runs with the same pair draw the same numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(counter)) & 0x7FFF_FFFF_FFFF_FFFF)
    return g


class Executor:
    """run(program, feed, fetch_list, scope) on one device."""

    def __init__(self, place=None):
        self.place = resolve_device(place)

    def run(self, program: Program | None = None, feed: dict | None = None,
            fetch_list: Sequence | None = None, scope: Scope | None = None,
            return_numpy: bool = True, rng_counter: int | None = None):
        """Feed host arrays (cast to each var's 32-bit runtime dtype) or
        tensors, run every op of the global block, write persistable outputs
        (and outputs the scope already holds) back to `scope`, and return
        the fetches — as numpy arrays unless `return_numpy` is False.
        `rng_counter` replaces the scope's run counter in the random key."""
        program = program or default_main_program()
        if scope is None:
            raise ValueError("Executor.run needs an explicit scope")
        block = program.global_block
        dev = self.place
        env: dict[str, Any] = {}
        for n, v in (feed or {}).items():
            var = block.vars.get(n)
            if isinstance(v, torch.Tensor):
                env[n] = v.to(dev)
                continue
            arr = np.asarray(v)
            if var is not None:
                arr = arr.astype(var.np_feed_dtype, copy=False)
            # not ascontiguousarray on every feed: it turns a 0-d array 1-d
            if not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr)
            env[n] = torch.from_numpy(arr).to(dev)

        scope._run_counter += 1
        counter = scope._run_counter if rng_counter is None else int(rng_counter)
        gen = None
        written: list[str] = []
        for op in block.ops:
            opdef = get_op_def(op.type)
            for n in op.input_names:
                if n and n not in env:
                    if n.endswith(GRAD_SUFFIX) and not scope.has_var(n):
                        # an output grad the backward pass never produced
                        # (a forward output that does not reach the loss):
                        # the grad op reads it as zeros
                        continue
                    if not scope.has_var(n):
                        raise RuntimeError(
                            f"variable '{n}' (input of op '{op.type}') is "
                            f"neither fed nor in the scope: run the startup "
                            f"program first, or feed it")
                    env[n] = scope.find_var(n)
            if opdef.needs_rng and gen is None:
                gen = _run_generator(dev, program.random_seed or 0, counter)
            ctx = ExecContext(op, env, dev, gen if opdef.needs_rng else None)
            try:
                outs = opdef.compute(ctx)
            except Exception as e:  # noqa: BLE001 - re-raised with attribution
                raise OpError(op, e) from e
            for slot, val in outs.items():
                vals = val if isinstance(val, (list, tuple)) else [val]
                for n, t in zip(op.outputs.get(slot, []), vals):
                    if n and t is not None:
                        env[n] = t
                        written.append(n)

        for n in dict.fromkeys(written):
            var = block.vars.get(n)
            if (var is not None and var.persistable) or scope.has_var(n):
                scope.set_var(n, env[n])
        names = [v.name if isinstance(v, Variable) else str(v)
                 for v in (fetch_list or [])]
        missing = [n for n in names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not produced by "
                           f"the program or fed")
        fetches = [env[n] for n in names]
        if return_numpy:
            return [t.detach().cpu().numpy() for t in fetches]
        return fetches
