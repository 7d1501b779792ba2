"""Save and load variables and inference models (the JAX package's io.py).

Variables are read from a Scope and written one `.npy` per variable, named
by `_encode_name`, or all into one `.npz` with `filename=`; programs are
written as the JSON of `Program.to_dict`, an inference model's with a
`__meta__` entry naming its feeds, fetches and parameter file. The layout
is the JAX package's byte for byte, so a directory written by one package
loads in the other. numpy has no bfloat16: a bfloat16 tensor is written as
its 2-byte words under descr '<V2', as `np.save` writes the JAX package's
bfloat16 arrays, and read back bit for bit into a bfloat16 var.

The port has no global scope: every function takes `scope` and raises
without one. Loads check each array against its var (`weights.host_tensor`:
shape and dtype) before they write any, and put the tensors on the
executor's device (CUDA unless the executor was made for another; with no
executor, CUDA or a raise).

`save_sharded` / `load_sharded` checkpoint every persistable var: where
the JAX package writes an orbax tree, the port writes `save_vars`' files
(the JAX package's `.npy` bytes) into a stage directory and renames it
into place, under the resilience `io_policy` with the `ckpt.write` fault
site. Over several `torch.distributed` ranks rank 0 writes the replicated
vars and each rank its ZeRO-1 shards.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Callable, Sequence

import numpy as np
import torch

from .executor import Executor, Scope, resolve_device
from .framework import Parameter, Program, Variable, default_main_program
from .weights import host_tensor

__all__ = [
    "save_sharded",
    "load_sharded",
    "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model",
    "save_train_model",
    "load_train_model",
]

_MODEL_FILENAME = "__model__.json"
_SAFE = "%"


def _encode_name(name: str) -> str:
    """Var names may contain '/' etc.; make them filesystem-safe."""
    return "".join(c if (c.isalnum() or c in "._-@") else f"{_SAFE}{ord(c):02x}"
                   for c in name)


def _is_param(var: Variable) -> bool:
    return isinstance(var, Parameter)


def _is_persistable(var: Variable) -> bool:
    return bool(getattr(var, "persistable", False))


def _need_scope(scope, what: str) -> Scope:
    if scope is None:
        raise ValueError(f"{what} needs an explicit scope (the port has no "
                         f"global scope)")
    return scope


def _select_vars(program: Program, vars=None, predicate: Callable | None = None):
    if vars is not None:
        return [program.global_block.var(v) if isinstance(v, str) else v
                for v in vars]
    predicate = predicate or _is_persistable
    return [v for v in program.list_vars() if predicate(v)]


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A scope tensor as numpy; bfloat16 as its uint16 words."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _write_npy(f, arr: np.ndarray, bf16: bool) -> None:
    """`np.save`'s bytes; bfloat16 words under the descr '<V2' that
    `np.save` gives ml_dtypes' bfloat16 (a numpy void array would say
    '|V2')."""
    if not bf16:
        np.lib.format.write_array(f, arr, allow_pickle=False)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
    f.write(np.ascontiguousarray(arr).tobytes())


def save_vars(executor: Executor | None = None, dirname: str = "",
              main_program: Program | None = None, vars=None,
              predicate: Callable | None = None, filename: str | None = None,
              scope: Scope | None = None):
    """Write selected vars' scope values under `dirname` (reference
    io.py:128); returns their names, sorted. A scope a tensor-parallel run
    holds shards of writes the global tensors, gathered over the tp group
    (every rank of it calls the save)."""
    from .parallel.tensor_parallel import global_value

    if not dirname:
        raise ValueError("save_vars requires a target dirname")
    scope = _need_scope(scope, "save_vars")
    program = main_program or default_main_program()
    selected = _select_vars(program, vars, predicate)
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for v in selected:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(
                f"variable '{v.name}' has no value in scope — run the startup "
                f"program (and a train step for accumulators) before saving")
        val = global_value(scope, v.name, val)
        arrays[v.name] = (_host_array(val), val.dtype == torch.bfloat16)
    if filename is not None:
        # np.savez's archive: stored members named <key>.npy
        path = os.path.join(dirname, filename)
        if not path.endswith(".npz"):
            path += ".npz"
        with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for k, (a, bf16) in arrays.items():
                with zf.open(_encode_name(k) + ".npy", "w",
                             force_zip64=True) as f:
                    _write_npy(f, a, bf16)
    else:
        for k, (a, bf16) in arrays.items():
            with open(os.path.join(dirname, _encode_name(k) + ".npy"),
                      "wb") as f:
                _write_npy(f, a, bf16)
    return sorted(arrays)


def save_params(executor=None, dirname="", main_program=None, filename=None,
                scope=None):
    return save_vars(executor, dirname, main_program, predicate=_is_param,
                     filename=filename, scope=scope)


def save_persistables(executor=None, dirname="", main_program=None,
                      filename=None, scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename, scope=scope)


def load_vars(executor: Executor | None = None, dirname: str = "",
              main_program: Program | None = None, vars=None,
              predicate: Callable | None = None, filename: str | None = None,
              scope: Scope | None = None):
    """Load vars saved by save_vars into the scope (reference io.py:566),
    on the executor's device; returns their names, sorted. Every array is
    checked against its var before any is written. A var the scope holds
    tp-sharded takes this rank's shard of the global array."""
    from .parallel.tensor_parallel import local_value

    if not dirname:
        raise ValueError("load_vars requires a source dirname")
    scope = _need_scope(scope, "load_vars")
    device = executor.place if executor is not None else resolve_device()
    program = main_program or default_main_program()
    selected = _select_vars(program, vars, predicate)
    staged = []
    if filename is not None:
        path = os.path.join(dirname, filename)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as packed:
            for v in selected:
                key = _encode_name(v.name)
                if key not in packed:
                    raise FileNotFoundError(
                        f"variable '{v.name}' not found in {path}")
                staged.append((v.name, host_tensor(packed[key], v,
                                                   "load_vars")))
    else:
        for v in selected:
            path = os.path.join(dirname, _encode_name(v.name) + ".npy")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no saved file for variable '{v.name}' at {path}")
            staged.append((v.name, host_tensor(np.load(path), v,
                                               "load_vars")))
    for name, t in staged:
        scope.set_var(name, local_value(scope, name, t).to(device))
    return sorted(v.name for v in selected)


def load_params(executor=None, dirname="", main_program=None, filename=None,
                scope=None):
    return load_vars(executor, dirname, main_program, predicate=_is_param,
                     filename=filename, scope=scope)


def load_persistables(executor=None, dirname="", main_program=None,
                      filename=None, scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename, scope=scope)


# ---------------------------------------------------------------------------
# Inference model export (prune + serialize)
# ---------------------------------------------------------------------------


def _prune_for_targets(program: Program, feed_names: Sequence[str],
                       target_names: Sequence[str]) -> Program:
    """Keep only ops on the path feeds -> targets (reference prune.cc via
    Program._prune, io.py:1005): reverse reachability over the op list,
    stopping at the feed boundary. Mutates and returns `program` (callers
    pass a private clone)."""
    blk = program.global_block
    feeds = set(feed_names)
    needed = set(target_names) - feeds
    keep_flags = [False] * len(blk.ops)
    for i in range(len(blk.ops) - 1, -1, -1):
        op = blk.ops[i]
        # an op is needed iff it produces a needed var; ops that (re)compute
        # a FED var must go: kept, they would overwrite the feed
        if any(n in needed for n in op.output_names):
            keep_flags[i] = True
            needed.update(n for n in op.input_names if n and n not in feeds)
    blk.ops = [op for op, keep in zip(blk.ops, keep_flags) if keep]
    # drop vars no longer referenced (params kept only if referenced)
    referenced = set(feed_names) | set(target_names)
    for op in blk.ops:
        referenced.update(n for n in op.input_names if n)
        referenced.update(n for n in op.output_names if n)
    blk.vars = {k: v for k, v in blk.vars.items() if k in referenced}
    return program


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars, executor: Executor | None = None,
                         main_program: Program | None = None,
                         model_filename: str | None = None,
                         params_filename: str | None = None,
                         scope: Scope | None = None):
    """Prune a for_test clone of the program to the feeds -> targets
    subgraph and save it with the parameters and persistables it reads
    (reference io.py:933). Returns the target names."""
    scope = _need_scope(scope, "save_inference_model")
    program = main_program or default_main_program()
    target_names = [v.name if isinstance(v, Variable) else str(v)
                    for v in target_vars]
    inference = _prune_for_targets(program.clone(for_test=True),
                                   feeded_var_names, target_names)
    os.makedirs(dirname, exist_ok=True)
    desc = inference.to_dict()
    desc["__meta__"] = {"feed_names": list(feeded_var_names),
                        "fetch_names": target_names,
                        "params_filename": params_filename}
    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME), "w") as f:
        json.dump(desc, f)
    needed = {v.name for v in inference.list_vars()
              if _is_param(v) or _is_persistable(v)}
    save_vars(executor, dirname, program,
              vars=[n for n in sorted(needed)
                    if program.global_block.has_var(n)],
              filename=params_filename, scope=scope)
    return target_names


def load_inference_model(dirname: str, executor: Executor | None = None,
                         model_filename: str | None = None,
                         params_filename: str | None = None,
                         scope: Scope | None = None):
    """Returns (program, feed_names, fetch_var_names), the parameters in
    `scope` on the executor's device (reference io.py:1113)."""
    scope = _need_scope(scope, "load_inference_model")
    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME)) as f:
        desc = json.load(f)
    meta = desc.pop("__meta__", {})
    program = Program.from_dict(desc)
    params_filename = params_filename or meta.get("params_filename")
    load_vars(executor, dirname, program,
              vars=[v for v in program.list_vars()
                    if _is_param(v) or _is_persistable(v)],
              filename=params_filename, scope=scope)
    return program, meta.get("feed_names", []), meta.get("fetch_names", [])


def _checkpoint_vars(program: Program) -> list:
    """Every param or persistable var of the program, once by name."""
    out = {}
    for v in program.list_vars():
        if (_is_param(v) or _is_persistable(v)) and v.name not in out:
            out[v.name] = v
    return list(out.values())


_SHARD_META = "sharded.json"


def _shard_file(name: str, rank: int, nranks: int) -> str:
    return f"{_encode_name(name)}.zero1-{rank}-of-{nranks}.npy"


def _shard_rows_var(program: Program, var):
    """The `<name>@ZERO1_SHARD` var of a ZeRO-1 parameter or optimizer
    state (its shape is the shard's), or None."""
    return program.global_block.vars.get(var.name + "@ZERO1_SHARD")


def _held_shard(program: Program, var, value, nranks: int) -> bool:
    """True where `value` is this rank's ZeRO-1 shard of the optimizer
    state `var` (the port keeps those sharded; parameters are whole)."""
    sv = _shard_rows_var(program, var)
    return (nranks > 1 and sv is not None and len(sv.shape) > 0
            and getattr(var, "is_opt_state", False)
            and value.shape[0] == sv.shape[0])


def _checked_var(program: Program, var, nranks: int, whole: bool):
    """`var`, or for a var of the ZeRO-1 rewrite a stand-in with the shape
    its file holds (the shard's, or the whole var's with whole=True): the
    gathers' shape inference gives such vars the shard's shape, in both
    packages, so their own shape says nothing."""
    import types

    sv = _shard_rows_var(program, var)
    if sv is None:
        return var
    rows = sv.shape[0] * (nranks if whole else 1)
    return types.SimpleNamespace(
        name=var.name, shape=[rows] + list(sv.shape[1:]), dtype=var.dtype,
        np_dtype=var.np_dtype, np_feed_dtype=var.np_feed_dtype)


def _checkpoint_program(executor, main_program, what: str) -> Program:
    """The program whose vars describe the scope: for a CompiledProgram
    the one its executor runs (with_data_parallel's clone past one rank,
    which holds the ZeRO-1 rewrite of sharded_optimizer_states)."""
    from .compiler import CompiledProgram

    program = main_program or default_main_program()
    if not isinstance(program, CompiledProgram):
        return program
    if executor is None:
        raise ValueError(f"{what}: a CompiledProgram needs the executor that "
                         f"runs it")
    return executor._program_for(program)


def _check_whole(program: Program, var, value, nranks: int) -> None:
    """Raise unless `value` has `var`'s whole shape (a -1 dim takes any
    extent): a rank's ZeRO-1 shard of a var its program does not mark so
    (the with_data_parallel clone's) would lose the other ranks' rows."""
    want = _checked_var(program, var, nranks, whole=True).shape
    got = tuple(value.shape)
    if len(got) != len(want) or any(d != -1 and a != d
                                    for a, d in zip(got, want)):
        raise ValueError(
            f"save_sharded: '{var.name}' holds shape {got} in the scope, the "
            f"var is {tuple(want)}: the scope holds a shard the program does "
            f"not know of; pass the CompiledProgram that trained it as "
            f"main_program")


def _barrier(nranks: int) -> None:
    if nranks > 1:
        import torch.distributed as dist

        dist.barrier()


def save_sharded(executor=None, dirname="", main_program=None, scope=None):
    """Checkpoint every persistable var that holds a value in `scope` (the
    JAX package's io.py:235). Over several torch.distributed ranks every
    rank calls it: rank 0 writes the replicated vars, each rank its ZeRO-1
    shards of the optimizer state (`<name>.zero1-<rank>-of-<n>.npy`), and
    `sharded.json` records the world size and the sharded names (at world
    size 1 the directory holds the var files alone).

    Atomic: the files are written into the sibling stage directory
    `<dirname>.tmp-stage` and renamed over `dirname` by rank 0 only after
    every rank's last one is written (barriers between the steps), so an
    interrupted or failed save leaves at worst a stage orphan, never a
    half-written tree under the target name. A transient I/O failure
    retries under the resilience io_policy (the `ckpt.write` fault site).
    The files are `save_vars`' (one `.npy` a var, the JAX package's bytes),
    not an orbax tree: a difference by construction (ROADMAP Queue 3).

    `main_program` may be the CompiledProgram that trained the scope (it
    must be, for with_data_parallel with sharded_optimizer_states past one
    rank); a var whose value in the scope is not its whole shape raises
    before anything is written."""
    from .parallel.mesh import world
    from .resilience.faults import fault_point
    from .resilience.retry import io_policy

    scope = _need_scope(scope, "save_sharded")
    program = _checkpoint_program(executor, main_program, "save_sharded")
    rank, nranks = world()
    held = [v for v in _checkpoint_vars(program)
            if scope.find_var(v.name) is not None]
    shards = [v for v in held
              if _held_shard(program, v, scope.find_var(v.name), nranks)]
    whole = [v for v in held if v not in shards]
    for v in whole:
        _check_whole(program, v, scope.find_var(v.name), nranks)
    path = os.path.abspath(dirname)
    tmp = f"{path}.tmp-stage"
    try:
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier(nranks)

        def _write():
            fault_point("ckpt.write")
            if rank == 0:
                save_vars(executor, tmp, program, vars=whole, scope=scope)
            if rank == 0 and nranks > 1:
                with open(os.path.join(tmp, _SHARD_META), "w") as f:
                    json.dump({"world_size": nranks,
                               "shards": [v.name for v in shards]}, f)
            for v in shards:
                val = scope.find_var(v.name)
                with open(os.path.join(tmp, _shard_file(v.name, rank,
                                                        nranks)), "wb") as f:
                    _write_npy(f, _host_array(val),
                               val.dtype == torch.bfloat16)

        io_policy().call(_write)
        _barrier(nranks)
        if rank == 0:
            # swap into place; keep the previous checkpoint aside until the
            # new one is committed, so a crash mid-swap still leaves a
            # loadable copy
            old = f"{path}.old"
            shutil.rmtree(old, ignore_errors=True)
            if os.path.exists(path):
                os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        _barrier(nranks)
    finally:
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)


def _joined_shards(path, saved, name, n):
    """The rows of every rank's shard file of `name`, from a checkpoint of
    a world of `n` ranks, joined in rank order."""
    parts = []
    for r in range(n):
        f = _shard_file(name, r, n)
        if f not in saved:
            raise FileNotFoundError(
                f"load_sharded: {path} lacks {f}, rank {r}'s shard of "
                f"'{name}' (its world had {n} ranks)")
        parts.append(np.load(os.path.join(path, f)))
        if parts[-1].shape[1:] != parts[0].shape[1:] or \
                parts[-1].shape[0] != parts[0].shape[0]:
            raise ValueError(
                f"load_sharded: {f} holds shape {parts[-1].shape}, rank 0's "
                f"shard of '{name}' {parts[0].shape}")
    return np.concatenate(parts, axis=0)


def load_sharded(executor=None, dirname="", main_program=None, scope=None,
                 shardings=None):
    """Restore a save_sharded checkpoint into `scope`, on the executor's
    device: the program's persistables the checkpoint holds (a program may
    have grown new persistables since the save). ZeRO-1 shards load back
    into a run of the world size that saved them, each rank its own. At
    another world size the state is resharded: every rank's shard file of
    a var is read and their rows joined, and this rank keeps its rows
    where its program holds the var as ZeRO-1 shards (the whole var
    elsewhere, and at world size 1); a missing shard file, or one whose
    shape does not fit, raises. `shardings`
    is the port's Mesh (its data axis gives the rank and the world size)
    or None for the process group's. `main_program` is the program or the
    CompiledProgram that save_sharded was given."""
    from .parallel.mesh import DATA_AXIS, Mesh, world
    from .resilience.retry import io_policy

    if shardings is not None and not isinstance(shardings, Mesh):
        raise TypeError(
            f"load_sharded(shardings=...) takes the port's parallel.Mesh, "
            f"got {type(shardings).__name__}")
    scope = _need_scope(scope, "load_sharded")
    program = _checkpoint_program(executor, main_program, "load_sharded")
    if shardings is not None and DATA_AXIS in shardings.axis_names:
        g = shardings.group(DATA_AXIS)
        rank, nranks = g.index, g.size
    else:
        rank, nranks = world()
    path = os.path.abspath(dirname)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    saved = set(os.listdir(path))
    meta = {"world_size": 1, "shards": []}
    if _SHARD_META in saved:
        with open(os.path.join(path, _SHARD_META)) as f:
            meta = json.load(f)
    sharded = set(meta["shards"])
    saved_n = int(meta["world_size"])
    held = [v for v in _checkpoint_vars(program)
            if v.name not in sharded and _encode_name(v.name) + ".npy" in saved]
    plain = [v for v in held if _shard_rows_var(program, v) is None]
    io_policy().call(load_vars, executor, path, program, vars=plain,
                     scope=scope)
    device = executor.place if executor is not None else resolve_device()
    staged = []
    # the shard files first: a missing one raises before any other read
    for v in sorted(_checkpoint_vars(program), key=lambda v: v.name
                    not in sharded):
        if v.name in sharded and saved_n != nranks:
            arr, whole = _joined_shards(path, saved, v.name, saved_n), True
            sv = _shard_rows_var(program, v)
            if nranks > 1 and sv is not None and len(sv.shape) > 0 and \
                    getattr(v, "is_opt_state", False):
                k = sv.shape[0]
                if arr.shape[0] != k * nranks:
                    raise ValueError(
                        f"load_sharded: '{v.name}' has {arr.shape[0]} rows in "
                        f"{path}, which do not split into {nranks} shards "
                        f"of {k}")
                arr, whole = arr[rank * k:(rank + 1) * k], False
        elif v.name in sharded:
            arr, whole = np.load(os.path.join(
                path, _shard_file(v.name, rank, nranks))), False
        elif v in held and v not in plain:
            arr, whole = np.load(os.path.join(
                path, _encode_name(v.name) + ".npy")), True
        else:
            continue
        staged.append((v.name, host_tensor(
            arr, _checked_var(program, v, nranks, whole), "load_sharded")))
    for name, t in staged:
        scope.set_var(name, t.to(device))


# ---------------------------------------------------------------------------
# full train-model save/load (the standalone trainer's input format)
# ---------------------------------------------------------------------------


def save_train_model(dirname: str, feed_order, loss, executor=None,
                     main_program=None, startup_program=None, scope=None):
    """Persist the full training state: the main and startup programs
    (with their backward and optimizer ops), every persistable value, and
    a meta file naming the feeds and the loss."""
    from .framework import default_startup_program

    scope = _need_scope(scope, "save_train_model")
    program = main_program or default_main_program()
    startup = startup_program or default_startup_program()
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "train_main.json"), "w") as f:
        json.dump(program.to_dict(), f)
    with open(os.path.join(dirname, "train_startup.json"), "w") as f:
        json.dump(startup.to_dict(), f)
    meta = {
        "feed_names": [v.name if isinstance(v, Variable) else str(v)
                       for v in feed_order],
        "loss_name": loss.name if isinstance(loss, Variable) else str(loss),
    }
    with open(os.path.join(dirname, "train_meta.json"), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, program, scope=scope)
    return meta


def load_train_model(dirname: str, executor=None, scope=None):
    """Inverse of save_train_model: returns (main, startup, meta) with the
    persistables loaded into the scope."""
    scope = _need_scope(scope, "load_train_model")
    with open(os.path.join(dirname, "train_main.json")) as f:
        program = Program.from_dict(json.load(f))
    with open(os.path.join(dirname, "train_startup.json")) as f:
        startup = Program.from_dict(json.load(f))
    with open(os.path.join(dirname, "train_meta.json")) as f:
        meta = json.load(f)
    load_persistables(executor, dirname, program, scope=scope)
    return program, startup, meta
