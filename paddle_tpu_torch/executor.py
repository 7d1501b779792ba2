"""Scope and an eager Executor: runs one block op by op on an explicit
device.

The JAX package lowers a whole block into one XLA computation and donates
the read-write state buffers. Here each op's torch compute runs as it comes;
state (parameters, optimizer accumulators, the KV pools) lives in the Scope
as device tensors. An op whose output slot names one of its inputs writes
that var back to the scope: the optimizer ops return new tensors (adam's
ParamOut is Param), the KV cache writes update their pools and the step
counters' `increment` its counter in place. `train_from_dataset` runs a
program once a batch of a Dataset, the batches staged on the device ahead
of the step by a DeviceLoader, each step dispatched by `run_async`: its
completion token is a CUDA event, and the host runs at most
FLAGS_max_inflight_steps steps ahead of the device, waiting on the oldest
event under the resilience watchdog. A program whose embeddings were tiered
(passes.rewrite_tiered_embeddings) carries its engine: `run` takes the
resolution ticket of a feed the loader's thread resolved, or resolves a raw
feed inline, and hands the step's evicted rows to the engine after the
step is dispatched. A program built under FLAGS_guard_numerics writes its
health vector (resilience/guardrails.py) each step: `run_async` copies it
to pinned host memory behind the step and hands it to the attached
StepGuard when the step's event is drained.

The JAX package fires the `executor.compile` fault site on a compile-cache
miss. This executor compiles nothing; its counterpart is a record of the
programs it has prepared: the site fires on a program's first run here,
and again after `invalidate_cache(program)` drops the record. The record
also holds the program's tuner decisions (tuning/): an op resolves one at
its first run in the prepared program, where the JAX package resolves at
its trace, so a verdict promoted to the tuning DB takes effect after
`invalidate_cache` or on a new executor. Under FLAGS_tuning_mode=explore
`run_async` probes one recorded candidate every FLAGS_tuning_explore_every
steps after its window drain (tuning/learned/explore.py).

A CompiledProgram (compiler.py) runs under its mesh: `with_collective`
binds the program's rings to the mesh's groups (a ring registered to an
axis the mesh lacks raises), so its `c_*` ops reduce; `with_data_parallel`
over more than one rank runs a clone that the parallel rewrites made for
the mesh layout and the feed names (kept per program, keyed by both): the
tensor-parallel one for a `tp` axis, then the sequence-parallel one for an
`sp` axis, then the data-parallel one for a `dp` axis, each in place on
the clone of the one before,
and fetches of values left sharded come back gathered, on the global
batch. Either way each rank feeds its own rows (`Mesh.shard_feed`). The
drain of a `with_collective` step is the `collective_stall` fault site. A
program that a PipelineOptimizer split carries its plan (`_pipeline`), and
`run` hands it the step: the plan runs the stage programs microbatch by
microbatch (parallel/pipeline.py).
"""
from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Any, Sequence

import numpy as np
import torch

from .core.selected_rows import SelectedRows, is_selected_rows
from .core.types import DType
from .framework import (GRAD_SUFFIX, OpError, Program, Variable,
                        default_main_program)
from .ops.registry import ExecContext, get_op_def
from .resilience.guardrails import GUARD_HEALTH_NAME

__all__ = ["Scope", "Executor", "resolve_device", "CPUPlace", "CUDAPlace"]


class CPUPlace:
    """The host as a place object (the JAX package's `CPUPlace`): every
    entry point that takes a device takes it, as it takes "cpu"."""

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace:
    """Card `device_id` as a place object, the counterpart of the JAX
    package's `TPUPlace(device_id)`: entry points take it as they take
    "cuda:<device_id>"."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another (a device, its name, or a place object). With none named and
    no CUDA present this raises; it never falls back to the CPU."""
    if isinstance(device, CPUPlace):
        device = "cpu"
    elif isinstance(device, CUDAPlace):
        device = torch.device("cuda", device.device_id)
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


def _gathered_fetch(axis_env, how, var, t):
    """A fetch of a value a parallel rewrite left split, `how` a list of
    steps: ("tp", state) summed (partial) or gathered along its tp shard,
    ("sp", state) summed or gathered along its sequence or spatial split,
    ("dp",) gathered along the batch over the dp ranks."""
    from .ops.collective_ops import (REWRITE_RING, SP_RING, TP_RING,
                                     _all_gather, _all_reduce)
    from .parallel.sharding import batch_dim
    from .parallel.spatial import ceil_gather
    from .parallel.tensor_parallel import gather_shards

    for step in how:
        if step[0] == "dp":
            t = torch.cat(_all_gather(axis_env[REWRITE_RING], t, "fetch"),
                          dim=batch_dim(var))
            continue
        g = axis_env[TP_RING if step[0] == "tp" else SP_RING]
        if step[1] == "partial":
            t = _all_reduce(g, t, "sum", "fetch")
        elif step[0] == "tp":
            t = gather_shards(_all_gather(g, t.contiguous(), "fetch"),
                              *step[1])
        else:
            t = ceil_gather(g, t, step[1][0], step[1][1], "fetch")
    return t


class Scope:
    """Flat name -> tensor store. Several threads may run programs over one
    scope (a Predictor and its clones): the run counter moves under a lock,
    so each run draws a key of its own."""

    def __init__(self):
        self._vars: dict[str, Any] = {}
        self._run_counter = 0
        self._counter_lock = threading.Lock()

    def next_run(self) -> int:
        """Count one run and return its number."""
        with self._counter_lock:
            self._run_counter += 1
            return self._run_counter

    def has_var(self, name: str) -> bool:
        return name in self._vars

    def find_var(self, name: str):
        return self._vars.get(name)

    def set_var(self, name: str, value):
        self._vars[name] = value

    def var_names(self) -> list[str]:
        return list(self._vars)


def _run_generator(device: torch.device, seed: int, counter: int):
    """The random stream of one run: keyed by (program seed, run counter),
    so two runs with the same pair draw the same numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(counter)) & 0x7FFF_FFFF_FFFF_FFFF)
    return g


def _to_numpy(t):
    """A fetch as numpy: numpy has no bfloat16, so a bf16 tensor comes back
    as the fp32 array of the same values; a SelectedRows as one of numpy
    rows and values."""
    if is_selected_rows(t):
        return SelectedRows(_to_numpy(t.rows), _to_numpy(t.values), t.height)
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy()


_CHECKED_DTYPES = (torch.float16, torch.float32, torch.float64)


def _check_finite(op, outs):
    """FLAGS_check_nan_inf (the JAX package's executor.py:63): every
    floating output of `op` must be finite, or the run raises an OpError
    naming the op. One host read an output: a debug mode. bf16 outputs are
    not checked, as in the JAX package, whose numpy view of a bf16 array is
    not of a floating kind, so both name the same op."""
    for slot, val in outs.items():
        vals = val if isinstance(val, (list, tuple)) else [val]
        for v in vals:
            if is_selected_rows(v):
                v = v.values
            if not isinstance(v, torch.Tensor) or v.dtype not in \
                    _CHECKED_DTYPES:
                continue
            if not bool(torch.isfinite(v).all()):
                raise OpError(op, FloatingPointError(
                    f"output slot '{slot}' contains nan/inf "
                    f"(FLAGS_check_nan_inf)"))


def _apply_numeric_faults(env: dict, feed_names):
    """The `numeric_nan` / `numeric_spike` fault sites (the JAX package's
    executor.py:105): the feed is the injection boundary. The first
    floating feed, in sorted name order, gets a NaN in its first element or
    is scaled by 1e4, in a private copy on the device (no host sync)."""
    from .resilience.faults import InjectedFault, fault_point

    mode = None
    try:
        fault_point("numeric_nan")
    except InjectedFault:
        mode = "nan"
    try:
        fault_point("numeric_spike")
    except InjectedFault:
        mode = mode or "spike"
    if mode is None:
        return
    for n in sorted(feed_names):
        v = env[n]
        if not isinstance(v, torch.Tensor) or v.dtype not in \
                _CHECKED_DTYPES or v.numel() == 0:
            continue
        if mode == "nan":
            v = v.clone()
            v.view(-1)[0] = float("nan")
        else:
            v = v * 1e4
        env[n] = v
        return


def _program_version(program) -> tuple:
    """What a data-parallel clone was made from: each block's ops, by
    identity, and its var count. Appending, inserting or removing an op,
    or creating a var, changes it."""
    return tuple((tuple(map(id, b.ops)), len(b.vars)) for b in program.blocks)


class Executor:
    """run(program, feed, fetch_list, scope) on one device."""

    def __init__(self, place=None):
        self.place = resolve_device(place)
        # run_async's window: (step id, completion event or None, the
        # step's health on the host or None, dispatch time) per dispatched,
        # undrained step, oldest first
        self._inflight: collections.deque = collections.deque()
        self._dispatch_seq = 0
        # the programs prepared on this executor (the `executor.compile`
        # site's record; the JAX package's compile cache), each with its
        # tuner decisions (ExecContext.decisions)
        self._prepared: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        # numeric-guardrail policy (resilience/guardrails.StepGuard): fed
        # each drained step's health vector; may raise GuardRewind
        self._step_guard = None
        # with_data_parallel's rewritten clones: program -> {(mesh layout,
        # feed names, ZeRO-1): (the program's version, clone, names left
        # sharded)}
        self._dp_clones: weakref.WeakKeyDictionary = \
            weakref.WeakKeyDictionary()
        self._last_spmd_mode = "gspmd"

    def run(self, program: Program | None = None, feed: dict | None = None,
            fetch_list: Sequence | None = None, scope: Scope | None = None,
            return_numpy: bool = True, rng_counter: int | None = None):
        """Feed host arrays (cast to each var's 32-bit runtime dtype) or
        tensors (a floating feed of a bfloat16 var is cast to bfloat16 on
        the device: numpy has no bfloat16), run every op of the global block, write persistable outputs
        (and outputs the scope already holds) back to `scope`, and return
        the fetches — as numpy arrays unless `return_numpy` is False (a
        bfloat16 fetch as float32, which holds its values exactly).
        `rng_counter` replaces the scope's run counter in the random key."""
        return self._run_impl(program, feed, fetch_list, scope, return_numpy,
                              rng_counter)[0]

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy,
                  rng_counter):
        """`run`, returning (fetches, the step's health vector on the
        device or None)."""
        from . import flags, profiler
        from .compiler import CompiledProgram
        from .resilience.faults import fault_point

        compiled = None
        if isinstance(program, CompiledProgram):
            compiled, program = program, program._program
        # run_async tags each in-flight step with its regime, so the drain
        # can attribute a wedge to a collective (`collective_stall`)
        self._last_spmd_mode = (compiled._spmd_mode if compiled is not None
                                else "gspmd")
        program = program or default_main_program()
        if scope is None:
            raise ValueError("Executor.run needs an explicit scope")
        if getattr(program, "_pipeline", None) is not None:
            # a PipelineOptimizer's program: the plan runs its whole
            # microbatch schedule (parallel/pipeline.py)
            if compiled is not None and compiled._mesh is not None:
                raise NotImplementedError(
                    "combining PipelineOptimizer with a CompiledProgram mesh "
                    "is not supported yet — run the pipeline program "
                    "directly (dp-sharding inside stages is planned)")
            names = [v.name if isinstance(v, Variable) else str(v)
                     for v in (fetch_list or [])]
            return program._pipeline.run_step(self, scope, feed or {}, names,
                                              return_numpy), None
        # tiered embeddings (embedding/engine.py): a feed the DeviceLoader's
        # thread resolved carries its ticket (popped here: it is no feed of
        # the program); a raw feed resolves inline
        emb_engine = getattr(program, "_tiered_engine", None)
        emb_ticket = None
        if emb_engine is not None and feed:
            feed, emb_ticket = emb_engine.prepare_feed(dict(feed))
        axis_env, gathered = None, {}
        if compiled is not None and compiled._mesh is not None:
            program, axis_env, gathered, layouts = self._under_mesh(
                compiled, program, list(feed or {}))
            if layouts:
                from .parallel.tensor_parallel import shard_scope

                shard_scope(scope, layouts)
        block = program.global_block
        dev = self.place
        env: dict[str, Any] = {}
        for n, v in (feed or {}).items():
            var = block.vars.get(n)
            bf16 = var is not None and var.dtype is DType.BF16
            if is_selected_rows(v):
                env[n] = SelectedRows(torch.as_tensor(v.rows).to(dev),
                                      torch.as_tensor(v.values).to(dev),
                                      v.height)
                continue
            if isinstance(v, torch.Tensor):
                t = v.to(dev)
            else:
                arr = np.asarray(v)
                if var is not None and not bf16:
                    arr = arr.astype(var.np_feed_dtype, copy=False)
                # not ascontiguousarray on every feed: it turns a 0-d array
                # 1-d
                if not arr.flags.c_contiguous:
                    arr = np.ascontiguousarray(arr)
                t = torch.from_numpy(arr).to(dev)
            env[n] = (t.to(torch.bfloat16) if bf16 and t.is_floating_point()
                      else t)

        if program not in self._prepared:
            # a program's first run here (or its first after
            # invalidate_cache): the JAX package's compile-cache miss
            fault_point("executor.compile")
            self._prepared[program] = {}
        decisions = self._prepared[program]
        if axis_env is not None:
            from .ops.collective_ops import AXIS_ENV_KEY

            env[AXIS_ENV_KEY] = axis_env
        # once a step, before any state is read: an injected "collective
        # partner lost" leaves the scope untouched and the step retryable
        fault_point("collective.step")
        _apply_numeric_faults(env, list(feed or {}))
        check_nan = bool(flags.get_flag("check_nan_inf"))

        counter = scope.next_run()
        if rng_counter is not None:
            counter = int(rng_counter)
        t_dispatch = time.perf_counter()
        gen = None
        stash: dict[str, Any] = {}     # forward op -> its grad op, this run
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
            ctx = ExecContext(op, env, dev, gen if opdef.needs_rng else None,
                              stash, program, decisions)
            try:
                outs = opdef.compute(ctx)
            except Exception as e:  # noqa: BLE001 - re-raised with attribution
                raise OpError(op, e) from e
            if check_nan:
                _check_finite(op, outs)
            for slot, val in outs.items():
                vals = val if isinstance(val, (list, tuple)) else [val]
                for n, t in zip(op.outputs.get(slot, []), vals):
                    if n and t is not None:
                        env[n] = t
                        written.append(n)

        for n in dict.fromkeys(written):
            var = block.vars.get(n)
            if ((var is not None and var.persistable) or scope.has_var(n)) \
                    and not is_selected_rows(env[n]):
                scope.set_var(n, env[n])
        profiler.record_stage("pipeline.dispatch",
                              time.perf_counter() - t_dispatch)
        if emb_ticket is not None:
            # hand the step's evicted rows to the engine (no sync: they land
            # on the host once the step completes)
            emb_engine.note_dispatched(emb_ticket, scope)
        names = [v.name if isinstance(v, Variable) else str(v)
                 for v in (fetch_list or [])]
        missing = [n for n in names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not produced by "
                           f"the program or fed")
        fetches = [env[n] for n in names]
        if gathered:
            fetches = [_gathered_fetch(axis_env, gathered[n], block.var(n), t)
                       if n in gathered else t
                       for n, t in zip(names, fetches)]
        health = env.get(GUARD_HEALTH_NAME)
        if return_numpy:
            return [_to_numpy(t) for t in fetches], health
        return fetches, health

    def _under_mesh(self, compiled, program, feed_names):
        """(the program to run, the ring -> group binding or None, the
        fetch names to gather) for a CompiledProgram's regime."""
        from .ops.collective_ops import REWRITE_RING, SP_RING, TP_RING
        from .parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                    get_comm_context)

        mesh = compiled._mesh
        if compiled._spmd_mode == "shard_map":
            return program, get_comm_context().axis_env(mesh), {}, {}
        if mesh.size == 1:
            return program, None, {}, {}
        tp = mesh.shape.get(MODEL_AXIS, 1)
        sp = mesh.shape.get(SEQ_AXIS, 1)
        if DATA_AXIS not in mesh.axis_names and tp == 1 and sp == 1:
            raise NotImplementedError(
                f"with_data_parallel over mesh {mesh.shape} with none of the "
                f"'{DATA_AXIS}', '{MODEL_AXIS}' and '{SEQ_AXIS}' axes is not "
                f"ported yet (ROADMAP Queue 1, \"parallel and distributed\")")
        dp = mesh.group(DATA_AXIS) if DATA_AXIS in mesh.axis_names else None
        zero1 = bool(compiled._build_strategy.sharded_optimizer_states)
        key = (mesh.layout(), tuple(sorted(feed_names)), zero1)
        clones = self._dp_clones.setdefault(program, {})
        version = _program_version(program)
        if key not in clones or clones[key][0] != version:
            # first run, or the program was edited since its clone was made
            from .parallel.sharding import apply_zero1, data_parallel_rewrite
            from .parallel.spatial import sequence_parallel_rewrite
            from .parallel.tensor_parallel import tensor_parallel_rewrite

            if key in clones:
                self._prepared.pop(clones[key][1], None)
            clone, layouts, fetch, states = program, {}, {}, {}
            if tp > 1:
                clone, layouts, states = tensor_parallel_rewrite(
                    program, mesh.group(MODEL_AXIS), TP_RING)
                fetch = {n: [("tp", s)] for n, s in states.items()}
            if sp > 1:
                clone, sp_states = sequence_parallel_rewrite(
                    clone, mesh.group(SEQ_AXIS), SP_RING, feed_names,
                    in_place=tp > 1, tp_states=states, tp=tp)
                for n, s in sp_states.items():
                    fetch.setdefault(n, []).append(("sp", s))
            if dp is not None and dp.size > 1:
                clone, sharded = data_parallel_rewrite(
                    clone, dp.size, feed_names, REWRITE_RING,
                    in_place=tp > 1 or sp > 1)
                for n in sharded:
                    fetch.setdefault(n, []).append(("dp",))
                if zero1:
                    apply_zero1(clone, dp.size, ring_id=REWRITE_RING,
                                replicated_grads=True)
            clones[key] = (version, clone, (fetch, layouts))
        _, clone, (fetch, layouts) = clones[key]
        env = {}
        if dp is not None:
            env[REWRITE_RING] = dp
        if tp > 1:
            env[TP_RING] = mesh.group(MODEL_AXIS)
        if sp > 1:
            env[SP_RING] = mesh.group(SEQ_AXIS)
        return clone, env, fetch, layouts

    def _program_for(self, compiled):
        """The program whose vars describe the scope that `compiled` trains
        on this executor: its data-parallel clone past one rank (where
        ZeRO-1 keeps each rank's rows of the moments), else its program.
        A clone made for any feeds serves; with none made yet, the one a
        run feeding the program's data vars makes."""
        program = compiled._program
        mesh = compiled._mesh
        if mesh is None or compiled._spmd_mode == "shard_map" or \
                mesh.size == 1:
            return program
        zero1 = bool(compiled._build_strategy.sharded_optimizer_states)
        version = _program_version(program)
        for (layout, _, z), (ver, clone, _) in \
                self._dp_clones.get(program, {}).items():
            if layout == mesh.layout() and z == zero1 and ver == version:
                return clone
        feeds = [n for n, v in program.global_block.vars.items() if v.is_data]
        return self._under_mesh(compiled, program, feeds)[0]

    def set_step_guard(self, guard) -> None:
        """Attach a resilience.guardrails.StepGuard: every drained async
        step's health vector is handed to it; a bad-step-budget overrun
        surfaces as GuardRewind from run_async/wait (which
        train_from_dataset handles in place)."""
        self._step_guard = guard

    def invalidate_cache(self, program=None):
        """Forget that `program` (or every program) was prepared here, and
        its tuner decisions, with its data-parallel clones and theirs: its
        next run fires the `executor.compile` site again, rewrites its
        clone and resolves them anew. The resilience runner's second rung
        calls this (the JAX package drops the program's compiled
        executables)."""
        if program is None:
            self._prepared = weakref.WeakKeyDictionary()
            self._dp_clones = weakref.WeakKeyDictionary()
            return
        self._prepared.pop(program, None)
        for _, clone, _ in self._dp_clones.pop(program, {}).values():
            self._prepared.pop(clone, None)

    def run_async(self, program: Program | None = None,
                  feed: dict | None = None, fetch_list: Sequence | None = None,
                  scope: Scope | None = None, rng_counter: int | None = None):
        """Dispatch one step and return its fetches as device tensors, with
        no host sync (the JAX package's executor.py:537). The step's
        completion token is a CUDA event recorded after its last op (on the
        CPU the step is complete when `run` returns). Runahead is bounded:
        once more than FLAGS_max_inflight_steps tokens are pending the host
        waits on the OLDEST one — the only place the async trainer loop
        waits on the device."""
        from . import flags, profiler, tuning

        outs, health = self._run_impl(program, feed, fetch_list, scope,
                                      False, rng_counter)
        if self._step_guard is None:
            health = None
        elif health is not None and self.place.type == "cuda":
            # queued behind the step: read after its event, no sync here
            host = torch.empty(health.shape, dtype=health.dtype,
                               pin_memory=True)
            health = host.copy_(health, non_blocking=True)
        token = None
        if self.place.type == "cuda":
            token = torch.cuda.Event()
            token.record(torch.cuda.current_stream(self.place))
        self._dispatch_seq += 1
        if health is not None:
            # keep the batch until its (window-delayed) health verdict
            # lands: the blame replay needs the poisoned feed
            self._step_guard.note_dispatch(self._dispatch_seq, feed)
        self._inflight.append((self._dispatch_seq, token, health,
                               self._last_spmd_mode, time.perf_counter()))
        window = int(flags.get_flag("max_inflight_steps"))
        if window > 0:
            while len(self._inflight) > window:
                with profiler.stage_timer("pipeline.window_drain"):
                    self._drain_oldest()
        # bounded online exploration (FLAGS_tuning_mode=explore): the host
        # just drained to the runahead window, so the device has queued
        # work and the host an idle gap: probe at most one recorded
        # candidate every FLAGS_tuning_explore_every steps
        tuning.maybe_explore()
        return outs

    def wait(self):
        """Block until every run_async step dispatched so far has completed
        on the device (epoch boundary / before reading trained state).
        Bounded by the hang watchdog: a wedged step raises StallError with
        an in-flight state dump instead of blocking forever."""
        while self._inflight:
            self._drain_oldest()

    def _drain_oldest(self):
        """Wait for the OLDEST dispatched step's completion event under the
        resilience watchdog (FLAGS_watchdog_stall_s), polling its
        `query()`: no device progress within the window raises StallError
        carrying the step ids still in flight, the window depth and the
        per-stage profiler counters. The `pipeline_stall` fault site makes
        the step one that never completes, so the path is testable on a
        healthy device; on StallError the queue is left intact for
        forensics."""
        from . import flags
        from . import observability as obs
        from .resilience.faults import InjectedFault, fault_point
        from .resilience.watchdog import Watchdog, runtime_state

        step_id, token, health, spmd_mode, t_dispatch = self._inflight[0]
        stalled = False
        try:
            fault_point("pipeline_stall")
            if spmd_mode == "shard_map":
                # a collective step completes only when every rank's
                # collectives land: a lost partner wedges here
                fault_point("collective_stall")
        except InjectedFault:
            stalled = True  # behave as if the device never completes
        wd = Watchdog()
        if not stalled and (not wd.enabled or token is None):
            if token is not None:
                token.synchronize()
        else:
            def state():
                return runtime_state(
                    oldest_step=step_id,
                    inflight_step_ids=[e[0] for e in self._inflight],
                    inflight_depth=len(self._inflight),
                    spmd_mode=spmd_mode,
                    max_inflight_steps=int(
                        flags.get_flag("max_inflight_steps")))

            what = f"Executor async step {step_id}"
            if spmd_mode == "shard_map":
                what += " (collective allreduce)"
            wd.wait((lambda: False) if stalled else token.query, state,
                    what=what)
        self._inflight.popleft()
        # dispatch->completion latency, device queueing under the window
        # included: the number the async loop experiences at each drain
        obs.counter_inc("train.steps")
        obs.histogram_observe("train.step_latency_s",
                              time.perf_counter() - t_dispatch)
        if health is not None and self._step_guard is not None:
            # the event resolved above, so the 4 floats are on the host;
            # observe() may raise GuardRewind (budget exhausted)
            self._step_guard.observe(self, step_id, health.numpy())

    def drain_quiet(self):
        """Complete every in-flight step WITHOUT guard or watchdog policy:
        the rewind path discards the window dispatched after a poisoned
        step (their state writes are about to be overwritten by the
        checkpoint restore), so their health verdicts must not trigger the
        guard again."""
        while self._inflight:
            token = self._inflight.popleft()[1]
            if token is not None:
                token.synchronize()

    def train_from_dataset(self, program=None, dataset=None,
                           scope: Scope | None = None, thread: int = 0,
                           debug: bool = False, fetch_list=None,
                           fetch_info=None, print_period: int = 100,
                           guard=None):
        """Consume a Dataset end to end (the JAX package's executor.py:846;
        the reference's Executor::RunFromDataset): every batch is one `run`
        of `program`. The Dataset's host threads parse and assemble while
        the device steps. `thread` clamps the dataset's threads as the JAX
        package does: min(its thread_num, thread), or `thread` for a
        dataset left at one. `guard` (a resilience StepGuard) is attached
        for the run: a bad-step-budget overrun rewinds (checkpoint restore,
        LR backoff, blame replay) and the epoch continues past the
        poisoned batch."""
        if dataset is None:
            raise RuntimeError("dataset is need and should be initialized")
        if scope is None:
            raise ValueError("train_from_dataset needs an explicit scope")
        if guard is not None:
            self.set_step_guard(guard)
        if thread:
            dataset.set_thread(min(dataset.thread_num, thread)
                               if dataset.thread_num > 1 else thread)
        dataset._prepare_to_run()
        try:
            self._run_from_dataset(program, dataset, scope, debug,
                                   fetch_list, fetch_info, print_period)
        finally:
            dataset._finish_to_run()

    def infer_from_dataset(self, program=None, dataset=None,
                           scope: Scope | None = None, thread: int = 0,
                           debug: bool = False, fetch_list=None,
                           fetch_info=None, print_period: int = 100):
        """The same loop (executor.py:894); the program has no optimizer
        ops, so nothing updates."""
        self.train_from_dataset(program, dataset, scope, thread, debug,
                                fetch_list, fetch_info, print_period)

    def _run_from_dataset(self, program, dataset, scope, debug, fetch_list,
                          fetch_info, print_period):
        """The trainer loop: batches come through the DeviceLoader (their
        copies on a side stream, ahead of the step; a tiered program's ids
        resolved on its thread) when FLAGS_device_prefetch_depth > 0; each
        step is `run_async`, its fetches left on the device, so the host
        waits on the device at the window's bound and at a print period,
        where the fetched values are read. The throughput window opens
        after the first batch; each print period sets the
        train.batches_per_sec gauge."""
        from . import flags, profiler
        from . import observability as obs
        from .pipeline import DeviceLoader

        fetch_list = fetch_list or []
        names = [v.name if isinstance(v, Variable) else str(v)
                 for v in fetch_list]
        if fetch_info is not None and len(fetch_info) != len(names):
            raise ValueError(
                f"fetch_info has {len(fetch_info)} entries for "
                f"{len(names)} fetch_list variables")
        labels = list(fetch_info or names)
        depth = int(flags.get_flag("device_prefetch_depth"))
        if depth > 0:
            batches = iter(DeviceLoader(dataset._iter_batches, depth=depth,
                                        placement=self.feed_placer(program)))
        else:
            batches = dataset._iter_batches()
        from .resilience.guardrails import GuardRewind

        def drain():
            # a bad step at the window's tail can trip the guard here too:
            # rewind, and drain what is left
            while True:
                try:
                    self.wait()
                    break
                except GuardRewind as gr:
                    self._rewind(gr)
            self._wait()

        t0 = None
        n_batches = 0
        try:
            for feed in batches:
                try:
                    outs = self.run_async(program, feed=feed,
                                          fetch_list=names, scope=scope)
                except GuardRewind as gr:
                    # the data cursor has already moved past the poisoned
                    # batch, which is the skip wanted
                    self._rewind(gr)
                    continue
                except (ValueError, TypeError) as e:
                    # a corrupt record dies in the feed's conversion,
                    # before any op ran (state untouched)
                    if not flags.get_flag("feed_skip_corrupt"):
                        raise
                    profiler.bump("feed.skip_corrupt")
                    print(f"[executor] skipping corrupt batch "
                          f"(FLAGS_feed_skip_corrupt): {e}", flush=True)
                    continue
                n_batches += 1
                if n_batches == 1:
                    drain()
                    t0 = time.perf_counter()
                    continue
                if (debug or names) and n_batches % print_period == 0:
                    msg = ", ".join(
                        f"{lbl}: {_to_numpy(o).reshape(-1)[:8]}"
                        for lbl, o in zip(labels, outs))
                    dt = time.perf_counter() - t0
                    rate = (n_batches - 1) / dt if dt > 0 else float("inf")
                    if rate != float("inf"):
                        obs.gauge_set("train.batches_per_sec", rate)
                    print(f"batch {n_batches} ({rate:.1f} batch/s) {msg}",
                          flush=True)
        finally:
            if hasattr(batches, "close"):
                batches.close()
            # epoch boundary: drain the window so trained state is final
            drain()

    def _rewind(self, gr):
        """A StepGuard budget overrun inside train_from_dataset: restore,
        back off the LR, replay for blame; without a guard, re-raise."""
        if self._step_guard is None:
            raise gr
        self._step_guard.rewind(self, gr)

    def _wait(self):
        """Wait for the device's queued work (nothing to wait for on the
        CPU)."""
        if self.place.type == "cuda":
            torch.cuda.synchronize(self.place)

    def feed_placer(self, program=None):
        """The DeviceLoader's placement for `program`: cast each host array
        to its var's feed dtype (the cast `run` applies; a bfloat16 var's
        feed stays float32 and `run` casts it on the device) and stage it
        on this executor's device. For a tiered program the batch's ids
        are resolved first, on the loader's thread (the async miss
        prefetch): the derived slot and prefetch feeds are staged with the
        batch, and the ticket passes through unstaged."""
        from .pipeline.device_loader import placement

        program = program or default_main_program()
        block = program.global_block

        def dtype_of(name):
            var = block.vars.get(name)
            if var is None or var.dtype is DType.BF16:
                return None
            return var.np_feed_dtype

        engine = getattr(program, "_tiered_engine", None)
        if engine is None:
            return placement(dtype_of, self.place)
        from .embedding.engine import TICKET_KEY

        place = placement(dtype_of, self.place, passthrough=(TICKET_KEY,))

        def resolve_and_place(feed: dict):
            if TICKET_KEY not in feed:
                feed = engine.resolve_feed(feed)
            return place(feed)

        return resolve_and_place
