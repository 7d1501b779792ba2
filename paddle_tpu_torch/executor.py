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
step is dispatched.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from .core.selected_rows import SelectedRows, is_selected_rows
from .core.types import DType
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


class Executor:
    """run(program, feed, fetch_list, scope) on one device."""

    def __init__(self, place=None):
        self.place = resolve_device(place)
        # run_async's window: (step id, completion event or None, dispatch
        # time) per dispatched, undrained step, oldest first
        self._inflight: collections.deque = collections.deque()
        self._dispatch_seq = 0

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
        from . import profiler

        program = program or default_main_program()
        if scope is None:
            raise ValueError("Executor.run needs an explicit scope")
        # tiered embeddings (embedding/engine.py): a feed the DeviceLoader's
        # thread resolved carries its ticket (popped here: it is no feed of
        # the program); a raw feed resolves inline
        emb_engine = getattr(program, "_tiered_engine", None)
        emb_ticket = None
        if emb_engine is not None and feed:
            feed, emb_ticket = emb_engine.prepare_feed(dict(feed))
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
                              stash, program)
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
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return fetches

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
        from . import flags, profiler

        outs = self.run(program, feed, fetch_list, scope, return_numpy=False,
                        rng_counter=rng_counter)
        token = None
        if self.place.type == "cuda":
            token = torch.cuda.Event()
            token.record(torch.cuda.current_stream(self.place))
        self._dispatch_seq += 1
        self._inflight.append((self._dispatch_seq, token, time.perf_counter()))
        window = int(flags.get_flag("max_inflight_steps"))
        if window > 0:
            while len(self._inflight) > window:
                with profiler.stage_timer("pipeline.window_drain"):
                    self._drain_oldest()
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

        step_id, token, t_dispatch = self._inflight[0]
        stalled = False
        try:
            fault_point("pipeline_stall")
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
                    max_inflight_steps=int(
                        flags.get_flag("max_inflight_steps")))

            wd.wait((lambda: False) if stalled else token.query, state,
                    what=f"Executor async step {step_id}")
        self._inflight.popleft()
        # dispatch->completion latency, device queueing under the window
        # included: the number the async loop experiences at each drain
        obs.counter_inc("train.steps")
        obs.histogram_observe("train.step_latency_s",
                              time.perf_counter() - t_dispatch)

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
        dataset left at one. `guard` (a resilience StepGuard) is not
        ported and raises."""
        if dataset is None:
            raise RuntimeError("dataset is need and should be initialized")
        if guard is not None:
            raise NotImplementedError(
                "train_from_dataset(guard=...) needs the resilience "
                "StepGuard, not ported yet (ROADMAP Queue 1, the guardrails "
                "and the runner)")
        if scope is None:
            raise ValueError("train_from_dataset needs an explicit scope")
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
        after the first batch."""
        from . import flags, profiler
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
        t0 = None
        n_batches = 0
        try:
            for feed in batches:
                try:
                    outs = self.run_async(program, feed=feed,
                                          fetch_list=names, scope=scope)
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
                    self.wait()
                    self._wait()
                    t0 = time.perf_counter()
                    continue
                if (debug or names) and n_batches % print_period == 0:
                    msg = ", ".join(
                        f"{lbl}: {_to_numpy(o).reshape(-1)[:8]}"
                        for lbl, o in zip(labels, outs))
                    dt = time.perf_counter() - t0
                    rate = (n_batches - 1) / dt if dt > 0 else float("inf")
                    print(f"batch {n_batches} ({rate:.1f} batch/s) {msg}",
                          flush=True)
        finally:
            if hasattr(batches, "close"):
                batches.close()
            # epoch boundary: drain the window so trained state is final
            self.wait()
            self._wait()

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
