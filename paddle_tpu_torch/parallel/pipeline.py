"""Pipeline parallelism: the stage split and the host-driven microbatch
schedule (the JAX package's parallel/pipeline.py, built on the port's
executor).

The program is cut into stages at the user's boundary variables (the
reference's cut_list). Each stage gets
  * a forward program (the stage's ops; its boundary outputs are fetched),
  * a backward program (the stage's ops replayed, then `gradients()`'s grad
    ops: a rematerialised backward, which trades the stage's forward FLOPs
    for the activations a stashed backward would keep),
  * an update program (the wrapped optimizer's ops over the accumulated
    gradients).
`PipelinePlan.run_step` runs every microbatch forward and backward through
them, sums each parameter's gradients over the microbatches and takes one
optimizer step on their mean: the large-batch step when the loss is a mean
of equal-size microbatch means.

Schedules: "gpipe" (every forward, then every backward, in clock-cycle
order: cycle t runs stage s on microbatch t - s; the boundary stash grows
with the microbatches) and "1f1b" (PipeDream-flush: stage s runs
S - 1 - s warm-up forwards, then alternates one forward and one backward,
so at most about S microbatches are in flight and each one's stash is
freed when its backward ends). Both give the same bits: the same
per-microbatch gradients, summed in microbatch order, and one step.

Placement (`devices=`): one torch device a stage, from CUDAPlace /
CPUPlace, an int ordinal (a CUDA card), a device name or a torch.device.
Each stage runs on an executor of its device, its state (parameters,
statistics, optimizer accumulators) is moved there once, and boundary
tensors move device to device (`.to(dev, non_blocking=True)`, never through
the host). Without `devices` every stage runs on the caller's executor.

Random draws: the backward replays the stage's forward ops, and both runs
take the same `rng_counter` of `Executor.run`, (1 << 30) + step S M +
s M + m, so the replay's dropout masks are the forward's bit for bit. The
replay writes the persistable non-parameter vars it would update (a batch
norm's running statistics) to throwaway names, so it moves no state a
second time.
"""
from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from ..framework import (Parameter, Program, Variable,
                         default_startup_program, grad_var_name,
                         program_guard)

__all__ = ["PipelinePlan", "build_pipeline_plan", "bubble_fraction",
           "resolve_devices"]


def bubble_fraction(n_stages: int, num_microbatches: int) -> float:
    """The analytic share of each stage's schedule spent idle in fill and
    drain, (S-1)/(M+S-1), the same for GPipe and 1F1B (1F1B's gain is the
    bounded stash, not fewer bubbles); `PipelinePlan.last_bubble` holds the
    measured counterpart after a step."""
    s, m = int(n_stages), int(num_microbatches)
    if s <= 1:
        return 0.0
    return (s - 1) / (m + s - 1)


_GRAD_IN_SUFFIX = "@GRAD@IN"  # feed var carrying the next stage's cotangent


def _producer_index(block, name: str) -> int:
    last = -1
    for i, op in enumerate(block.ops):
        if name in op.output_names:
            last = i
    return last


def _copy_var(dst_block, src_var: Variable, as_feed: bool = False) -> Variable:
    if src_var.name in dst_block.vars:
        return dst_block.vars[src_var.name]
    if isinstance(src_var, Parameter):
        p = Parameter(
            dst_block, src_var.shape, src_var.dtype, name=src_var.name,
            trainable=src_var.trainable,
            regularizer=src_var.regularizer,
            gradient_clip_attr=src_var.gradient_clip_attr,
            do_model_average=src_var.do_model_average,
            optimize_attr=dict(src_var.optimize_attr or {}),
        )
        p.sharding = src_var.sharding
        dst_block.vars[p.name] = p
        return p
    return dst_block.create_var(
        name=src_var.name,
        shape=src_var.shape,
        dtype=src_var.dtype,
        persistable=src_var.persistable,
        stop_gradient=src_var.stop_gradient and not as_feed,
        is_data=as_feed or src_var.is_data,
        sharding=src_var.sharding,
    )


def _replay_ops(src_block, indices, dst_prog: Program, feed_names: set,
                shield_state: bool = False):
    """Copy the ops at `indices` (and their vars) into dst_prog's block 0.
    With shield_state=True (the backward replay) a write to a persistable
    non-parameter var (a batch norm's running statistics, a counter) goes
    to a throwaway name instead, so the replay moves no state a second
    time; later reads in the replay see the renamed value."""
    dst = dst_prog.global_block
    renames: dict[str, str] = {}
    for i in indices:
        op = src_block.ops[i]
        if "sub_block" in op.attrs:
            raise NotImplementedError(
                "pipeline stages containing control-flow sub-blocks are not "
                "supported yet; place While/StaticRNN fully inside one stage "
                "program built without cuts")
        inputs = {s: [renames.get(n, n) for n in ns]
                  for s, ns in op.inputs.items()}
        for n in op.input_names:
            if n and src_block.has_var(n):
                _copy_var(dst, src_block.var(n), as_feed=n in feed_names)
        outputs = {s: list(ns) for s, ns in op.outputs.items()}
        for ns in outputs.values():
            for j, n in enumerate(ns):
                if not n or not src_block.has_var(n):
                    continue
                v = src_block.var(n)
                if (shield_state and v.persistable
                        and not isinstance(v, Parameter)):
                    tmp = renames.get(n) or (n + "@PIPE_SHIELD")
                    renames[n] = tmp
                    dst.create_var(name=tmp, shape=v.shape, dtype=v.dtype)
                    ns[j] = tmp
                else:
                    _copy_var(dst, v)
        nop = dst.append_op(op.type, inputs, outputs, copy.deepcopy(op.attrs))
        nop._callstack = op._callstack


class _Stage:
    def __init__(self, idx: int):
        self.idx = idx
        self.fwd: Program | None = None
        self.bwd: Program | None = None
        self.update: Program | None = None
        self.ext_inputs: list[str] = []   # runtime feeds: user data + cut-ins
        self.out_names: list[str] = []    # boundary outputs consumed later
        self.param_names: list[str] = []
        self.in_grad_names: dict[str, str] = {}   # ext input -> its @GRAD
        self.param_grad_names: dict[str, str] = {}  # param -> its @GRAD
        self.update_feed: dict[str, str] = {}     # param -> update's grad feed


def resolve_devices(place_list, n_stages: int):
    """One torch.device a stage from a reference-style place_list, or None
    (every stage on the caller's executor). Entries: a torch.device, a
    device name, CUDAPlace / CPUPlace, or an int (a CUDA ordinal); anything
    else raises rather than guess (a silent default would put every stage
    on one device)."""
    from ..executor import CPUPlace, CUDAPlace, resolve_device

    if place_list is None:
        return None
    if len(place_list) != n_stages:
        raise ValueError(
            f"place_list has {len(place_list)} entries for {n_stages} "
            "pipeline stages (one device per stage)")
    out = []
    for p in place_list:
        if isinstance(p, (torch.device, str, CPUPlace, CUDAPlace)):
            out.append(resolve_device(p))
        elif isinstance(p, (int, np.integer)) and not isinstance(p, bool):
            out.append(resolve_device(torch.device("cuda", int(p))))
        else:
            raise TypeError(
                f"place_list entry {p!r} is not a torch.device, a device "
                "name, an int CUDA ordinal, CPUPlace or CUDAPlace; refusing "
                "to guess (a silent default would collapse stages onto one "
                "device)")
    return out


def build_pipeline_plan(program: Program, loss: Variable, cut_vars,
                        inner_opt, num_microbatches: int,
                        startup_program: Program | None = None,
                        devices=None, schedule: str | None = None, mesh=None):
    """Split `program` (forward only) at `cut_vars` into a PipelinePlan.
    schedule: "1f1b" or "gpipe"; None takes FLAGS_pipeline_schedule."""
    from ..backward import gradients

    if mesh is not None:
        raise NotImplementedError(
            "a pipeline over a tensor-parallel mesh (mesh=) is not ported "
            "yet (ROADMAP Queue 1, \"parallel and distributed\")")
    if schedule is None:
        from .. import flags

        schedule = str(flags.get_flag("pipeline_schedule")).strip().lower()
    if num_microbatches < 1:
        raise ValueError("num_microbatches must be >= 1")
    block = program.global_block
    startup = startup_program or default_startup_program()

    bounds = []
    for v in cut_vars:
        pos = _producer_index(block, v.name)
        if pos < 0:
            raise ValueError(f"cut var '{v.name}' is not produced by any op")
        bounds.append(pos)
    if bounds != sorted(bounds):
        raise ValueError("cut_list variables must be in program order")
    loss_pos = _producer_index(block, loss.name)
    if bounds and loss_pos <= bounds[-1]:
        raise ValueError("the loss must be produced after the last cut")

    n_stages = len(bounds) + 1
    ranges = []
    lo = 0
    for b in bounds:
        ranges.append(list(range(lo, b + 1)))
        lo = b + 1
    ranges.append(list(range(lo, len(block.ops))))

    producer_stage: dict[str, int] = {}
    for s, idxs in enumerate(ranges):
        for i in idxs:
            for n in block.ops[i].output_names:
                if n:
                    producer_stage[n] = s

    stages = [_Stage(s) for s in range(n_stages)]
    params = {p.name for p in program.all_parameters()}

    # a stage's external inputs: any var an earlier stage produces (the
    # cut_list fixes only where the cuts fall) and the data feeds it reads
    for s, idxs in enumerate(ranges):
        defined: set[str] = set()
        ext: list[str] = []
        for i in idxs:
            op = block.ops[i]
            for n in op.input_names:
                if not n or n in defined or n in ext:
                    continue
                try:
                    v = block.var(n)
                except KeyError:
                    continue
                if v.persistable:
                    continue  # parameters and state come from the scope
                ps = producer_stage.get(n)
                if ps is not None and ps == s:
                    continue
                if ps is not None and ps < s:
                    ext.append(n)
                    if n not in stages[ps].out_names:
                        stages[ps].out_names.append(n)
                elif v.is_data:
                    ext.append(n)
            defined.update(n for n in op.output_names if n)
        stages[s].ext_inputs = ext
        stages[s].param_names = sorted(
            {n for i in idxs for n in block.ops[i].input_names if n in params})

    for s, stage in enumerate(stages):
        is_last = s == n_stages - 1
        feed_set = set(stage.ext_inputs)

        stage.fwd = Program()
        stage.fwd.random_seed = program.random_seed
        _replay_ops(block, ranges[s], stage.fwd, feed_set)

        stage.bwd = Program()
        stage.bwd.random_seed = program.random_seed
        _replay_ops(block, ranges[s], stage.bwd, feed_set, shield_state=True)
        bblock = stage.bwd.global_block
        with program_guard(stage.bwd, startup):
            if is_last:
                targets = [bblock.var(loss.name)]
                tgs = None
            else:
                targets, tgs = [], []
                for n in stage.out_names:
                    ov = bblock.var(n)
                    targets.append(ov)
                    tgs.append(bblock.create_var(
                        name=n + _GRAD_IN_SUFFIX, shape=ov.shape,
                        dtype=ov.dtype, is_data=True, stop_gradient=True))
            wrt = [bblock.var(n) for n in stage.ext_inputs
                   if _is_float(bblock.var(n))]
            wrt += [bblock.var(p) for p in stage.param_names]
            grads = gradients(targets, wrt, target_gradients=tgs)
        for v, g in zip(wrt, grads):
            if g is None:
                continue
            if v.name in params:
                stage.param_grad_names[v.name] = g.name
            else:
                stage.in_grad_names[v.name] = g.name

    # update programs: a parameter read by several stages (tied weights)
    # gets one update, from the gradient summed over all of them
    claimed: set[str] = set()
    for stage in stages:
        todo = [p for p in stage.param_names
                if p in stage.param_grad_names and p not in claimed]
        if not todo:
            continue
        claimed.update(todo)
        opt = copy.deepcopy(inner_opt)
        stage.update = Program()
        stage.update.random_seed = program.random_seed
        ublock = stage.update.global_block
        with program_guard(stage.update, startup):
            pairs = []
            for p in todo:
                pv = _copy_var(ublock, block.var(p))
                gname = grad_var_name(p)
                gv = ublock.create_var(
                    name=gname, shape=pv.shape, dtype=pv.dtype,
                    is_data=True, stop_gradient=True)
                stage.update_feed[p] = gname
                pairs.append((pv, gv))
            opt.apply_gradients(pairs)

    return PipelinePlan(stages, loss.name, num_microbatches,
                        devices=resolve_devices(devices, n_stages),
                        schedule=schedule)


def _is_float(v: Variable) -> bool:
    from ..core.types import is_floating

    return is_floating(v.dtype)


def _split(val, M: int, name: str):
    """`val` (a host array or a tensor) in M equal row blocks."""
    rows = val.shape[0]
    if rows % M != 0:
        raise ValueError(f"feed '{name}' batch {rows} is not divisible by "
                         f"num_microbatches={M}")
    if isinstance(val, torch.Tensor):
        return list(torch.chunk(val, M))
    return np.split(np.asarray(val), M)


class PipelinePlan:
    """The executable schedule over the stage programs (the reference's
    PipelineTrainer / SectionWorker, driven from the host)."""

    def __init__(self, stages: list[_Stage], loss_name: str,
                 num_microbatches: int, devices=None,
                 schedule: str = "1f1b"):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline schedule '{schedule}'")
        self.stages = stages
        self.loss_name = loss_name
        self.num_microbatches = num_microbatches
        self.devices = devices
        self.schedule = schedule
        # the last step's dispatch order, [("f" | "b", stage, microbatch)]
        self.last_dispatch: list[tuple] = []
        # the most microbatches whose boundary stash was live at once in
        # the last step: at most S + 1 under 1F1B, M under GPipe
        self.last_peak_stash: int = 0
        # the last step's bubble accounting: each stage's stalled rounds
        # beside the analytic (S-1)/(M+S-1)
        self.last_bubble: dict = {}
        self._step_counter = 0
        self._executors: dict = {}
        if devices is not None:
            self._check_no_cross_stage_params()

    def _check_no_cross_stage_params(self):
        owner: dict[str, int] = {}
        for s, stage in enumerate(self.stages):
            for p in stage.param_names:
                if p in owner:
                    raise NotImplementedError(
                        f"parameter '{p}' is read by pipeline stages "
                        f"{owner[p]} and {s}; tied weights across "
                        "device-placed stages are not supported (each "
                        "parameter must live on exactly one stage device)")
                owner[p] = s

    def _executor(self, exe, s: int):
        """Stage s's executor: the caller's, or one of its stage's device."""
        if self.devices is None or self.devices[s] == exe.place:
            return exe
        dev = self.devices[s]
        if dev not in self._executors:
            from ..executor import Executor

            self._executors[dev] = Executor(place=dev)
        return self._executors[dev]

    @staticmethod
    def _to_dev(v, dev):
        if dev is None or not isinstance(v, torch.Tensor) or v.device == dev:
            return v
        return v.to(dev, non_blocking=True)

    def _place_stage_state(self, scope):
        """Move each stage's scope state (everything its programs read or
        write) to the stage's device; after the first step it is there."""
        if not hasattr(self, "_stage_state_names"):
            self._stage_state_names = []
            for stage in self.stages:
                names: set[str] = set()
                for prog in (stage.fwd, stage.bwd, stage.update):
                    if prog is None:
                        continue
                    for op in prog.global_block.ops:
                        names.update(n for n in op.input_names if n)
                        names.update(n for n in op.output_names if n)
                self._stage_state_names.append(sorted(names))
        for names, dev in zip(self._stage_state_names, self.devices):
            for n in names:
                v = scope.find_var(n) if scope.has_var(n) else None
                if isinstance(v, torch.Tensor) and v.device != dev:
                    scope.set_var(n, v.to(dev))

    def run_step(self, exe, scope, feed: dict, fetch_names: list[str],
                 return_numpy: bool = True):
        """One pipelined step of the program on the global batch `feed`:
        the fetches, batch-dim fetches (leading dim -1) joined over the
        microbatches and the rest (the loss, metrics) averaged."""
        M = self.num_microbatches
        micro_feeds: list[dict[str, Any]] = [dict() for _ in range(M)]
        for name, val in feed.items():
            for m, chunk in enumerate(_split(val, M, name)):
                micro_feeds[m][name] = chunk

        # a fetch comes from the first stage whose forward produces it, else
        # the first that holds it
        fetch_stage: dict[str, int] = {}
        for name in fetch_names:
            holder = None
            for s, stage in enumerate(self.stages):
                blk = stage.fwd.global_block
                if not blk.has_var(name):
                    continue
                if holder is None:
                    holder = s
                if any(name in op.output_names for op in blk.ops):
                    fetch_stage[name] = s
                    break
            if name not in fetch_stage:
                if holder is None:
                    raise KeyError(
                        f"fetch '{name}' not found in any pipeline stage")
                fetch_stage[name] = holder

        S = len(self.stages)
        devs = self.devices or [None] * S
        if self.devices is not None:
            self._place_stage_state(scope)
        self.last_dispatch = []
        self.last_peak_stash = 0
        # the forward and the backward replay of (stage, microbatch) share
        # one random key, so the replay draws the forward's masks; 2^30
        # keeps the keys apart from the scope's own run counters
        self._step_counter += 1
        base = (1 << 30) + self._step_counter * S * M

        def _rng(s, m):
            return base + s * M + m

        # a boundary var's stash entry is last read by the backward of its
        # lowest consumer stage: it is freed there
        free_at: dict[str, int] = {}
        for s, stage in enumerate(self.stages):
            for n in stage.ext_inputs:
                if any(n in st.out_names for st in self.stages[:s]):
                    free_at[n] = min(free_at.get(n, S), s)

        def _note_peak(stash):
            live = sum(1 for d in stash if d)
            self.last_peak_stash = max(self.last_peak_stash, live)

        # boundary shapes and dtypes at forward time: the backward's zero
        # cotangent needs them after a lower consumer freed the entry
        like: dict[str, tuple] = {}

        def _feeds(s, m, stash):
            stage = self.stages[s]
            f = {n: micro_feeds[m][n] for n in stage.ext_inputs
                 if n in micro_feeds[m]}
            f.update({n: self._to_dev(stash[m][n], devs[s])
                      for n in stage.ext_inputs if n in stash[m]})
            return f

        def _fwd_one(s, m, stash, fetched):
            stage = self.stages[s]
            wanted = list(stage.out_names) + [
                n for n in fetch_names
                if fetch_stage[n] == s and n not in stage.out_names]
            f = _feeds(s, m, stash)
            missing = [n for n in stage.ext_inputs if n not in f]
            if missing:
                raise KeyError(f"pipeline stage {s} needs feeds {missing}")
            outs = self._executor(exe, s).run(
                stage.fwd, feed=f, fetch_list=wanted, scope=scope,
                return_numpy=False, rng_counter=_rng(s, m))
            self.last_dispatch.append(("f", s, m))
            for n, v in zip(wanted, outs):
                if n in stage.out_names:
                    stash[m][n] = v
                    like[n] = (tuple(v.shape), v.dtype)
                if n in fetched:
                    fetched[n].append(v)
            _note_peak(stash)

        def _bwd_one(s, m, stash, grad_stash, grad_acc):
            stage = self.stages[s]
            pg_names = sorted(stage.param_grad_names.items())
            ig_names = sorted(stage.in_grad_names.items())
            wanted = [g for _, g in pg_names] + [g for _, g in ig_names]
            if not wanted:
                return
            run = self._executor(exe, s)
            f = _feeds(s, m, stash)
            for n in stage.out_names:
                g = grad_stash[m].get(n)
                if g is None:
                    shape, dtype = like[n]
                    g = torch.zeros(shape, dtype=dtype, device=run.place)
                f[n + _GRAD_IN_SUFFIX] = self._to_dev(g, devs[s])
            outs = run.run(stage.bwd, feed=f, fetch_list=wanted, scope=scope,
                           return_numpy=False, rng_counter=_rng(s, m))
            self.last_dispatch.append(("b", s, m))
            for (p, _), v in zip(pg_names, outs[:len(pg_names)]):
                prev = grad_acc.get(p)
                grad_acc[p] = v if prev is None else prev + self._to_dev(
                    v, prev.device)
            for (n, _), v in zip(ig_names, outs[len(pg_names):]):
                prev = grad_stash[m].get(n)
                grad_stash[m][n] = v if prev is None else prev + self._to_dev(
                    v, prev.device)
            # this backward was the last reader of m's inputs at this stage
            # and of m's cotangents of this stage's outputs
            for n in [n for n, fs in free_at.items() if fs == s]:
                stash[m].pop(n, None)
            for n in stage.out_names:
                grad_stash[m].pop(n, None)

        stash: list[dict[str, Any]] = [dict() for _ in range(M)]
        fetched: dict[str, list] = {n: [] for n in fetch_names}
        grad_acc: dict[str, Any] = {}
        grad_stash: list[dict[str, Any]] = [dict() for _ in range(M)]

        stalls = [0] * S
        rounds = 0
        if self.schedule == "gpipe":
            # forward: cycle t runs stage s on microbatch t - s
            for t in range(S + M - 1):
                rounds += 1
                for s in range(S):
                    m = t - s
                    if 0 <= m < M:
                        _fwd_one(s, m, stash, fetched)
                    else:
                        stalls[s] += 1  # a fill or drain slot
            # backward: the last stage leads; stage s runs microbatch m at
            # cycle (S-1-s) + m, after every consumer of its outputs
            for t in range(S + M - 1):
                rounds += 1
                for s in range(S - 1, -1, -1):
                    m = t - (S - 1 - s)
                    if 0 <= m < M:
                        _bwd_one(s, m, stash, grad_stash, grad_acc)
                    else:
                        stalls[s] += 1
        else:
            # 1F1B: min(S-1-s, M) warm-up forwards, then one forward and one
            # backward in turn, then the drain; each round every stage runs
            # at most one op whose dependencies are met: fwd(s, m) after
            # fwd(s-1, m), bwd(s, m) after fwd(s, m) and bwd(s+1, m)
            local: list[list[str]] = []
            for s in range(S):
                w = min(S - 1 - s, M)
                local.append(["f"] * w + ["f", "b"] * (M - w) + ["b"] * w)
            pc = [0] * S
            fcnt = [0] * S
            bcnt = [0] * S
            fwd_done = [[False] * M for _ in range(S)]
            bwd_done = [[False] * M for _ in range(S)]
            while any(pc[s] < len(local[s]) for s in range(S)):
                rounds += 1
                progressed = False
                for s in range(S):
                    if pc[s] >= len(local[s]):
                        continue
                    if local[s][pc[s]] == "f":
                        m = fcnt[s]
                        if s > 0 and not fwd_done[s - 1][m]:
                            stalls[s] += 1  # a warm-up or dependency stall
                            continue
                        _fwd_one(s, m, stash, fetched)
                        fwd_done[s][m] = True
                        fcnt[s] += 1
                    else:
                        m = bcnt[s]
                        if not fwd_done[s][m] or (
                                s < S - 1 and not bwd_done[s + 1][m]):
                            stalls[s] += 1  # a drain or cotangent stall
                            continue
                        _bwd_one(s, m, stash, grad_stash, grad_acc)
                        bwd_done[s][m] = True
                        bcnt[s] += 1
                    pc[s] += 1
                    progressed = True
                if not progressed:
                    raise RuntimeError(
                        "1F1B schedule deadlocked — dependency bug")
        total_slots = max(1, rounds * S)
        self.last_bubble = {
            "schedule": self.schedule,
            "n_stages": S,
            "num_microbatches": M,
            "analytic_frac": round(bubble_fraction(S, M), 4),
            "rounds": rounds,
            "stall_rounds_per_stage": list(stalls),
            "observed_frac": round(sum(stalls) / total_slots, 4),
            "peak_stash": self.last_peak_stash,
        }

        # one optimizer step on the microbatches' mean gradient
        inv = 1.0 / M
        for stage in self.stages:
            if stage.update is None or not stage.update_feed:
                continue
            f = {g: grad_acc[p] * inv for p, g in stage.update_feed.items()}
            self._executor(exe, stage.idx).run(stage.update, feed=f,
                                               scope=scope)

        # batch-dim fetches (declared leading dim -1) join over the
        # microbatches; the others (the loss, metrics) average
        results = []
        for n in fetch_names:
            vals = fetched[n]
            dev = vals[0].device
            vals = [self._to_dev(v, dev) for v in vals]
            var = self.stages[fetch_stage[n]].fwd.global_block.var(n)
            if var.shape and var.shape[0] == -1:
                results.append(torch.cat(vals, dim=0))
            else:
                results.append(torch.stack(vals).mean(dim=0))
        if return_numpy:
            from ..executor import _to_numpy

            return [_to_numpy(t) for t in results]
        return results
