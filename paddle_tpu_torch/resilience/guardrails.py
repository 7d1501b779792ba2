"""Numeric guardrails (the JAX package's resilience/guardrails.py): the
health sentinel appended to the program, the StepGuard skip / rewind policy
and the op-level blame replay.

One NaN or Inf (a corrupt batch, an fp16 overflow, a learning rate too hot)
silently poisons the optimizer state of a long run. The guard is appended
to the program, not bolted onto user code:

  * `health_sentinel` op (ops/optimizer_ops.py), appended by
    Optimizer.apply_gradients under FLAGS_guard_numerics: computes
    [loss, global_grad_norm, nonfinite, bad] on the device inside the step
    and zeroes every gradient on a bad step (a branchless skip: the AMP
    found_inf mechanism generalized to fp32; both share one verdict when
    composed). The vector lands in the persistable @GUARD_HEALTH@ var;
    Executor.run_async copies it to pinned host memory behind the step and
    reads it after the step's completion event, so health is observable
    every step with no host sync in the dispatch.

  * `StepGuard`, the host-side policy. Executor.run_async hands it each
    drained step's health. The recovery ladder:

      skip      in-graph, always: a bad step's update never lands
      rewind    after FLAGS_guard_bad_step_budget CONSECUTIVE bad steps,
                restore the newest good checkpoint (CheckpointManager)
      backoff   multiply the LR by FLAGS_guard_lr_backoff on each rewind
      surface   after FLAGS_guard_max_rewinds rewinds, raise GuardError

  * blame isolation: after a rewind, `replay_blame` runs the offending step
    again under FLAGS_check_nan_inf on a scratch copy of the restored
    scope: the first op producing a non-finite output is named with its
    creation stack, giving an op/var/batch-attributed report that is
    recorded as a guard event and never touches live training state. The
    JAX replay copies the scope shallowly, since jax arrays are immutable;
    the port's ops write some state in place (`increment`, the sparse and
    tiered updates), so the scratch scope holds clones.

Every event (step, reason, action, detail) is mirrored into
CheckpointManager.record_guard_event, so post-mortems survive restarts.
The port has no global scope: a guard's program and scope default to its
CheckpointManager's.
"""
from __future__ import annotations

import collections
import warnings

import numpy as np
import torch

from .. import flags

__all__ = [
    "GUARD_HEALTH_NAME", "GUARD_STATE_NAME",
    "H_LOSS", "H_GNORM", "H_NONFINITE", "H_BAD",
    "GuardError", "GuardRewind", "StepGuard",
    "append_health_sentinel", "enabled", "replay_blame",
]

# the sentinel's program-level contract (AMP-style reserved names): the op
# writes the health vector here and the executor looks it up by name
GUARD_HEALTH_NAME = "@GUARD_HEALTH@"
GUARD_STATE_NAME = "@GUARD_STATE@"

# health vector layout (ops/optimizer_ops.py health_sentinel)
H_LOSS, H_GNORM, H_NONFINITE, H_BAD = 0, 1, 2, 3


def enabled() -> bool:
    return bool(flags.get_flag("guard_numerics"))


def append_health_sentinel(params_grads, loss_name: str | None = None):
    """Program transformation: route every gradient through one
    `health_sentinel` op (called by Optimizer.apply_gradients after clip and
    regularization, so a NaN that clip smeared over all grads is still
    caught). Returns params_grads rebuilt over the gated gradients."""
    from ..framework import default_main_program
    from ..initializer import Constant
    from ..layer_helper import LayerHelper

    program = default_main_program()
    loss_name = loss_name or getattr(program, "_guard_loss_name", None)
    if loss_name is None:
        raise RuntimeError(
            "FLAGS_guard_numerics needs the loss variable: call "
            "optimizer.minimize(loss) (Optimizer.backward records it)")
    helper = LayerHelper("guardrails")
    health = helper.create_or_get_global_variable(
        GUARD_HEALTH_NAME, [4], "float32", initializer=Constant(0.0))
    state = helper.create_or_get_global_variable(
        GUARD_STATE_NAME, [2], "float32", initializer=Constant(0.0))
    live = [(p, g) for p, g in params_grads if g is not None]
    if not live:
        return params_grads
    gated = [helper.create_variable_for_type_inference(g.dtype)
             for _, g in live]
    inputs = {"X": [g.name for _, g in live], "Loss": [loss_name],
              "State": [state.name]}
    amp_found = getattr(program, "_guard_found_inf_name", None)
    if amp_found is not None:
        # AMP already votes: its @FOUND_INF@ ORs into the sentinel verdict
        inputs["FoundInfinite"] = [amp_found]
    helper.append_op(
        "health_sentinel", inputs,
        {"Out": [u.name for u in gated], "Health": [health.name],
         "StateOut": [state.name]},
        {"spike_factor": float(flags.get_flag("guard_spike_factor")),
         "ema_decay": 0.9},
    )
    it = iter(gated)
    return [(p, next(it) if g is not None else None)
            for p, g in params_grads]


class GuardError(RuntimeError):
    """The recovery ladder is exhausted (rewind budget spent, or a rewind
    was needed with nothing to rewind to): training must stop."""

    def __init__(self, msg: str, events=None):
        super().__init__(msg)
        self.events = list(events or [])


class GuardRewind(RuntimeError):
    """Raised out of Executor.run_async/wait when StepGuard's consecutive
    bad-step budget is exhausted. train_from_dataset handles it (rewind and
    continue past the poisoned batch); manual run_async loops catch it and
    call guard.rewind(exe, err)."""

    def __init__(self, step_id: int, health, reason: str):
        super().__init__(
            f"numeric guard: bad-step budget exhausted at async step "
            f"{step_id} ({reason}; health={np.asarray(health).tolist()})")
        self.step_id = step_id
        self.health = np.asarray(health, np.float32)
        self.reason = reason


class StepGuard:
    """Host-side bad-step policy over the in-graph health vector.

    manager: CheckpointManager (or a checkpoint-root path) used for the
    rewind rung and for durable guard-event recording; without one the
    guard still skips in-graph but surfaces GuardError instead of
    rewinding. program/scope default to the manager's.
    """

    def __init__(self, manager=None, budget: int | None = None,
                 lr_backoff: float | None = None,
                 max_rewinds: int | None = None, program=None, scope=None,
                 blame: bool = True):
        from .checkpoint import CheckpointManager

        if isinstance(manager, str):
            manager = CheckpointManager(manager, main_program=program,
                                        scope=scope)
        self.manager = manager
        self.budget = (int(flags.get_flag("guard_bad_step_budget"))
                       if budget is None else int(budget))
        self.lr_backoff = (float(flags.get_flag("guard_lr_backoff"))
                           if lr_backoff is None else float(lr_backoff))
        self.max_rewinds = (int(flags.get_flag("guard_max_rewinds"))
                            if max_rewinds is None else int(max_rewinds))
        self.program = program
        self.scope = scope
        self.blame = blame
        self.skips = 0
        self.rewinds = 0
        self.events: list[dict] = []
        self.last_blame: dict | None = None
        self._consec_bad = 0
        # step_id -> feed, for the blame replay; bounded to the async window
        self._feeds: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self._feed_cap = max(int(flags.get_flag("max_inflight_steps")), 1) + 4

    # -- executor hooks ------------------------------------------------------
    def note_dispatch(self, step_id: int, feed: dict | None) -> None:
        """run_async calls this at dispatch, so the poisoned batch is still
        around when its (window-delayed) health verdict arrives."""
        if feed is not None:
            self._feeds[step_id] = feed
            while len(self._feeds) > self._feed_cap:
                self._feeds.popitem(last=False)

    def observe(self, exe, step_id: int, health) -> str:
        """Called by Executor._drain_oldest AFTER the step's completion
        event (the 4-float health copy has landed by then). Returns
        "ok"/"skip"; raises GuardRewind when the consecutive-bad budget is
        exhausted."""
        h = np.asarray(health, np.float32).reshape(-1)
        if not (h[H_BAD] > 0 or not np.isfinite(h[H_BAD])):
            self._consec_bad = 0
            self._feeds.pop(step_id, None)
            return "ok"
        self._consec_bad += 1
        self.skips += 1
        reason = ("nonfinite" if (h[H_NONFINITE] > 0
                                  or not np.isfinite(h[H_NONFINITE]))
                  else "loss_spike")
        self._record(step_id, reason, "skip",
                     {"loss": float(h[H_LOSS]),
                      "grad_norm": float(h[H_GNORM]),
                      "consecutive": self._consec_bad})
        if self._consec_bad > self.budget:
            raise GuardRewind(step_id, h, reason)
        return "skip"

    # -- the rewind rung -----------------------------------------------------
    def _context(self):
        from ..framework import default_main_program

        program = (self.program or self.manager._program
                   or default_main_program())
        scope = self.scope or self.manager._scope
        if scope is None:
            raise ValueError("StepGuard needs a scope (the port has no global "
                             "scope): pass scope= to it or to its "
                             "CheckpointManager")
        return program, scope

    def rewind(self, exe, err: GuardRewind) -> dict | None:
        """Restore the newest good checkpoint, back off the LR, replay the
        poisoned step for an op-attributed blame report, record everything.
        Returns the blame report (None if the replay is disabled). Raises
        GuardError when the ladder is exhausted."""
        exe.drain_quiet()  # steps behind the bad one: complete, discard
        self._consec_bad = 0
        self.rewinds += 1
        if self.manager is None:
            raise GuardError(
                f"numeric guard: {err} — and no CheckpointManager is "
                f"attached, so there is nothing to rewind to; attach one "
                f"(StepGuard(manager=...)) or fix the data/LR",
                self.events) from err
        if self.rewinds > self.max_rewinds:
            raise GuardError(
                f"numeric guard: {self.rewinds} rewinds exceed "
                f"FLAGS_guard_max_rewinds={self.max_rewinds} — numeric "
                f"faults keep recurring after restore+LR-backoff; "
                f"surfacing. Last: {err}", self.events) from err
        program, scope = self._context()
        restored = self.manager.restore(executor=exe, main_program=program,
                                        scope=scope)
        if restored is None:
            warnings.warn(
                "StepGuard rewind found no checkpoint to restore — "
                "continuing from current (post-skip) state", stacklevel=2)
        backed_off = None
        if self.lr_backoff and self.lr_backoff != 1.0:
            backed_off = self._apply_lr_backoff(program, scope)
        report = None
        if self.blame:
            feed = self._feeds.get(err.step_id)
            if feed is not None:
                report = replay_blame(exe, program, feed, scope,
                                      step_id=err.step_id)
                self.last_blame = report
        self._record(err.step_id, err.reason, "rewind",
                     {"restored_step": restored, "lr_backoff": backed_off,
                      "rewind_index": self.rewinds, "blame": report})
        self._feeds.clear()
        return report

    def _apply_lr_backoff(self, program, scope):
        lr_name = getattr(program, "_guard_lr_name", None)
        if not lr_name or not scope.has_var(lr_name):
            return None
        # the restore above reloaded the CHECKPOINT's LR, so compound the
        # backoff by how many rewinds this run has needed — each recurrence
        # halves (by default) the rate the replay resumes with
        factor = self.lr_backoff ** self.rewinds
        new = scope.find_var(lr_name) * factor
        scope.set_var(lr_name, new)
        return {"lr_name": lr_name, "factor": factor,
                "new_lr": float(new.reshape(-1)[0])}

    # -- bookkeeping ---------------------------------------------------------
    def _record(self, step_id: int, reason: str, action: str,
                detail: dict | None) -> None:
        from .. import observability as obs

        evt = {"step": int(step_id), "reason": reason, "action": action}
        if detail:
            evt["detail"] = detail
        self.events.append(evt)
        obs.counter_inc("guard.events", labels={"action": action})
        obs.event("guard.step", evt,
                  level="warning" if action != "note" else "info")
        if self.manager is not None:
            self.manager.record_guard_event(step_id, reason, action, detail)


def replay_blame(exe, program, feed: dict, scope, step_id=None) -> dict:
    """Op-level blame isolation: run one step again under
    FLAGS_check_nan_inf on a scratch copy of the scope, so the first op
    emitting a non-finite value is named with its creation stack and live
    training state is untouched (every tensor of the scratch scope is a
    clone, so in-place writes land in the copy). Returns an attribution
    report dict."""
    from ..executor import Scope
    from ..framework import OpError

    scratch = Scope()
    scratch._vars.update({n: v.clone() if isinstance(v, torch.Tensor) else v
                          for n, v in scope._vars.items()})
    scratch._run_counter = scope._run_counter
    report: dict = {"step": step_id, "feed_keys": sorted(feed),
                    "op_type": None, "var": None}
    old = flags.get_flag("check_nan_inf")
    flags.set_flags({"check_nan_inf": True})
    try:
        exe.run(program, feed=feed, scope=scratch, fetch_list=[])
    except OpError as e:
        report["op_type"] = e.op.type
        report["var"] = next(
            (ns[0] for ns in e.op.outputs.values() if ns), None)
        report["detail"] = f"{type(e.cause).__name__}: {e.cause}"
        report["callstack"] = e.op.callstack_str()
    except Exception as e:  # noqa: BLE001 — forensic path must not throw
        report["detail"] = f"replay failed: {type(e).__name__}: {e}"
    else:
        # a loss spike replays finite: the batch itself is the attribution
        report["detail"] = ("replay finite after restore — batch-level "
                            "anomaly (loss spike), no single op to blame")
    finally:
        flags.set_flags({"check_nan_inf": old})
    return report
