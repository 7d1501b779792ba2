"""CheckpointedRunner: a fault-tolerant Executor.run training loop (the JAX
package's resilience/runner.py).

Wraps the plain `for step: exe.run(...)` loop with the recovery ladder:

  1. periodic atomic checkpoints (CheckpointManager) every `save_every`
     steps, plus one at the end of the run;
  2. auto-resume: `resume()` restores the newest good checkpoint and the
     loop continues from the following step (the kill-and-resume contract:
     a SIGKILLed trainer restarts within one checkpoint of the crash);
  3. on a step failure: restore the last good checkpoint and replay from
     it (feeds and the random key are keyed by the step index, so the
     replayed trajectory equals an undisturbed run's wherever the step
     itself is deterministic);
  4. escalation before surfacing: the second failure of the same step also
     drops the executor's record of the prepared program
     (`invalidate_cache`, whose next run fires the `executor.compile` site
     again). The JAX package's third rung runs the step under
     `jax.disable_jit()`; this executor is eager already, so that rung is a
     plain retry that keeps the attempt count, and StepFailure.attempts is
     the JAX package's.

Determinism contract: `feed_fn(step)` must be a pure function of the step
index, and the runner passes `rng_counter=step + 1` to Executor.run so
counter-derived randomness (dropout masks) depends only on the step, never
on how many crashes and replays it took to get there. The port has no
global scope: the runner takes the scope, or the manager's.
"""
from __future__ import annotations

from typing import Callable, Sequence

from .checkpoint import CheckpointManager

__all__ = ["CheckpointedRunner", "StepFailure"]


class StepFailure(RuntimeError):
    """A step kept failing after the whole recovery ladder."""

    def __init__(self, step: int, attempts: int, last: Exception):
        super().__init__(
            f"training step {step} failed after {attempts} attempts "
            f"(restore+retry, cache invalidation, plain retry all "
            f"exhausted): {last}")
        self.step = step
        self.attempts = attempts


class CheckpointedRunner:
    def __init__(self, executor, manager: "CheckpointManager | str",
                 main_program=None, scope=None, save_every: int | None = None,
                 max_retries: int | None = None):
        """manager: a CheckpointManager or a checkpoint root directory.
        save_every/max_retries default from FLAGS_ckpt_save_every /
        FLAGS_runner_max_retries."""
        from .. import flags
        from ..framework import default_main_program

        self.exe = executor
        self.manager = (manager if isinstance(manager, CheckpointManager)
                        else CheckpointManager(manager))
        self.program = (main_program or self.manager._program
                        or default_main_program())
        self.scope = scope or self.manager._scope
        if self.scope is None:
            raise ValueError("CheckpointedRunner needs a scope (the port has "
                             "no global scope): pass scope= to the runner "
                             "or its CheckpointManager")
        self.save_every = (flags.get_flag("ckpt_save_every")
                           if save_every is None else int(save_every))
        self.max_retries = (flags.get_flag("runner_max_retries")
                            if max_retries is None else int(max_retries))
        self.retries_used = 0  # across the whole run, for observability

    # -- resume --------------------------------------------------------------
    def resume(self, executor=None) -> int:
        """Restore the newest good checkpoint into the scope; returns the
        next step index to run (0 on a fresh root)."""
        restored = self.manager.restore(executor=executor or self.exe,
                                        main_program=self.program,
                                        scope=self.scope)
        return 0 if restored is None else restored + 1

    # -- the guarded step ----------------------------------------------------
    def _run_step(self, step: int, feed: dict, fetch_list):
        return self.exe.run(self.program, feed=feed, fetch_list=fetch_list,
                            scope=self.scope, rng_counter=step + 1)

    def _recover(self, attempt: int, step: int, exc: Exception) -> int:
        """Roll state back to the last good checkpoint; returns the step the
        loop must resume from (replay). Escalates with the attempt count."""
        if attempt >= 2:
            # whatever the executor kept for the program may be what is
            # broken: prepare it from scratch
            invalidate = getattr(self.exe, "invalidate_cache", None)
            if invalidate is not None:
                invalidate(self.program)
        restored = self.manager.restore(executor=self.exe,
                                        main_program=self.program,
                                        scope=self.scope)
        if restored is None:
            return step  # nothing to roll back to: plain retry
        return restored + 1

    def run(self, feed_fn: Callable[[int], dict], num_steps: int,
            fetch_list: Sequence | None = None,
            on_step: Callable[[int, list], None] | None = None,
            start_step: int | None = None) -> dict:
        """Train steps [start, num_steps) with recovery and checkpoints.

        feed_fn(step) -> feed dict, pure in step; on_step(step, outs) fires
        after every *successful* step (replays fire it again: consumers
        keyed by step stay consistent). Returns {"start_step", "results":
        {step: outs}, "retries"}.
        """
        start = self.resume() if start_step is None else int(start_step)
        results: dict[int, list] = {}
        step = start
        # per-step failure counts survive replays: a rollback runs earlier
        # (healthy) steps again, and the failing step resumes its
        # escalation where it left off
        fails: dict[int, int] = {}
        while step < num_steps:
            try:
                outs = self._run_step(step, feed_fn(step), fetch_list)
            except Exception as e:  # noqa: BLE001 — the ladder decides
                nfails = fails.get(step, 0) + 1
                fails[step] = nfails
                self.retries_used += 1
                if nfails > self.max_retries:
                    raise StepFailure(step, nfails, e) from e
                step = self._recover(nfails, step, e)
                continue
            results[step] = outs
            if on_step is not None:
                on_step(step, outs)
            if self.save_every and (step + 1) % self.save_every == 0:
                self.manager.save(step, executor=self.exe,
                                  main_program=self.program, scope=self.scope)
            step += 1
        if num_steps > start and (
                not self.save_every or num_steps % self.save_every != 0):
            # the final state is always durable, whatever the cadence
            self.manager.save(num_steps - 1, executor=self.exe,
                              main_program=self.program, scope=self.scope)
        return {"start_step": start, "results": results,
                "retries": self.retries_used}
