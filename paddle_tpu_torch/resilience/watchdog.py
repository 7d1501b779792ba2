"""Hang watchdogs: bounded waits that dump state instead of blocking forever
(the JAX package's resilience/watchdog.py).

A distributed training step can wedge in ways a retry policy never sees —
a device kernel never completes, a feed pipeline's producer thread dies
holding its queue, a pserver stops mid-round. The symptom is always the
same: some host-side wait (`Executor.wait` draining a completion token, a
`DeviceLoader` consumer blocking on the staging queue) simply never
returns, and the job hangs with zero diagnostics until an external timeout
kills it.

This module turns those waits into *bounded* waits. `Watchdog.wait`
polls a readiness predicate (for a step, its completion event's
`query()`); if `FLAGS_watchdog_stall_s` passes with no
progress it raises `StallError` carrying a state dump (in-flight step ids,
queue depths, per-stage profiler counters) assembled at the moment of the
stall — the forensic record the reference stack's `GetMonitorThreadPool`
style hang reports provide, but as a structured exception the caller (or a
CheckpointedRunner) can act on.

The `pipeline_stall` fault site (resilience/faults.py) simulates a wedge on
demand so the watchdog path is testable on one healthy host.
"""
from __future__ import annotations

import json
import logging
import time
from typing import Callable

__all__ = ["StallError", "Watchdog", "HeartbeatMonitor", "stall_window_s",
           "watchdog_scale", "runtime_state"]

logger = logging.getLogger("paddle_tpu_torch.resilience.watchdog")


def watchdog_scale() -> float:
    """FLAGS_watchdog_scale, clamped to >= 1.0: one global multiplier every
    watchdog window and heartbeat deadline applies, so a loaded CI runner
    widens every margin at once instead of flaking site by site."""
    from .. import flags

    try:
        return max(1.0, float(flags.get_flag("watchdog_scale")))
    except KeyError:  # flags module mid-import
        return 1.0


def stall_window_s() -> float:
    """The configured watchdog window in seconds (<=0 = disabled), widened
    by FLAGS_watchdog_scale."""
    from .. import flags

    try:
        return float(flags.get_flag("watchdog_stall_s")) * watchdog_scale()
    except KeyError:  # flags module mid-import
        return 0.0


class StallError(RuntimeError):
    """No progress within the watchdog window; `.state` holds the dump."""

    def __init__(self, what: str, window_s: float, state: dict | None = None):
        self.what = what
        self.window_s = float(window_s)
        self.state = dict(state or {})
        try:
            dump = json.dumps(self.state, indent=1, default=str, sort_keys=True)
        except (TypeError, ValueError):
            dump = repr(self.state)
        super().__init__(
            f"{what}: no progress within {window_s:.3g}s "
            f"(FLAGS_watchdog_stall_s) — in-flight state:\n{dump}")
        # structured copies of the dump: the exception message above stays
        # the human-readable record, while the telemetry registry and the
        # logging tree carry the same state for machine consumers
        try:
            from .. import observability as obs

            obs.counter_inc("watchdog.stalls")
            obs.event("watchdog.stall",
                      {"what": what, "window_s": self.window_s,
                       "state": self.state}, level="error")
        except Exception:  # noqa: BLE001 — telemetry never masks the stall
            pass
        logger.error("stall: %s (no progress within %.3gs)", what, window_s,
                     extra={"stall_state": self.state})


class Watchdog:
    """Poll-based stall detector for host-side waits.

    `wait(ready, state, what)` returns as soon as `ready()` is truthy and
    raises `StallError(what, window, state())` once `window_s` elapses.
    The poll interval self-scales (1ms .. 50ms) so short waits stay cheap
    and long ones don't spin.
    """

    def __init__(self, window_s: float | None = None):
        self.window_s = (stall_window_s() if window_s is None
                         else float(window_s))

    @property
    def enabled(self) -> bool:
        return self.window_s > 0.0

    def wait(self, ready: Callable[[], bool],
             state: Callable[[], dict] | None = None,
             what: str = "wait") -> None:
        deadline = time.monotonic() + self.window_s
        interval = 0.001
        while not ready():
            if time.monotonic() > deadline:
                raise StallError(what, self.window_s,
                                 state() if state is not None else {})
            time.sleep(interval)
            interval = min(interval * 2, 0.05)


class HeartbeatMonitor:
    """Per-participant heartbeat ledger: the Watchdog generalized from one
    bounded wait to N long-lived peers (fleet engine replicas, and the
    same shape the pserver's trainer-liveness monitor keeps server-side).

    Participants `register()` once and `beat()` whenever they make
    progress; `overdue(now)` returns everyone whose last beat is older
    than the deadline — the caller owns what "dead" means (the fleet
    router fails their work over, a trainer monitor evicts them from the
    barrier). The deadline is widened by FLAGS_watchdog_scale exactly like
    the stall windows, so one CI knob de-flakes every liveness check.
    A deadline <= 0 disables the monitor (`overdue` is always empty)."""

    def __init__(self, deadline_s: float, scale: float | None = None):
        self.deadline_s = float(deadline_s) * (
            watchdog_scale() if scale is None else max(1.0, float(scale)))
        self._last: dict[str, float] = {}

    @property
    def enabled(self) -> bool:
        return self.deadline_s > 0.0

    def register(self, name: str, now: float | None = None) -> None:
        self._last[name] = time.monotonic() if now is None else now

    def deregister(self, name: str) -> None:
        self._last.pop(name, None)

    def beat(self, name: str, now: float | None = None) -> None:
        if name in self._last:
            self._last[name] = time.monotonic() if now is None else now

    def age(self, name: str, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        return now - self._last[name]

    def overdue(self, now: float | None = None) -> list[str]:
        if not self.enabled:
            return []
        now = time.monotonic() if now is None else now
        return [n for n, t in self._last.items()
                if now - t > self.deadline_s]


def runtime_state(**extra) -> dict:
    """Common state-dump fields every watchdog site includes: per-stage
    profiler counters plus whatever the site knows (step ids, depths)."""
    from .. import profiler

    out = {"profiler_stages": profiler.stage_counters()}
    out.update(extra)
    return out
