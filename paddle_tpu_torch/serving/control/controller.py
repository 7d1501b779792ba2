"""Bounded online actuator: epoch ticks, safe-boundary application.

One Controller watches one or more engines. Per engine, per epoch
(FLAGS_serve_control_epoch_s), it:

  1. observes the live regime (regime.observe) and the REALIZED goodput
     since the previous tick (decode tokens / wall seconds);
  2. appends the realized measurement to the store (source="serve", under
     the store's recording gate) and scores it against the previous
     tick's prediction for the engine's current config — the
     serving.control.goodput_rel_err histogram is the controller grading
     its own prior;
  3. asks the ridge-tier policy for a proposal. Shadow mode stops here
     (propose + log, never apply — the default). Apply mode hands the
     proposal to `engine.propose_config`, which stages it as a PENDING
     config the engine adopts only at a safe boundary (no in-flight
     work), re-running `warmup_decode` when the bucket geometry moved.

The tick itself is one perf_counter read and a compare until an epoch is
due — the shadow-mode 0.0% overhead budget is won here, not claimed.
"""
from __future__ import annotations

import time

from ... import flags
from ... import observability as obs
from . import knobs as _knobs
from . import policy as _policy
from . import regime as _regime

__all__ = ["Controller", "engine_knobs"]


def engine_knobs(engine) -> dict:
    """The engine's CURRENT config as a knob dict (pd is fleet-level and
    spelled 0 — an engine does not know its fleet's role split)."""
    return {
        "mi": int(engine.max_inflight),
        "dk": int(engine.draft_k),
        "pc": int(engine.prefix_cache is not None),
        "sp": int(getattr(engine.scheduler, "policy", "fcfs") == "sjf"),
        "sq": int(engine.shed_queue_depth),
        "so": int(round(100 * float(engine.shed_occupancy))),
        "da": int(engine.degrade_after),
        "pd": 0,
    }


class Controller:
    def __init__(self, epoch_s: float | None = None):
        self.epoch_s = float(
            epoch_s if epoch_s is not None
            else flags.get_flag("serve_control_epoch_s"))
        self._next_t: dict[int, float] = {}
        self._win: dict[int, dict] = {}
        # last predicted sec/goodput-token per engine, keyed by the arm it
        # was predicted FOR — graded only while that arm is still serving
        self._pred: dict[int, tuple[str, float]] = {}
        self.last_cost: dict[int, float] = {}
        self.last_info: dict[int, dict] = {}

    def tick(self, engine, now: float | None = None) -> bool:
        """Cheap per-step hook: fires a controller epoch when one is due
        for this engine. Returns True when an epoch ran."""
        if self.epoch_s <= 0:
            return False
        now = time.perf_counter() if now is None else now
        eid = id(engine)
        due = self._next_t.get(eid)
        if due is None:
            # first sight of this engine: open the measurement window,
            # fire only after one full epoch of traffic exists to observe
            self._next_t[eid] = now + self.epoch_s
            self._win[eid] = {"t": now, "rid": engine._next_rid,
                              "tok": engine.stats["decode_tokens"]}
            return False
        if now < due:
            return False
        if _policy.mode() == "off":
            self._next_t[eid] = now + self.epoch_s
            return False
        self._epoch(engine, eid, now)
        self._next_t[eid] = now + self.epoch_s
        return True

    def _epoch(self, engine, eid: int, now: float) -> None:
        win = self._win.get(eid) or {"t": now, "rid": 0, "tok": 0}
        sig = _regime.observe(engine, window=win)
        current = engine_knobs(engine)
        cur_arm = _knobs.knob_key(current)
        dt = now - win.get("t", now)
        dtok = engine.stats["decode_tokens"] - win.get("tok", 0)
        realized = dtok / dt if dt > 0 and dtok > 0 else 0.0
        if realized > 0:
            _policy.record_row(sig, current, realized, source="serve",
                               extras={"live": True})
            pred = self._pred.get(eid)
            if pred and pred[0] == cur_arm and pred[1] > 0:
                rel = abs(pred[1] - 1.0 / realized) * realized
                obs.histogram_observe("serving.control.goodput_rel_err",
                                      rel)
        proposal, info = _policy.propose(sig)
        self.last_info[eid] = info
        times = info.get("times") or {}
        if cur_arm in times:
            self._pred[eid] = (cur_arm, float(times[cur_arm]))
            self.last_cost[eid] = float(times[cur_arm])
        elif realized > 0:
            self.last_cost[eid] = 1.0 / realized
        if _policy.mode() == "apply" and info.get("tier") == "learned":
            if engine.propose_config(proposal, source="controller"):
                obs.counter_inc("serving.control.staged")
        self._win[eid] = {"t": now, "rid": engine._next_rid,
                          "tok": engine.stats["decode_tokens"]}

    def forget(self, engine) -> None:
        """Drop a retired engine's cursors (fleet replacement churn)."""
        for d in (self._next_t, self._win, self._pred,
                  self.last_cost, self.last_info):
            d.pop(id(engine), None)
