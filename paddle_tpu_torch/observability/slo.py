"""Rolling-window SLO monitor: registry thresholds -> warn/alert callbacks.

The watchdog (resilience/watchdog.py) turns a *hang* into a structured
exception; this turns a *degradation* into a structured callback. Rules
read the registry snapshot (p99 latency histograms, leak gauges, hit-rate
counters); one breach within the window is a WARN, a rule breached
`alert_after` times inside `window_s` escalates to ALERT — a single slow
scrape never pages, a sustained one always does.

Every breach is also recorded on the registry itself (`slo.breaches`
counter labeled (rule, severity) + an `slo.breach` event), so the export
path carries the verdicts along with the measurements that produced them.

Default rules come from the FLAGS_obs_slo_* knobs (serving p99 request
latency, KV-page leaks, prefix-cache hit-rate floor); `add_rule` takes
arbitrary snapshot predicates for everything else. The JAX package's
observability/slo.py, copied.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque

from .. import flags
from .registry import registry as _default_registry

__all__ = ["SloRule", "SloMonitor", "default_serving_monitor"]

logger = logging.getLogger("paddle_tpu_torch.observability.slo")


class SloRule:
    """One threshold: `check(snapshot)` returns the measured value when
    breached, None when healthy."""

    def __init__(self, name: str, check, threshold, describe: str = ""):
        self.name = name
        self.check = check
        self.threshold = threshold
        self.describe = describe or name


def hist_p99_above(hist_name: str, ceiling_s: float):
    def check(snap):
        h = snap.get("histograms", {}).get(hist_name)
        if not h or not h.get("count"):
            return None
        p99 = h.get("p99")
        return p99 if p99 is not None and p99 > ceiling_s else None
    return check


def gauge_above(gauge_name: str, ceiling: float):
    def check(snap):
        v = snap.get("gauges", {}).get(gauge_name)
        return v if v is not None and v > ceiling else None
    return check


def counter_ratio_below(num_name: str, den_names, floor: float,
                        min_den: float = 1.0):
    """Breach when num / sum(dens) < floor (hit-rate style). Quiet until
    the denominator has seen at least `min_den` events."""
    def check(snap):
        c = snap.get("counters", {})
        den = sum(c.get(n, 0.0) for n in den_names)
        if den < min_den:
            return None
        rate = c.get(num_name, 0.0) / den
        return rate if rate < floor else None
    return check


class SloMonitor:
    """Evaluate rules against registry snapshots on demand (`observe()`)
    or on a background cadence (`start(period_s)`)."""

    def __init__(self, registry=None, window_s: float = 60.0,
                 alert_after: int = 3, on_warn=None, on_alert=None):
        self.registry = registry
        self.window_s = float(window_s)
        self.alert_after = max(1, int(alert_after))
        self.on_warn = on_warn or self._log_warn
        self.on_alert = on_alert or self._log_alert
        self.rules: list[SloRule] = []
        self._breach_times: dict[str, deque] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    @staticmethod
    def _log_warn(breach: dict) -> None:
        logger.warning("SLO warn: %s = %s (threshold %s)",
                       breach["rule"], breach["value"], breach["threshold"],
                       extra={"slo_breach": breach})

    @staticmethod
    def _log_alert(breach: dict) -> None:
        logger.error("SLO ALERT: %s = %s (threshold %s, %d breaches in "
                     "%.3gs)", breach["rule"], breach["value"],
                     breach["threshold"], breach["count_in_window"],
                     breach["window_s"], extra={"slo_breach": breach})

    def add_rule(self, name: str, check, threshold,
                 describe: str = "") -> "SloMonitor":
        self.rules.append(SloRule(name, check, threshold, describe))
        return self

    def observe(self, snapshot: dict | None = None,
                now: float | None = None) -> list[dict]:
        """One evaluation pass; returns the breaches it saw (each already
        counted, evented and dispatched to its callback)."""
        reg = self.registry or _default_registry()
        snap = snapshot if snapshot is not None else reg.snapshot()
        now = time.monotonic() if now is None else now
        breaches = []
        for rule in self.rules:
            value = rule.check(snap)
            if value is None:
                continue
            times = self._breach_times.setdefault(rule.name, deque())
            times.append(now)
            while times and now - times[0] > self.window_s:
                times.popleft()
            severity = ("alert" if len(times) >= self.alert_after
                        else "warn")
            breach = {"rule": rule.name, "value": value,
                      "threshold": rule.threshold, "severity": severity,
                      "describe": rule.describe,
                      "count_in_window": len(times),
                      "window_s": self.window_s}
            reg.counter_inc("slo.breaches",
                            labels={"rule": rule.name, "severity": severity})
            reg.event("slo.breach", breach,
                      level="error" if severity == "alert" else "warning")
            (self.on_alert if severity == "alert" else self.on_warn)(breach)
            breaches.append(breach)
        return breaches

    def start(self, period_s: float = 5.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(period_s):
                try:
                    self.observe()
                except Exception:  # noqa: BLE001 — monitor never kills work
                    logger.exception("SLO monitor pass failed")

        self._thread = threading.Thread(target=loop, name="obs-slo-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def default_serving_monitor(registry=None, **kw) -> SloMonitor:
    """The flag-configured serving monitor: FLAGS_obs_slo_p99_ms caps
    serving.request_s p99, FLAGS_obs_slo_max_leaked_pages caps the
    serving.leaked_pages gauge, FLAGS_obs_slo_min_hit_rate floors the
    prefix-cache hit rate. Disabled thresholds (0/negative where 0 means
    off) add no rule."""
    mon = SloMonitor(registry=registry, **kw)
    p99_ms = float(flags.get_flag("obs_slo_p99_ms"))
    if p99_ms > 0:
        mon.add_rule("serving_p99_latency",
                     hist_p99_above("serving.request_s", p99_ms / 1e3),
                     p99_ms / 1e3,
                     f"serving.request_s p99 above {p99_ms} ms")
    max_leak = int(flags.get_flag("obs_slo_max_leaked_pages"))
    mon.add_rule("kv_pages_leaked",
                 gauge_above("serving.leaked_pages", float(max_leak)),
                 max_leak, "KV pool pages leaked past the allowance")
    hit_floor = float(flags.get_flag("obs_slo_min_hit_rate"))
    if hit_floor > 0:
        mon.add_rule(
            "prefix_hit_rate",
            counter_ratio_below(
                "serving.prefix_hit_tokens",
                ("serving.prefix_hit_tokens",
                 "serving.prefill_tokens_computed"),
                hit_floor),
            hit_floor, "prefix-cache hit rate below floor")
    return mon
