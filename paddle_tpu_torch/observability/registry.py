"""Typed, thread-safe metrics registry — the one telemetry spine (the JAX
package's observability/registry.py).

Design points:

  * one lock, plain dicts: the hot path (a counter bump) costs one lock
    acquisition and two dict operations, so always-on instrumentation
    stays ~free;
  * histograms are streaming log-bucketed (8 buckets/decade, 1e-9..1e9):
    p50/p95/p99 in O(buckets) with bounded memory, no reservoir, no sort;
  * labeled series: a (name, labels) pair is one series (the embedding
    engine's per-table counters);
  * declared schema: names are registered up front (schema.DECLARED);
    free-form names still record but surface in `snapshot()["undeclared"]`;
  * `snapshot(reset=True)` is atomic — read-and-zero under the lock, so
    concurrent writers can never be double-counted or lost across the
    reset boundary;
  * FLAGS_obs_enable gates the *extra* machinery (histograms, events,
    spans, exporter sinks). Counters/gauges/stages stay on either way so
    `profiler.stage_counters()` semantics never depend on the flag.

A span is a `torch.profiler.record_function` range (on the profiler's
timeline when a trace runs), where the JAX package's is a
`jax.profiler.TraceAnnotation`.
"""
from __future__ import annotations

import bisect
import contextlib
import math
import threading
import time
from collections import deque

from .. import flags
from . import schema as _schema

__all__ = ["MetricsRegistry", "registry", "enabled", "counter_inc",
           "gauge_set", "histogram_observe", "event", "span", "snapshot",
           "stage_record", "stage_counters", "reset", "attach_sink",
           "detach_sink"]


def enabled() -> bool:
    """FLAGS_obs_enable (histograms/events/spans/sinks). Counters, gauges
    and stage accumulators are always on."""
    try:
        return bool(flags.get_flag("obs_enable"))
    except KeyError:  # flags module mid-import
        return True


# log-spaced histogram bounds: 8 per decade over 1e-9 .. 1e9 (145 bounds,
# 146 buckets). Bucket ratio 10^(1/8) ~= 1.33, so a reported percentile is
# within ~15% of the true one — plenty for latency SLOs.
_BOUNDS = tuple(10.0 ** (k / 8.0) for k in range(-72, 73))


class _Histogram:
    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets = [0] * (len(_BOUNDS) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self.buckets[bisect.bisect_right(_BOUNDS, v)] += 1

    def quantile(self, q: float) -> float | None:
        if not self.count:
            return None
        target = q * self.count
        cum = 0
        for i, n in enumerate(self.buckets):
            cum += n
            if n and cum >= target:
                lo = _BOUNDS[i - 1] if i > 0 else self.vmin
                hi = _BOUNDS[i] if i < len(_BOUNDS) else self.vmax
                mid = math.sqrt(lo * hi) if lo > 0 and hi > 0 else hi
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "p50": None, "p95": None, "p99": None}
        return {"count": self.count, "sum": self.total,
                "min": self.vmin, "max": self.vmax,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


def _lkey(labels: dict | None) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items())) \
        if labels else ()


def _fmt(key: tuple) -> str:
    """Series display key: `name` or `name{k="v",...}` (Prometheus style)."""
    name, labels = key
    if not labels:
        return name
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{body}}}"


def base_name(series_key: str) -> str:
    """Strip the label body from a formatted series key."""
    return series_key.split("{", 1)[0]


class MetricsRegistry:
    """Thread-safe typed metric store; see module docstring."""

    def __init__(self, schema=None, max_events: int = 1024):
        self._lock = threading.Lock()
        self._schema: dict[str, dict] = {}
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, _Histogram] = {}
        self._stages: dict[str, list] = {}  # name -> [events, seconds]
        self._undeclared: set[str] = set()
        self._events: deque = deque(maxlen=max(1, int(max_events)))
        self._sinks: list = []
        for spec in (schema or ()):
            name, kind = spec[0], spec[1]
            help_ = spec[2] if len(spec) > 2 else ""
            labels = spec[3] if len(spec) > 3 else ()
            self.declare(name, kind, help_, labels)

    # -- schema --------------------------------------------------------------
    def declare(self, name: str, kind: str, help: str = "",
                labels=()) -> None:
        with self._lock:
            self._schema[name] = {"kind": kind, "help": help,
                                  "labels": tuple(labels)}
            self._undeclared.discard(name)

    def declared_names(self) -> frozenset:
        with self._lock:
            return frozenset(self._schema)

    def _note(self, name: str) -> None:
        # caller holds self._lock
        if name not in self._schema:
            self._undeclared.add(name)

    # -- mutators ------------------------------------------------------------
    def counter_inc(self, name: str, value: float = 1,
                    labels: dict | None = None) -> None:
        key = (name, _lkey(labels))
        with self._lock:
            self._note(name)
            self._counters[key] = self._counters.get(key, 0) + value

    def gauge_set(self, name: str, value: float,
                  labels: dict | None = None) -> None:
        key = (name, _lkey(labels))
        with self._lock:
            self._note(name)
            self._gauges[key] = float(value)

    def histogram_observe(self, name: str, value: float,
                          labels: dict | None = None) -> None:
        if not enabled():
            return
        key = (name, _lkey(labels))
        with self._lock:
            self._note(name)
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram()
            h.observe(value)

    def stage_record(self, stage: str, seconds: float,
                     events: int = 1) -> None:
        """The profiler.record_stage/bump accumulator: the stage counters'
        semantics ([events, seconds] per stage) plus, when the layer is
        enabled, a latency histogram per timed stage."""
        hist = seconds > 0.0 and enabled()
        with self._lock:
            self._note(stage)
            c = self._stages.get(stage)
            if c is None:
                c = self._stages[stage] = [0, 0.0]
            c[0] += events
            c[1] += seconds
            if hist:
                h = self._hists.get((stage, ()))
                if h is None:
                    h = self._hists[(stage, ())] = _Histogram()
                h.observe(seconds)

    def event(self, name: str, payload: dict | None = None,
              level: str = "info") -> dict | None:
        if not enabled():
            return None
        rec = {"ts": time.time(), "type": "event", "name": name,
               "level": level}
        if payload:
            rec["payload"] = payload
        with self._lock:
            self._note(name)
            self._events.append(rec)
            sinks = list(self._sinks)
        for s in sinks:
            try:
                s(rec)
            except Exception:  # noqa: BLE001 — a broken sink never kills work
                pass
        return rec

    @contextlib.contextmanager
    def span(self, name: str, labels: dict | None = None):
        """Named span: a `torch.profiler.record_function` range (visible in
        torch.profiler traces) + a `<name>.seconds` histogram sample + a
        JSONL span record through the sinks. No-op when the layer is
        disabled."""
        if not enabled():
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.histogram_observe(name + ".seconds", dt, labels)
                rec = {"ts": time.time(), "type": "span", "name": name,
                       "dur_s": round(dt, 9)}
                if labels:
                    rec["labels"] = dict(labels)
                with self._lock:
                    sinks = list(self._sinks)
                for s in sinks:
                    try:
                        s(rec)
                    except Exception:  # noqa: BLE001
                        pass

    # -- readers -------------------------------------------------------------
    def stage_counters(self, reset: bool = False) -> dict:
        with self._lock:
            snap = {k: {"events": v[0], "seconds": v[1]}
                    for k, v in self._stages.items()}
            if reset:
                self._stages.clear()
        return snap

    def snapshot(self, reset: bool = False) -> dict:
        """One atomic read of everything; reset=True zeroes the store under
        the same lock (no event can land between the read and the clear)."""
        with self._lock:
            out = {
                "counters": {_fmt(k): v for k, v in self._counters.items()},
                "gauges": {_fmt(k): v for k, v in self._gauges.items()},
                "histograms": {_fmt(k): h.summary()
                               for k, h in self._hists.items()},
                "stages": {k: {"events": v[0], "seconds": v[1]}
                           for k, v in self._stages.items()},
                "events": list(self._events),
                "undeclared": sorted(self._undeclared),
            }
            if reset:
                self._counters.clear()
                self._gauges.clear()
                self._hists.clear()
                self._stages.clear()
                self._events.clear()
                self._undeclared.clear()
        return out

    def reset(self, prefix: str | None = None) -> None:
        """Zero series (optionally only those whose name starts with
        `prefix`) without touching the event ring or the schema — the
        measurement boundary for scoped runs (timed passes, warmup passes)."""
        with self._lock:
            if prefix is None:
                self._counters.clear()
                self._gauges.clear()
                self._hists.clear()
                self._stages.clear()
                return
            for store in (self._counters, self._gauges, self._hists):
                for key in [k for k in store if k[0].startswith(prefix)]:
                    del store[key]
            for key in [k for k in self._stages if k.startswith(prefix)]:
                del self._stages[key]

    # -- sinks ---------------------------------------------------------------
    def attach_sink(self, sink) -> None:
        """`sink(record: dict)` receives every event/span record."""
        with self._lock:
            self._sinks.append(sink)

    def detach_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)


# -- the process-wide default registry ----------------------------------------
_default: MetricsRegistry | None = None
_default_lock = threading.Lock()


def registry() -> MetricsRegistry:
    """The default registry, created on first use with the declared schema
    and the flag-configured exporters (FLAGS_obs_jsonl_dir JSONL stream,
    FLAGS_obs_http_port /metrics endpoint) attached."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                try:
                    max_ev = int(flags.get_flag("obs_max_events"))
                except KeyError:
                    max_ev = 1024
                reg = MetricsRegistry(_schema.DECLARED, max_events=max_ev)
                from . import exporters

                exporters.install_flag_exporters(reg)
                _default = reg
    return _default


def counter_inc(name, value=1, labels=None):
    registry().counter_inc(name, value, labels)


def gauge_set(name, value, labels=None):
    registry().gauge_set(name, value, labels)


def histogram_observe(name, value, labels=None):
    registry().histogram_observe(name, value, labels)


def event(name, payload=None, level="info"):
    return registry().event(name, payload, level)


def span(name, labels=None):
    return registry().span(name, labels)


def snapshot(reset=False):
    return registry().snapshot(reset)


def stage_record(stage, seconds, events=1):
    registry().stage_record(stage, seconds, events)


def stage_counters(reset=False):
    return registry().stage_counters(reset)


def reset(prefix=None):
    registry().reset(prefix)


def attach_sink(sink):
    registry().attach_sink(sink)


def detach_sink(sink):
    registry().detach_sink(sink)
