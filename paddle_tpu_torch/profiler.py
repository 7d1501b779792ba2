"""The pipeline stage counters (the JAX package's profiler.py:130-154) and
RecordEvent.

The counters are cheap always-on accumulators for the data pipeline
(parse, batch assembly, host ingest, device put, skipped corrupt batches):
`stage_counters()` shows which stage the end-to-end path loses time to,
with no trace viewer. Their store is the port's own (the JAX package keeps
them in its observability registry, which the port has not ported:
ROADMAP Queue 1, serving, the rest, with the observability and resilience
subsystems). RecordEvent is a named host span on `torch.profiler`'s
timeline; the trace front end (`profiler`, `start_profiler`,
`stop_profiler`) raises until that item ports it.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["profiler", "start_profiler", "stop_profiler", "RecordEvent",
           "record_event", "record_stage", "stage_timer", "stage_counters",
           "bump"]


class _StageStore:
    """{stage: [events, seconds]} under a lock (producer threads and the
    consumer record into it at once)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: dict[str, list] = {}

    def record(self, stage: str, seconds: float, events: int) -> None:
        with self._lock:
            c = self._stages.setdefault(stage, [0, 0.0])
            c[0] += events
            c[1] += seconds

    def snapshot(self, reset: bool) -> dict:
        with self._lock:
            snap = {k: {"events": v[0], "seconds": v[1]}
                    for k, v in self._stages.items()}
            if reset:
                self._stages.clear()
        return snap


_STORE = _StageStore()


def record_stage(stage: str, seconds: float, events: int = 1):
    """Accumulate `seconds` of wall time against a named pipeline stage."""
    _STORE.record(stage, seconds, events)


def bump(stage: str, events: int = 1):
    """Count an event with no wall time against a named counter (the
    corrupt-record skips)."""
    _STORE.record(stage, 0.0, events)


@contextlib.contextmanager
def stage_timer(stage: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_stage(stage, time.perf_counter() - t0)


def stage_counters(reset: bool = False) -> dict:
    """Snapshot {stage: {"events": n, "seconds": s}}; reset=True zeroes the
    accumulators after reading (epoch-scoped measurements)."""
    return _STORE.snapshot(reset)


class RecordEvent(contextlib.ContextDecorator):
    """A named host span on torch.profiler's timeline
    (`torch.profiler.record_function`); a context manager or a
    decorator."""

    def __init__(self, name: str):
        self._name = name
        self._spans: list = []  # one instance may nest or recurse

    def __enter__(self):
        span = torch.profiler.record_function(self._name)
        span.__enter__()
        self._spans.append(span)
        return self

    def __exit__(self, *exc):
        return self._spans.pop().__exit__(*exc)


record_event = RecordEvent


def _trace_front_end(*_args, **_kwargs):
    raise NotImplementedError(
        "the profiler's trace front end is not ported yet (ROADMAP Queue 1, "
        "serving, the rest, with the observability and resilience "
        "subsystems); trace with torch.profiler.profile directly")


profiler = start_profiler = stop_profiler = _trace_front_end
