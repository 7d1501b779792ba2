"""The pipeline stage counters (the JAX package's profiler.py:126-154) and
RecordEvent.

The counters are cheap always-on accumulators for the data pipeline
(parse, batch assembly, host ingest, device put, dispatch, window drains,
skipped corrupt batches, resolved tiered-embedding batches):
`stage_counters()` shows which stage the end-to-end path loses time to,
with no trace viewer. Their store is the observability registry
(`observability.stage_record`), as in the JAX package, so they ride the
unified snapshot and its exports too. RecordEvent is a named host span on
`torch.profiler`'s timeline; the trace front end (`profiler`,
`start_profiler`, `stop_profiler`) raises until ROADMAP Queue 1, serving,
the rest, ports it.
"""
from __future__ import annotations

import contextlib
import time

import torch

from . import observability as _obs

__all__ = ["profiler", "start_profiler", "stop_profiler", "RecordEvent",
           "record_event", "record_stage", "stage_timer", "stage_counters",
           "bump"]


def record_stage(stage: str, seconds: float, events: int = 1):
    """Accumulate `seconds` of wall time against a named pipeline stage."""
    _obs.stage_record(stage, seconds, events)


def bump(stage: str, events: int = 1):
    """Count an event with no wall time against a named counter (the
    corrupt-record skips, the resolved tiered batches)."""
    _obs.stage_record(stage, 0.0, events)


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
    return _obs.stage_counters(reset)


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
        "serving, the rest); trace with torch.profiler.profile directly")


profiler = start_profiler = stop_profiler = _trace_front_end
