"""The pipeline stage counters (the JAX package's profiler.py:126-154) and
RecordEvent.

The counters are cheap always-on accumulators for the data pipeline
(parse, batch assembly, host ingest, device put, dispatch, window drains,
skipped corrupt batches, resolved tiered-embedding batches):
`stage_counters()` shows which stage the end-to-end path loses time to,
with no trace viewer. Their store is the observability registry
(`observability.stage_record`), as in the JAX package, so they ride the
unified snapshot and its exports too. RecordEvent is a named host span on
`torch.profiler`'s timeline.

The trace front end (`profiler`, `start_profiler`, `stop_profiler`, the
JAX package's profiler.py:34-98) runs `torch.profiler.profile` (host, and
the card's kernels through CUPTI when CUDA is present) and exports a
Chrome trace (chrome://tracing, Perfetto) into the resolved directory
(`profile_path`, else FLAGS_profiler_dir, else
<tempdir>/paddle_tpu_torch_profile), where the JAX package writes an
XPlane directory. Start and stop pair: a second start while a trace runs
raises, a stop without a start names the fix, and a start that fails
(the directory cannot be made) leaves no half-open trace.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time

import torch

from . import flags
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


def _resolve_dir(path: str | None) -> str:
    return (path or str(flags.get_flag("profiler_dir"))
            or os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_profile"))


# trace lifecycle: start/stop pair, and a failed start (e.g. os.makedirs on
# a read-only path) leaves no half-open trace behind
_trace_lock = threading.Lock()
_trace_active = False
_trace: tuple | None = None    # (torch.profiler.profile, directory)
_trace_seq = 0


def _begin_trace(path: str, state: str = "All") -> None:
    global _trace_active, _trace
    with _trace_lock:
        if _trace_active:
            raise RuntimeError(
                "a profiler trace is already active; call stop_profiler() "
                "(or leave the profiler() context) before starting another")
        # makedirs BEFORE the profiler starts: if the directory cannot be
        # made, nothing has started and the profiler stays restartable
        os.makedirs(path, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if str(state).upper() != "CPU" and torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        _trace, _trace_active = (prof, path), True


def _end_trace() -> str:
    """Stop the active trace and export it; returns the trace file."""
    global _trace_active, _trace, _trace_seq
    with _trace_lock:
        if not _trace_active:
            raise RuntimeError(
                "no active profiler trace — call start_profiler() (or use "
                "the profiler() context manager) before stop_profiler()")
        (prof, path), _trace, _trace_active = _trace, None, False
        prof.stop()
        _trace_seq += 1
        out = os.path.join(path, f"trace.{os.getpid()}.{_trace_seq}.json")
        prof.export_chrome_trace(out)
        return out


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str | None = None,
             profile_path: str | None = None):
    """`with profiler.profiler(...):` traces everything inside into a
    Chrome trace in the resolved directory. `state` "CPU" traces the host
    only; "GPU" and "All" add the card's kernels when CUDA is present.
    `sorted_key` is accepted for the reference API (sorting happens in the
    viewer)."""
    _begin_trace(_resolve_dir(profile_path), state)
    try:
        yield
    finally:
        _end_trace()


def start_profiler(state: str = "All", profile_path: str | None = None):
    """Imperative start (the reference's fluid/profiler.py start_profiler)."""
    _begin_trace(_resolve_dir(profile_path), state)


def stop_profiler(sorted_key: str | None = None,
                  profile_path: str | None = None) -> str:
    """Stop the active trace and write it into the directory given to
    start_profiler; returns the trace file's path. The arguments are the
    reference API's (the trace lands where start_profiler said). Raises
    RuntimeError naming start_profiler when no trace is active."""
    return _end_trace()
