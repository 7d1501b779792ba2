"""Unified telemetry layer: one registry, three exports (the JAX
package's observability/).

`registry.py` is the spine (counters, gauges, streaming-percentile
histograms, labeled series, events, spans, atomic `snapshot(reset=True)`),
`schema.py` declares every permitted metric name, `exporters.py` ships it
(rotating atomic JSONL, Prometheus text, /metrics endpoint) and `slo.py`
watches it (rolling-window thresholds -> warn/alert callbacks). The
profiler's stage counters, the tiered-embedding engine's `emb.*` counters
and the watchdog's stall records land here.

Usage is module-level against the process-wide default registry:

    from paddle_tpu_torch import observability as obs
    obs.counter_inc("emb.hit_ids", 7, labels={"table": "fm_emb"})
    obs.histogram_observe("train.step_latency_s", 0.042)
    with obs.span("serving.decode"):
        ...                 # record_function range + histogram + JSONL
    snap = obs.snapshot()   # everything, atomically
"""
from __future__ import annotations

from . import schema  # noqa: F401
from .exporters import (  # noqa: F401
    JsonlWriter, jsonl_line, parse_prometheus, prometheus_text,
    start_http_exporter, write_prometheus)
from .registry import (  # noqa: F401
    MetricsRegistry, attach_sink, base_name, counter_inc, detach_sink,
    enabled, event, gauge_set, histogram_observe, registry, reset,
    snapshot, span, stage_counters, stage_record)
from .slo import SloMonitor, SloRule, default_serving_monitor  # noqa: F401


def export_prometheus(path: str | None = None) -> str | None:
    """Write the default registry's snapshot as a Prometheus text file to
    `path` (default FLAGS_obs_prometheus_path; no-op when unset). Returns
    the rendered text."""
    from .. import flags as _flags

    p = path or str(_flags.get_flag("obs_prometheus_path")).strip()
    if not p:
        return None
    return write_prometheus(p, snapshot())


__all__ = [
    "MetricsRegistry", "registry", "enabled", "counter_inc", "gauge_set",
    "histogram_observe", "event", "span", "snapshot", "stage_record",
    "stage_counters", "reset", "attach_sink", "detach_sink", "base_name",
    "schema", "JsonlWriter", "jsonl_line", "prometheus_text",
    "write_prometheus", "parse_prometheus", "start_http_exporter",
    "SloMonitor", "SloRule", "default_serving_monitor",
    "export_prometheus",
]
