"""Append-only measurement store: the raw timings behind every verdict.

Every `tools/tune.py` sweep arm, every A/B harness pass, every bench round
and every explore-mode probe used to discard its window timings the moment
the keep/retire verdict was spoken. This store keeps them: one JSON line
per (key, arm) measurement, schema-versioned, so `tools/costmodel.py` can
train the learned tier (arXiv:2008.01040 — measured (op, shape, dtype)
timings generalize to unseen shapes) from data the existing workflows
produce as a side effect.

Record shape (STORE_SCHEMA = 1):

    {
      "schema": 1,
      "op": "conv2d",                  # op family (or "ab.*" / "bench")
      "shape_key": "n=8 out=...",      # the db.py canonical shape spelling
      "dtype": "float32",
      "device_kind": "cpu",
      "arm": "igemm",                  # arm name == decision value
      "median_s": 0.0123,              # _timing.measure summary fields
      "min_s": 0.0119,
      "band": 0.02,                    # interference band of the windows
      "windows_s": [...],              # raw per-window seconds
      "source": "sweep",               # sweep | ab | bench | explore
      "host": {"host": ..., "platform": ..., "cpus": ...},
      "ts": 1754...                    # unix seconds, int
    }

Write discipline is the observability JSONL one (exporters.py): each record
is one canonical compact line written with a single O_APPEND write, so
concurrent sweeps interleave whole lines, never bytes. Read discipline is
fail-open like the tuning DB: a missing file is an empty dataset; corrupt
or wrong-schema lines are skipped, not fatal — a damaged store may cost
training data, never a run.
"""
from __future__ import annotations

import json
import os
import platform
import socket
import time

from ... import flags

STORE_SCHEMA = 1

__all__ = ["STORE_SCHEMA", "measurements_path", "recording_enabled",
           "host_fingerprint", "record", "record_measured", "iter_records"]


def measurements_path() -> str | None:
    """FLAGS_tuning_measurements, or derived from FLAGS_tuning_db
    (`<db stem>.measurements.jsonl` next to it) so a sweep with a DB
    configured grows a dataset without extra flags. None = no store."""
    p = str(flags.get_flag("tuning_measurements")).strip()
    if p:
        return p
    db = str(flags.get_flag("tuning_db")).strip()
    if not db:
        return None
    stem, _ = os.path.splitext(db)
    return stem + ".measurements.jsonl"


def recording_enabled(tool: bool = False) -> bool:
    """FLAGS_tuning_record gate. 'on'/'off' are absolute; 'auto' (default)
    records from the tools (sweeps, A/B harnesses — `tool=True`) whenever a
    store path resolves, and from the runtime only in sweep/explore mode
    (consult-mode training steps must not grow files as a side effect)."""
    r = str(flags.get_flag("tuning_record")).strip().lower()
    if r == "off":
        return False
    if measurements_path() is None:
        return False
    if r == "on" or tool:
        return True
    m = str(flags.get_flag("tuning_mode")).strip().lower()
    return m in ("sweep", "explore")


_host: dict | None = None


def host_fingerprint() -> dict:
    """Which box produced the numbers — a model trained on a quiet CI
    runner must be auditable against data from a loaded dev box."""
    global _host
    if _host is None:
        _host = {
            "host": socket.gethostname(),
            "platform": platform.platform(),
            "cpus": os.cpu_count() or 0,
        }
    return _host


def _jsonl_line(record: dict) -> bytes:
    # exporters.py's canonical encoding: compact separators + sorted keys
    return (json.dumps(record, sort_keys=True,
                       separators=(",", ":")) + "\n").encode()


def record(op: str, shape_key: str, dtype: str, device_kind: str, arm: str,
           *, windows_s=None, median_s=None, min_s=None, band=None,
           source: str = "sweep", extras: dict | None = None,
           path: str | None = None) -> bool:
    """Append one measurement line. Returns True if a line landed. Never
    raises on I/O trouble (read-only FS etc.) — measurement capture is a
    side effect, not a contract the measured run depends on."""
    path = path or measurements_path()
    if not path:
        return False
    ws = [round(float(w), 9) for w in windows_s] if windows_s else []
    if median_s is None and ws:
        xs = sorted(ws)
        n = len(xs)
        median_s = xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
    rec = {
        "schema": STORE_SCHEMA,
        "op": op,
        "shape_key": shape_key,
        "dtype": dtype,
        "device_kind": device_kind,
        "arm": arm,
        "median_s": round(float(median_s), 9) if median_s is not None else None,
        "min_s": round(float(min_s), 9) if min_s is not None else (
            round(min(ws), 9) if ws else None),
        "band": round(float(band), 4) if band is not None else None,
        "windows_s": ws,
        "source": source,
        "host": host_fingerprint(),
        "ts": int(time.time()),
    }
    if extras:
        rec.update({k: v for k, v in extras.items() if k not in rec})
    try:
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, _jsonl_line(rec))
        finally:
            os.close(fd)
        return True
    except OSError:
        return False


def record_measured(key: str, measured: dict, source: str = "sweep",
                    path: str | None = None) -> int:
    """Append every arm of one tune.py-style measurement set. `key` is the
    db.py canonical `<op>|<shape_key>|<dtype>|<device_kind>` spelling;
    `measured` maps arm name -> _timing.measure summary (median_s / min_s /
    windows_s / band, extra fields ignored). Returns lines written."""
    parts = key.split("|")
    if len(parts) != 4:
        return 0
    op, shape_key, dtype, device_kind = parts
    n = 0
    for arm, m in sorted(measured.items()):
        if not isinstance(m, dict):
            continue
        n += bool(record(
            op, shape_key, dtype, device_kind, arm,
            windows_s=m.get("windows_s"), median_s=m.get("median_s"),
            min_s=m.get("min_s"), band=m.get("band"),
            source=source, path=path))
    return n


def iter_records(path: str | None = None):
    """Yield parsed records, fail-open: missing file yields nothing;
    corrupt or wrong-schema lines are skipped silently (an interrupted
    append leaves at most one torn final line)."""
    path = path or measurements_path()
    if not path or not os.path.exists(path):
        return
    try:
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if (isinstance(rec, dict)
                        and rec.get("schema") == STORE_SCHEMA
                        and rec.get("op") and rec.get("arm")):
                    yield rec
    except OSError:
        return
