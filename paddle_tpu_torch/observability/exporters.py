"""Exporters: rotating atomic JSONL stream, Prometheus text snapshots,
and an optional /metrics HTTP endpoint.

Three consumers, three formats:
  * JSONL — the durable stream (events, spans, snapshots). One record per
    line, written with a single
    O_APPEND write so concurrent writers never interleave mid-line;
    rotation is size-triggered and atomic (os.replace to `<path>.1`).
  * Prometheus text exposition — the scrape format ops tooling already
    speaks. `prometheus_text()` renders a registry snapshot; counters and
    gauges verbatim, histograms as summaries (quantile-labeled series +
    _sum/_count), stage accumulators as `<stage>_events`/`_seconds_total`
    counter pairs. `write_prometheus()` is temp+rename atomic (the same
    discipline as the checkpoint writers).
  * HTTP — `start_http_exporter(port)` serves the live snapshot at
    /metrics from a stdlib daemon thread (FLAGS_obs_http_port).

`parse_prometheus()` is the round-trip half: it parses the exposition
text back to {series: value}; the tests use it to prove a live run's
export is byte-for-byte parseable. The JAX package's observability/
exporters.py, copied.
"""
from __future__ import annotations

import json
import os
import re
import threading

__all__ = ["JsonlWriter", "jsonl_line", "prometheus_text",
           "write_prometheus", "parse_prometheus", "start_http_exporter",
           "install_flag_exporters"]


def jsonl_line(record: dict) -> bytes:
    """The canonical encoding of one stream record (compact separators,
    sorted keys): the byte-for-byte round-trip contract is
    `jsonl_line(json.loads(line)) == line`."""
    return (json.dumps(record, default=str, sort_keys=True,
                       separators=(",", ":")) + "\n").encode()


class JsonlWriter:
    """Append-only JSONL stream with atomic line writes and size-based
    rotation. Callable, so it plugs straight in as a registry sink."""

    def __init__(self, path: str, rotate_bytes: int = 8 << 20):
        self.path = path
        self.rotate_bytes = max(4096, int(rotate_bytes))
        self._lock = threading.Lock()
        self._fd: int | None = None
        self._size = 0

    def _open(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fd = os.open(self.path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._size = os.fstat(self._fd).st_size

    def write(self, record: dict) -> None:
        line = jsonl_line(record)
        with self._lock:
            if self._fd is None:
                self._open()
            if self._size + len(line) > self.rotate_bytes and self._size:
                os.close(self._fd)
                # atomic rotation: the live path always holds a complete
                # stream; readers of `<path>.1` see the previous one
                os.replace(self.path, self.path + ".1")
                self._open()
            os.write(self._fd, line)
            self._size += len(line)

    __call__ = write

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


# -- Prometheus text exposition ----------------------------------------------
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LINE_RE = re.compile(  # value: float incl. negative exponents / nan / inf
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([-+0-9.eEnaif]+)$')


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _split_series(series: str) -> tuple[str, str]:
    """'name{k="v"}' -> ('name', '{k="v"}'); bare name -> (name, '')."""
    if "{" in series:
        name, rest = series.split("{", 1)
        return name, "{" + rest
    return series, ""


def _num(v) -> str:
    if v is None:
        return "nan"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(snapshot: dict) -> str:
    """Render a registry snapshot in the Prometheus text exposition format
    (deterministic ordering, so identical snapshots render identical
    bytes)."""
    out: list[str] = []
    for series, value in sorted(snapshot.get("counters", {}).items()):
        name, labels = _split_series(series)
        pname = _prom_name(name)
        out.append(f"# TYPE {pname} counter")
        out.append(f"{pname}{labels} {_num(value)}")
    for series, value in sorted(snapshot.get("gauges", {}).items()):
        name, labels = _split_series(series)
        pname = _prom_name(name)
        out.append(f"# TYPE {pname} gauge")
        out.append(f"{pname}{labels} {_num(value)}")
    for stage, row in sorted(snapshot.get("stages", {}).items()):
        pname = _prom_name(stage)
        out.append(f"# TYPE {pname}_events counter")
        out.append(f"{pname}_events {_num(row['events'])}")
        out.append(f"# TYPE {pname}_seconds_total counter")
        out.append(f"{pname}_seconds_total {_num(row['seconds'])}")
    for series, h in sorted(snapshot.get("histograms", {}).items()):
        name, labels = _split_series(series)
        pname = _prom_name(name)
        body = labels[1:-1] if labels else ""
        out.append(f"# TYPE {pname} summary")
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            lab = f'quantile="{q}"' + (f",{body}" if body else "")
            out.append(f"{pname}{{{lab}}} {_num(h.get(key))}")
        out.append(f"{pname}_sum{labels} {_num(h.get('sum', 0.0))}")
        out.append(f"{pname}_count{labels} {_num(h.get('count', 0))}")
    return "\n".join(out) + ("\n" if out else "")


def write_prometheus(path: str, snapshot: dict) -> str:
    """Atomic (temp+rename) Prometheus snapshot file; returns the text."""
    text = prometheus_text(snapshot)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return text


def parse_prometheus(text: str) -> dict[str, float]:
    """Parse exposition text back to {series_line_key: value}. Raises
    ValueError on any unparseable non-comment line — the strictness IS the
    round-trip check."""
    out: dict[str, float] = {}
    for i, ln in enumerate(text.splitlines()):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        m = _LINE_RE.match(ln)
        if not m:
            raise ValueError(f"unparseable exposition line {i + 1}: {ln!r}")
        name, labels, value = m.groups()
        out[name + (labels or "")] = float(value)
    return out


def start_http_exporter(registry, port: int, host: str = "127.0.0.1"):
    """Serve the live registry snapshot at /metrics (Prometheus text) from
    a stdlib daemon thread. Returns the HTTPServer (its .server_address[1]
    is the bound port — pass port=0 for an ephemeral one)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = prometheus_text(registry.snapshot()).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # silence per-request stderr noise
            pass

    server = ThreadingHTTPServer((host, int(port)), _Handler)
    t = threading.Thread(target=server.serve_forever,
                         name="obs-metrics-http", daemon=True)
    t.start()
    return server


def install_flag_exporters(registry) -> None:
    """Attach the flag-configured exporters to a registry at creation:
    FLAGS_obs_jsonl_dir (event/span JSONL stream) and FLAGS_obs_http_port
    (/metrics endpoint). Failures are non-fatal — telemetry must never be
    the reason a job dies."""
    from .. import flags

    try:
        d = str(flags.get_flag("obs_jsonl_dir")).strip()
        if d:
            rotate = float(flags.get_flag("obs_jsonl_rotate_mb")) * 1e6
            registry.attach_sink(
                JsonlWriter(os.path.join(d, "obs.jsonl"), int(rotate)))
    except Exception:  # noqa: BLE001
        pass
    try:
        port = int(flags.get_flag("obs_http_port"))
        if port > 0:
            start_http_exporter(registry, port)
    except Exception:  # noqa: BLE001
        pass
