"""Persistent per-(op, shape, dtype, device_kind) decision database.

The artifact is a single schema-versioned JSON file (FLAGS_tuning_db):

    {
      "schema": 1,
      "entries": {
        "<op>|<canonical shape key>|<dtype>|<device_kind>": {
          "decision": {...},            # op-specific, e.g. {"lowering": "igemm"}
          "source":   "swept",          # swept | candidate | recorded
          "measured": {...},            # sweep numbers (median ms per arm, band)
          "note":     "..."             # free-form provenance
        },
        ...
      }
    }

Write discipline follows the checkpoint rules: temp file in the same
directory + os.replace, so a crashed sweep never leaves a half-written DB.
Read discipline is fail-open: a missing file is an empty DB; a corrupt or
wrong-schema file warns ONCE and degrades to an empty DB, so a consult-mode
run falls back to the analytic prior instead of dying (the acceptance
contract — a bad cache may cost performance, never correctness).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import warnings

DB_SCHEMA = 1

__all__ = ["DB_SCHEMA", "TuningDB", "canonical_key", "conv_key",
           "attention_key", "bucket_key", "amp_key", "collective_key",
           "epilogue_key", "xent_key", "embedding_key", "evidence"]


def evidence(measured: dict) -> dict:
    """The canonical `measured` block every writer attaches to an entry:
    {arm: {"median_s": ..., "band": ...}} distilled from full
    tools/_timing.measure dicts. Offline sweeps (tools/tune.py) and
    explore-mode promotions (tuning/learned/explore.py) both go through
    here, so a candidate promoted online carries byte-identical evidence
    to one swept offline — and a candidate entry that HAS been measured
    (an in-band tie) keeps its times instead of just the decision."""
    out = {}
    for arm in sorted(measured):
        m = measured[arm]
        if not isinstance(m, dict) or m.get("median_s") is None:
            continue
        e = {"median_s": m["median_s"]}
        if m.get("band") is not None:
            e["band"] = m["band"]
        out[arm] = e
    return out


def canonical_key(op: str, shape_key: str, dtype: str, device_kind: str) -> str:
    """The one key format every layer agrees on. `shape_key` is the
    op-specific canonical shape spelling (see conv_key/attention_key);
    shapeless decisions (AMP op lists) use '-'."""
    return f"{op}|{shape_key}|{dtype}|{device_kind}"


def conv_key(n, hout, wout, cin, cout, kh, kw, strides, dilations, fmt) -> str:
    """conv2d lowering decisions key on everything the cost model sees plus
    the layout (NHWC/NCHW lower differently). Spatial extent is the OUTPUT
    tile (what the GEMM's M dim sees), so the same conv at two input pads
    that produce one output shape shares an entry."""
    return (f"n={n} out={hout}x{wout} cin={cin} cout={cout} "
            f"k={kh}x{kw} s={strides[0]}x{strides[1]} "
            f"d={dilations[0]}x{dilations[1]} {fmt}")


def attention_key(batch, num_heads, sq, sk, head_dim, causal) -> str:
    return (f"b={batch} nh={num_heads} sq={sq} sk={sk} dh={head_dim} "
            f"causal={int(bool(causal))}")


def bucket_key(var_name: str, dim: int, raw_extent: int) -> str:
    """Shape-bucketing boundary decisions: which padded extent a raw ragged
    extent rounds to (recorded so sweeps can revisit the pow2 default)."""
    return f"var={var_name} dim={dim} raw={raw_extent}"


def epilogue_key(kind: str, rows: int, channels: int, channel_pos: str,
                 act: str, has_residual: bool) -> str:
    """Fused normalize+affine+activation epilogue decisions
    (ops/pallas_kernels/epilogue.py): keyed on the canonical 2-D problem
    the kernel sees — reduction row count x channel extent — plus the
    layout ('last' = NHWC channels-last, 'row' = NCHW channels-row), the
    fused activation, and whether a residual add rides along. kind is
    'bn' (apply given stats) or 'ln' (in-kernel row statistics)."""
    return (f"kind={kind} rows={rows} c={channels} ch={channel_pos} "
            f"act={act or 'identity'} res={int(bool(has_residual))}")


def xent_key(rows: int, vocab: int) -> str:
    """Fused softmax-xent decisions (ops/pallas_kernels/xent.py): the
    kernel's problem is the flattened [rows, vocab] logits tile."""
    return f"rows={rows} v={vocab}"


def embedding_key(table: str, vocab: int, dim: int) -> str:
    """Tiered-embedding cache geometry decisions (embedding/engine.py):
    keyed on the table's identity and its row geometry — slots and prefetch
    width trade HBM footprint against hit rate for THIS table's id
    distribution, so the key must name the table, not just its shape."""
    return f"table={table} vocab={vocab} dim={dim}"


def amp_key(op_type: str) -> str:
    # AMP list membership is a per-op-TYPE decision (shapeless)
    return f"op={op_type}"


def collective_key(mesh_desc: str, payload_bytes: int) -> str:
    """Gradient-bucket sizing decisions (parallel/collective.py) key on the
    mesh layout and the TOTAL gradient payload, pow2-quantized in MB so one
    swept verdict covers the jitter between model revisions: bucket sizing
    trades per-collective launch/latency overhead against overlap
    granularity, and both scale with (ranks, payload), not with exact
    parameter shapes."""
    mb = max(1, int(payload_bytes) >> 20)
    q = 1
    while q < mb:
        q <<= 1
    return f"mesh={mesh_desc} payload={q}mb"


class TuningDB:
    """In-memory view of one JSON decision file. Thread-safe for the mixed
    trace-time (consult) / tool-time (record) usage; instances are cheap —
    the policy layer caches one per (path, mtime)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.entries: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._dirty = False
        if path:
            self._load(path)

    # -- read ---------------------------------------------------------------
    def _load(self, path: str) -> None:
        if not os.path.exists(path):
            return  # missing file == empty DB (first sweep creates it)
        try:
            with open(path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict):
                raise ValueError("top level is not an object")
            schema = raw.get("schema")
            if schema != DB_SCHEMA:
                raise ValueError(f"schema {schema!r} != {DB_SCHEMA}")
            entries = raw.get("entries", {})
            if not isinstance(entries, dict):
                raise ValueError("'entries' is not an object")
            self.entries = {k: v for k, v in entries.items()
                            if isinstance(v, dict) and "decision" in v}
        except (OSError, ValueError) as e:
            warnings.warn(
                f"tuning DB {path!r} unreadable ({e}); falling back to the "
                f"analytic cost model for every decision", stacklevel=3)
            self.entries = {}

    def lookup(self, key: str) -> dict | None:
        """Exact-hit tier: the entry dict, or None (caller falls to the
        analytic prior / conservative default)."""
        return self.entries.get(key)

    # -- write --------------------------------------------------------------
    def put(self, key: str, decision: dict, source: str = "swept",
            measured: dict | None = None, note: str | None = None,
            overwrite: bool = True) -> bool:
        """Insert/update one entry. `overwrite=False` keeps an existing
        swept verdict (candidates recorded at runtime must never clobber a
        measured decision)."""
        with self._lock:
            if not overwrite and key in self.entries:
                return False
            entry = {"decision": dict(decision), "source": source}
            if measured:
                entry["measured"] = measured
            if note:
                entry["note"] = note
            self.entries[key] = entry
            self._dirty = True
        return True

    def save(self, path: str | None = None) -> str:
        """Atomic temp+rename write (the checkpoint discipline)."""
        path = path or self.path
        if not path:
            raise ValueError("TuningDB.save: no path (set FLAGS_tuning_db)")
        payload = {"schema": DB_SCHEMA, "entries": self.entries}
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".tuning_db.", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self._dirty = False
        self.path = path
        return path

    def __len__(self) -> int:
        return len(self.entries)
