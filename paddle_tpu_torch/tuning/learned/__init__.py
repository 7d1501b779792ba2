"""Learned cost-model subsystem: the measured half of the tuner.

Three parts, one package:

  store.py    — append-only JSONL measurement store every sweep / A/B
                harness / bench round / explore probe feeds;
  features.py + model.py
              — hand features over the canonical shape keys and the
                numpy-only seeded ridge regressor tools/costmodel.py
                trains per (op, device_kind);
  explore.py  — bounded online exploration (FLAGS_tuning_mode=explore)
                that promotes candidate keys to swept verdicts from the
                executor's idle gaps.

This module owns the glue the policy layer consults: the (path, mtime)
model cache with the tuning-DB read discipline (missing file = no learned
tier, corrupt file = warn ONCE + fail open), `decide_learned()` — the new
tier between exact-DB-hit and analytic prior — and the provenance counters
behind the tuning.learned.* metrics.
"""
from __future__ import annotations

import os
import threading
import warnings

from ... import flags
from . import explore, features, model, store
from .explore import maybe_explore
from .model import (ENVELOPE_MARGIN, MODEL_SCHEMA, RANK_ACC_FLOOR,
                    eval_model, load_model, predict_times, save_model,
                    train_model)
from .store import (STORE_SCHEMA, iter_records, measurements_path, record,
                    record_measured, recording_enabled)

__all__ = [
    "store", "features", "model", "explore",
    "STORE_SCHEMA", "MODEL_SCHEMA", "RANK_ACC_FLOOR", "ENVELOPE_MARGIN",
    "measurements_path", "recording_enabled", "record", "record_measured",
    "iter_records", "train_model", "eval_model", "save_model", "load_model",
    "predict_times", "maybe_explore",
    "model_path", "get_model", "invalidate_model_cache", "decide_learned",
    "bump_prediction", "bump_fallback", "bump_promotion",
    "snapshot", "reset_counters",
]

_lock = threading.Lock()
_model_cache: tuple[str, float, dict | None] | None = None
_warned_paths: set[str] = set()

# learned-tier provenance: predictions that stood, fallbacks by reason,
# explore promotions — bench.py's tuning block and gate.py's fallback-rate
# ceiling read the snapshot
_counts = {"predictions": 0, "fallbacks": 0, "promotions": 0}
_fallback_reasons: dict[str, int] = {}


def model_path() -> str | None:
    """FLAGS_tuning_model, or derived from FLAGS_tuning_db
    (`<db stem>.model.json` next to it). None = no learned tier."""
    p = str(flags.get_flag("tuning_model")).strip()
    if p:
        return p
    db = str(flags.get_flag("tuning_db")).strip()
    if not db:
        return None
    stem, _ = os.path.splitext(db)
    return stem + ".model.json"


def get_model() -> dict | None:
    """The trained artifact for model_path(), reloaded when the file's
    mtime moves (a costmodel.py retrain mid-session is picked up without a
    restart — the get_db discipline). Missing file: silently no model.
    Corrupt file: warn once per path, then behave as missing until the
    file changes — the learned tier may cost coverage, never a run."""
    global _model_cache
    path = model_path()
    if not path:
        return None
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        mtime = -1.0
    with _lock:
        if _model_cache and _model_cache[0] == path \
                and _model_cache[1] == mtime:
            return _model_cache[2]
    try:
        m = load_model(path)
    except ValueError as e:
        if path not in _warned_paths:
            _warned_paths.add(path)
            warnings.warn(
                f"tuning cost model {path!r} {e}; the learned tier is "
                f"disabled — falling back to the analytic prior",
                stacklevel=3)
        m = None
    with _lock:
        _model_cache = (path, mtime, m)
    return m


def invalidate_model_cache() -> None:
    global _model_cache
    with _lock:
        _model_cache = None
        _warned_paths.clear()


def bump_prediction(op: str) -> None:
    from ... import observability as obs

    with _lock:
        _counts["predictions"] += 1
    obs.counter_inc("tuning.learned.predictions", labels={"op": op})


def bump_fallback(op: str, reason: str) -> None:
    from ... import observability as obs

    with _lock:
        _counts["fallbacks"] += 1
        _fallback_reasons[reason] = _fallback_reasons.get(reason, 0) + 1
    obs.counter_inc("tuning.learned.fallbacks",
                    labels={"op": op, "reason": reason})


def bump_promotion(op: str) -> None:
    from ... import observability as obs

    with _lock:
        _counts["promotions"] += 1
    obs.counter_inc("tuning.learned.explore_promotions", labels={"op": op})


def reset_counters() -> None:
    with _lock:
        _counts.update(predictions=0, fallbacks=0, promotions=0)
        _fallback_reasons.clear()


def snapshot() -> dict:
    """Learned-tier provenance for the bench artifact's tuning block:
    attempts = keys the tier tried to predict; fallback_rate is what
    gate.py's --costmodel ceiling reads."""
    with _lock:
        c = dict(_counts)
        reasons = dict(_fallback_reasons)
    attempts = c["predictions"] + c["fallbacks"]
    return {
        **c,
        "attempts": attempts,
        "fallback_rate": round(c["fallbacks"] / attempts, 4)
        if attempts else None,
        "fallback_reasons": reasons,
    }


def decide_learned(op: str, key: str, validate=None) -> dict | None:
    """The policy tier between exact-DB-hit and analytic prior: predict
    per-arm times for this (unseen) key and return the argmin as a
    decision dict — or None (with the fallback reason counted) so decide()
    falls through to the analytic prior. Absence of a model, or of any
    trained group for this op, is not an attempt — like a DB miss, it is
    counted nowhere."""
    if op not in features.FAMILIES:
        return None
    m = get_model()
    if m is None:
        return None
    parts = key.split("|")
    if len(parts) != 4 or parts[0] != op:
        return None
    _, shape_key, dtype, dev = parts
    times, info = predict_times(m, op, shape_key, dtype, dev)
    if times is None:
        reason = info.get("reason", "unknown")
        if reason != "no_group":
            bump_fallback(op, reason)
        return None
    arm = min(sorted(times), key=lambda a: times[a])
    decision = {info.get("decision_field",
                         features.decision_field(op)): arm}
    if validate is not None and not validate(decision):
        bump_fallback(op, "validate")
        return None
    bump_prediction(op)
    return decision
