"""Decision resolution: DB hit -> learned model -> analytic -> default.

`decide()` is the one consult point every tunable lever flows through
(conv lowering, attention backend, conv+BN fusion, AMP list membership,
bucket boundaries). Four tiers, strictly ordered:

  1. exact hit  — the swept DB has this (op, shape, dtype, device_kind) key;
  2. learned    — the trained cost model (tuning/learned/) predicts per-arm
                  times for this UNSEEN key and its confidence gates pass;
  3. analytic   — the registered prior for the op kind (the kernels'
                  length rule for attention, the flag defaults elsewhere);
  4. default    — the caller's conservative fallback (what the code did
                  before the tuner existed).

Every resolution bumps a per-op provenance counter so bench.py can report
how much of a workload ran on swept decisions vs the prior (`gate.py` flags
a consult-mode workload that runs mostly untuned).

Modes (FLAGS_tuning_mode):
  off     — decide() is never consulted; levers use their pre-tuner logic.
  consult — resolve through the tiers above.
  sweep   — resolve analytically like `off`, but RECORD every distinct key
            encountered into the DB as a `candidate` entry (never clobbering
            a swept verdict) so `tools/tune.py` knows what to measure.
  explore — consult, plus candidate recording, plus bounded ONLINE
            measurement: tuning/learned/explore.py probes one recorded
            candidate every FLAGS_tuning_explore_every executor steps and
            promotes out-of-band verdicts to swept entries (TVM-style).
"""
from __future__ import annotations

import threading

import torch

from .. import flags
from .db import TuningDB

__all__ = ["decide", "mode", "consult_enabled", "sweep_enabled", "get_db",
           "invalidate_db_cache", "device_kind", "provenance_snapshot",
           "reset_provenance", "on_minimize"]

_lock = threading.Lock()
_db_cache: tuple[str, float, TuningDB] | None = None  # (path, mtime, db)

# provenance counters: {op: {"db": n, "analytic": n, "default": n}}
_counters: dict[str, dict[str, int]] = {}


def mode() -> str:
    m = str(flags.get_flag("tuning_mode")).strip().lower()
    return m if m in ("off", "consult", "sweep", "explore") else "off"


def consult_enabled() -> bool:
    # explore IS consult (same tier resolution) with online measurement on
    return mode() in ("consult", "explore")


def sweep_enabled() -> bool:
    return mode() == "sweep"


_device_kinds: dict = {}


def device_kind(device=None) -> str:
    """Canonical device component of every key: the name of the device the
    decision is for — `torch.cuda.get_device_name(index)` for a CUDA
    device, "cpu" for the CPU. With no device named, the device the port's
    entry points default to (the current CUDA device, or the CPU where
    there is none): minimize()-time decisions take that one. A DB swept on
    an H100 keys under its name and never matches a TPU's entry. Cached
    per device: decide() runs at every new key."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _device_kinds:
        _device_kinds[index] = torch.cuda.get_device_name(index)
    return _device_kinds[index]


def get_db() -> TuningDB:
    """The DB for FLAGS_tuning_db, reloaded when the file's mtime moves
    (a sweep finishing mid-session is picked up without a restart). An
    empty/unset path is a permanently-empty DB (pure analytic mode)."""
    global _db_cache
    path = str(flags.get_flag("tuning_db")).strip()
    if not path:
        return TuningDB(None)
    import os

    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        mtime = -1.0
    with _lock:
        if _db_cache and _db_cache[0] == path and _db_cache[1] == mtime:
            return _db_cache[2]
        db = TuningDB(path)
        _db_cache = (path, mtime, db)
        return db


def invalidate_db_cache() -> None:
    global _db_cache
    with _lock:
        _db_cache = None


def _bump(op: str, tier: str) -> None:
    with _lock:
        c = _counters.setdefault(op, {"db": 0, "analytic": 0, "default": 0})
        c[tier] = c.get(tier, 0) + 1
    from .. import observability as obs

    obs.counter_inc("tuning.decisions", labels={"op": op, "tier": tier})


def reset_provenance() -> None:
    with _lock:
        _counters.clear()


def provenance_snapshot() -> dict:
    """Per-op tier counts plus the aggregate rates bench.py reports:
    hit_rate is swept-DB resolutions over all resolutions, tuned_rate
    additionally credits the learned tier (a model prediction IS a
    measured-data decision, just an interpolated one — gate.py's coverage
    floor reads tuned_rate so a model-served workload is not flagged as
    untuned)."""
    with _lock:
        per_op = {op: dict(c) for op, c in _counters.items()}
    total = sum(sum(c.values()) for c in per_op.values())
    hits = sum(c["db"] for c in per_op.values())
    learned = sum(c.get("learned", 0) for c in per_op.values())
    return {
        "decisions": total,
        "db_hits": hits,
        "learned": learned,
        "hit_rate": round(hits / total, 4) if total else None,
        "tuned_rate": round((hits + learned) / total, 4) if total else None,
        "per_op": per_op,
    }


def decide(op: str, key: str, prior=None, default: dict | None = None,
           validate=None) -> tuple[dict, str]:
    """Resolve one decision. Returns (decision dict, tier) with tier in
    {"db", "learned", "analytic", "default"}.

    `prior`: zero-arg callable returning the analytic decision (evaluated
    lazily — cost models only run on a DB miss). `validate`: optional
    predicate on a DB or learned decision; a decision the current build
    cannot honor (an attention route the port has no hand kernel for)
    falls through to the prior instead of being obeyed blindly. In sweep mode the analytic resolution
    is recorded as a candidate entry for tools/tune.py; explore mode records
    candidates too (food for the online prober) while resolving normally."""
    if sweep_enabled():
        d = _resolve_prior(op, prior, default)
        _record_candidate(key, d)
        return d
    m = mode()
    db = get_db()
    entry = db.lookup(key)
    if entry is not None and entry.get("source") != "candidate":
        decision = entry["decision"]
        if validate is None or validate(decision):
            _bump(op, "db")
            return decision, "db"
    from . import learned

    ld = learned.decide_learned(op, key, validate)
    if ld is not None:
        _bump(op, "learned")
        if m == "explore" and entry is None:
            _record_candidate(key, (ld, "learned"))
        return ld, "learned"
    res = _resolve_prior(op, prior, default)
    if m == "explore" and entry is None:
        _record_candidate(key, res)
    return res


def _resolve_prior(op, prior, default):
    if prior is not None:
        d = prior()
        if d is not None:
            _bump(op, "analytic")
            return d, "analytic"
    _bump(op, "default")
    return dict(default or {}), "default"


_seen_candidates: set[str] = set()


def _record_candidate(key: str, resolved: tuple[dict, str]) -> None:
    """Sweep mode: persist the key (with its analytic resolution as the
    provisional decision) so the offline sweeper knows the workload's
    decision surface. Write-through is cheap — each distinct key is recorded
    once per process and the file is small."""
    if key in _seen_candidates:
        return
    _seen_candidates.add(key)
    path = str(flags.get_flag("tuning_db")).strip()
    if not path:
        return
    db = get_db()
    if db.put(key, resolved[0], source="candidate",
              note=f"analytic resolution tier={resolved[1]}",
              overwrite=False):
        try:
            db.save(path)
            invalidate_db_cache()  # mtime moved; reload clean next consult
        except OSError:
            pass  # read-only FS: candidates stay in-memory only


def on_minimize(program) -> None:
    """minimize()-time hook (optimizer.Optimizer.backward): force the DB
    load NOW so a corrupt file warns at graph-build time — once, attached to
    the minimize call — rather than at an op's first run, and stamp the
    program with the mode it was built under (bench provenance)."""
    m = mode()
    program._tuning_mode = m
    if m != "off":
        get_db()
