"""Ridge-tier knob policy: regime -> proposed config, confidence-gated.

The trained artifact IS a tuning/learned model (MODEL_SCHEMA 1) — the
`serving.control|<device>` group sits next to `conv2d|cpu` in the same
JSON, trained by the same `tuning.learned.train_model` over the same
store.
Rows record seconds-per-goodput-token (`median_s = 1 / goodput_tok_s`),
so `predict_times` + argmin — the exact kernel-tier call — picks the
highest-predicted-goodput knob config.

Tier semantics are the kernel tier's: a proposal STANDS only when the
group's holdout rank accuracy clears the floor (the stricter of the
model-wide RANK_ACC_FLOOR and FLAGS_serve_control_conf) and the regime's
features sit inside the trained envelope; everything else falls back to
the hand flags, counted by reason — an unseeded prior serves exactly the
config the operator flagged, never a guess.
"""
from __future__ import annotations

import os
import threading
import warnings

from ... import flags
from ... import observability as obs
from ...tuning import device_kind, learned
from . import knobs as _knobs
from . import regime as _regime

__all__ = ["CONTROL_OP", "mode", "model_path", "store_path", "get_model",
           "invalidate_model_cache", "propose", "record_row",
           "role_split_prior"]

CONTROL_OP = "serving.control"

_lock = threading.Lock()
_model_cache: tuple[str, float, dict | None] | None = None
_warned_paths: set[str] = set()


def mode() -> str:
    """FLAGS_serve_control_mode, normalized: off | shadow | apply."""
    m = str(flags.get_flag("serve_control_mode")).strip().lower()
    return m if m in ("off", "shadow", "apply") else "shadow"


def model_path() -> str | None:
    """FLAGS_serve_control_model, falling back to the tuning model path —
    the control group ships inside the same trained artifact unless the
    operator splits it out."""
    p = str(flags.get_flag("serve_control_model")).strip()
    return p or learned.model_path()


def store_path() -> str | None:
    """FLAGS_serve_control_store, falling back to the tuning measurement
    store — one append-only dataset for kernels and regimes alike."""
    p = str(flags.get_flag("serve_control_store")).strip()
    return p or learned.measurements_path()


def get_model() -> dict | None:
    """(path, mtime)-cached model load with the tuning-DB read discipline:
    missing file = no learned tier (silent), corrupt file = warn once and
    fail open to the hand flags. Own cache rather than learned.get_model()
    because FLAGS_serve_control_model may point somewhere else."""
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
        m = learned.load_model(path)
    except ValueError as e:
        if path not in _warned_paths:
            _warned_paths.add(path)
            warnings.warn(
                f"serving control model {path!r} {e}; the learned "
                f"controller is disabled — serving the hand-flag config",
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


def _fallback(reason: str, hand: dict) -> tuple[dict, dict]:
    obs.counter_inc("serving.control.fallbacks", labels={"reason": reason})
    obs.counter_inc("serving.control.proposals", labels={"tier": "hand"})
    return hand, {"tier": "hand", "reason": reason}


def _conf_floor() -> float:
    return max(learned.RANK_ACC_FLOOR,
               float(flags.get_flag("serve_control_conf")))


def propose(sig: dict, *, model: dict | None = None,
            dev: str | None = None) -> tuple[dict, dict]:
    """Propose a knob config for one regime signal dict. Returns
    (knobs, info): info["tier"] is "learned" when a gated prediction
    stood, else "hand" with the fallback reason — the kernel tier's
    ordering with the hand flags playing the analytic prior's part."""
    hand = _knobs.hand_knobs()
    if mode() == "off":
        return hand, {"tier": "hand", "reason": "off"}
    m = model if model is not None else get_model()
    key = _regime.regime_key(sig)
    obs.gauge_set("serving.control.regime", _regime.regime_id(key))
    if m is None:
        return _fallback("no_model", hand)
    dev = dev or device_kind()
    group = m.get("groups", {}).get(f"{CONTROL_OP}|{dev}")
    if group is None:
        # regimes do not cross-device transfer: goodput under CPU load
        # says nothing about a GPU fleet, so a missing group is a
        # fallback, not a borrowed ranking
        return _fallback("no_group", hand)
    acc = (group.get("holdout") or {}).get("rank_acc")
    if acc is None or acc < _conf_floor():
        return _fallback("accuracy", hand)
    times, info = learned.predict_times(m, CONTROL_OP, key, "-", dev,
                                        gated=True)
    if times is None:
        return _fallback(info.get("reason", "unknown"), hand)
    arm = min(sorted(times), key=lambda a: times[a])
    proposed = _knobs.parse_knobs(arm)
    if proposed is None:
        return _fallback("arm_spelling", hand)
    obs.counter_inc("serving.control.proposals", labels={"tier": "learned"})
    return proposed, {"tier": "learned", "arm": arm, "regime": key,
                      "predicted_s_per_tok": times[arm], "rank_acc": acc,
                      "times": {a: float(t) for a, t in sorted(times.items())}}


def record_row(sig: dict, knob_cfg: dict, goodput_tok_s: float, *,
               source: str = "serve", extras: dict | None = None,
               tool: bool = False, path: str | None = None) -> bool:
    """Append one (regime, knob-config) -> goodput measurement. Stored as
    seconds per goodput token so smaller is better, like every other
    store row. Fail-open, under the store's recording discipline — but
    resolved against the CONTROL store ('off' stays absolute; 'auto'
    records from tools always, from the live controller only in
    sweep/explore runtime modes; a row needs SOME destination, which
    FLAGS_serve_control_store may provide when the tuning store has
    none)."""
    if goodput_tok_s <= 0:
        return False
    target = path or store_path()
    if not target:
        return False
    r = str(flags.get_flag("tuning_record")).strip().lower()
    if r == "off":
        return False
    if r != "on" and not tool:
        m = str(flags.get_flag("tuning_mode")).strip().lower()
        if m not in ("sweep", "explore"):
            return False
    return learned.record(
        CONTROL_OP, _regime.regime_key(sig), "-",
        device_kind(), _knobs.knob_key(knob_cfg),
        median_s=1.0 / float(goodput_tok_s), source=source,
        extras=extras, path=target)


def role_split_prior(n_replicas: int, *, records=None) -> tuple[int, dict]:
    """The disagg prefill:decode split, read from the store instead of the
    hand flag: among recorded fleet rows (pd > 0) the pd whose median
    goodput is best — accepted only when it beats the hand split's own
    recorded median by the near-tie band (a prior that cannot beat the
    flag it replaces defers to it). Falls back to
    FLAGS_disagg_prefill_replicas whenever the store is silent."""
    hand = int(flags.get_flag("disagg_prefill_replicas"))
    if mode() == "off":
        return hand, {"tier": "hand", "reason": "off"}
    if records is None:
        records = learned.iter_records(store_path())
    by_pd: dict[int, list[float]] = {}
    for rec in records:
        if rec.get("op") != CONTROL_OP:
            continue
        # only fleet rows of THIS fleet size compare: engine-level rows
        # (pd irrelevant) and other topologies measure different work
        if rec.get("fleet_n") != n_replicas:
            continue
        cfg = _knobs.parse_knobs(rec.get("arm", ""))
        t = rec.get("median_s")
        if not cfg or not isinstance(t, (int, float)) or t <= 0:
            continue
        by_pd.setdefault(cfg["pd"], []).append(float(t))
    scored = {pd: sorted(ts)[len(ts) // 2] for pd, ts in by_pd.items()
              if pd <= max(0, n_replicas - 1)}
    if not scored:
        return _role_fallback("no_rows", hand)
    best = min(sorted(scored), key=lambda pd: scored[pd])
    if best != hand and hand in scored \
            and scored[best] > scored[hand] * (1.0 - learned.model.RANK_TIE_BAND):
        return _role_fallback("tie_band", hand)
    if best == hand:
        return _role_fallback("hand_best", hand)
    obs.counter_inc("serving.control.proposals", labels={"tier": "learned"})
    return best, {"tier": "learned", "median_s": scored[best],
                  "candidates": {str(k): round(v, 6)
                                 for k, v in sorted(scored.items())}}


def _role_fallback(reason: str, hand: int) -> tuple[int, dict]:
    obs.counter_inc("serving.control.fallbacks", labels={"reason": reason})
    obs.counter_inc("serving.control.proposals", labels={"tier": "hand"})
    return hand, {"tier": "hand", "reason": reason}
