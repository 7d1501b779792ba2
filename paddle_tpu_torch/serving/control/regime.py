"""Traffic-regime featurizer: one canonical spelling per serving regime.

The learned controller keys the measurement store the way the kernel tier
keys it: `op="serving.control"`, a canonical `shape_key` naming the TRAFFIC
REGIME, and the knob-config spelling as the arm. This module owns that
spelling. Two producers write it:

  * an offline knob sweep spells the
    regime from the WORKLOAD INTENT (arrival rate, prompt-length
    percentiles, output budget) plus the runtime signals observed under
    the hand-flag reference pass — every knob arm of one regime then
    shares one key, which is what lets the ridge fit rank arms at all;
  * the live controller (`controller.py`) spells it from a running
    engine's registry-backed stats between two epoch ticks.

Signals are BUCKETED before spelling (pow2 lengths/queues, 5-point
percent ratios): a regime key is a coarse address, and the ridge
generalizes across the gaps — exact key reuse is a bonus, not a
requirement (the arXiv:2008.01040 framing, unchanged).

Every ratio is spelled as a percent int so the key round-trips through
`tuning/learned/features.parse_shape_key` like every other canonical
shape spelling.
"""
from __future__ import annotations

import math
import zlib

__all__ = ["REGIME_FIELDS", "regime_key", "regime_id", "bucket_signals",
           "parse_regime", "workload_signals", "observe"]

# canonical field order of the regime spelling (all integer-valued):
#   rate — offered arrivals/s            p50/p95 — prompt-length percentiles
#   out  — median output budget          hit     — prefix-cache hit %
#   occ  — pool occupancy %              q       — waiting-queue depth
#   hr   — TTFT/SLO headroom % (100 = no SLO pressure / no floor armed)
REGIME_FIELDS = ("rate", "p50", "p95", "out", "hit", "occ", "q", "hr")


def _pow2(x: float) -> int:
    x = max(0, int(round(x)))
    return 0 if x == 0 else 1 << max(0, math.ceil(math.log2(max(1, x))))


def _pct5(x: float) -> int:
    """Ratios quantize to 5-point percent buckets — coarse enough that one
    noisy pass does not mint a fresh regime, fine enough to separate an
    idle pool from a saturated one."""
    return int(5 * round(20.0 * min(max(float(x), 0.0), 1.0)))


def bucket_signals(sig: dict) -> dict:
    """Raw signal dict -> bucketed integer dict in REGIME_FIELDS order."""
    return {
        "rate": max(1, int(round(float(sig.get("rate", 1.0))))),
        "p50": _pow2(sig.get("p50", 1)),
        "p95": _pow2(sig.get("p95", 1)),
        "out": _pow2(sig.get("out", 1)),
        "hit": _pct5(sig.get("hit", 0.0)),
        "occ": _pct5(sig.get("occ", 0.0)),
        "q": _pow2(sig.get("q", 0)),
        "hr": _pct5(sig.get("hr", 1.0)),
    }


def regime_key(sig: dict) -> str:
    """The canonical shape_key spelling for one (raw or bucketed) signal
    dict — the store/featurizer address of this traffic regime."""
    b = bucket_signals(sig)
    return " ".join(f"{f}={b[f]}" for f in REGIME_FIELDS)


def parse_regime(key: str) -> dict | None:
    """Inverse of regime_key, fail-soft: the bucketed spelling back to a
    raw signal dict (percent fields back to fractions), such that
    regime_key(parse_regime(k)) == k — the CLI and the gate re-enter the
    policy through the same spelling the store recorded."""
    out: dict = {}
    try:
        for tok in str(key).split():
            f, v = tok.split("=", 1)
            out[f] = int(v)
    except ValueError:
        return None
    if set(out) != set(REGIME_FIELDS):
        return None
    for f in ("hit", "occ", "hr"):
        out[f] = out[f] / 100.0
    return out


def regime_id(key: str) -> int:
    """Stable small int for the serving.control.regime gauge (crc32 bucket
    — the dashboards need 'did the regime change', not the spelling)."""
    return zlib.crc32(key.encode()) % 10_000


def _percentile(xs, frac: float) -> float:
    if not xs:
        return 1.0
    xs = sorted(xs)
    return float(xs[min(len(xs) - 1, int(frac * len(xs)))])


def workload_signals(reqs, rate: float, *, hit: float = 0.0,
                     occ: float = 0.0, q: int = 0, hr: float = 1.0) -> dict:
    """Regime signals from a workload INTENT: `reqs` is the seeded arrival
    list ((t, prompt, max_new) tuples) a knob sweep is about to
    offer. Runtime signals default to the quiet values unless the caller
    measured them (the sweep passes the hand-flag reference pass's)."""
    plens = [len(p) for _, p, _ in reqs]
    outs = [int(mn) for _, _, mn in reqs]
    return {"rate": rate, "p50": _percentile(plens, 0.50),
            "p95": _percentile(plens, 0.95),
            "out": _percentile(outs, 0.50),
            "hit": hit, "occ": occ, "q": q, "hr": hr}


def observe(engine, *, window: dict | None = None) -> dict:
    """Regime signals from a LIVE engine. `window` is the controller's
    previous-tick cursor ({"t": perf_counter, "rid": next_rid}) so the
    arrival rate is the rate over the last epoch, not over the engine's
    lifetime; without one the rate falls back to 1/s (boot regime).

    Reads only what the engine already tracks — stats counters, the
    request table, the pool — so an observation is a handful of dict
    reads, cheap enough for the shadow-mode 0% overhead budget."""
    import time

    now = time.perf_counter()
    st = engine.stats
    denom = st["prefix_hit_tokens"] + st["prefill_tokens_computed"]
    hit = st["prefix_hit_tokens"] / denom if denom else 0.0
    occ = engine.pool.pages_in_use / engine.pool.num_pages
    q = len(engine._waiting)
    rate = 1.0
    if window and now > window.get("t", now):
        rate = max(0.0, (engine._next_rid - window.get("rid", 0))
                   / (now - window["t"]))
    reqs = list(engine.requests.values())[-64:]
    plens = [r.prompt_len for r in reqs]
    outs = [r.max_new_tokens for r in reqs]
    hr = 1.0
    floor_ms = getattr(engine, "shed_ttft_p99_ms", 0.0)
    if floor_ms and floor_ms > 0:
        # headroom under an armed TTFT floor: tripped floor = 0 headroom
        hr = 0.0 if engine._overload_signals().get("ttft_p99_s") else 0.5
    return {"rate": rate, "p50": _percentile(plens, 0.50),
            "p95": _percentile(plens, 0.95),
            "out": _percentile(outs, 0.50),
            "hit": hit, "occ": occ, "q": q, "hr": hr}
