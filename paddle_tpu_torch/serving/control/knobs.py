"""The serving knob space and its canonical arm spelling.

A knob config is a flat int dict; its canonical spelling is the ARM name
under which the measurement store records it (`op="serving.control"`), so
"which config is fastest for this regime" is literally the kernel tier's
"which lowering is fastest for this shape" with different nouns.

Fields (all ints, fixed order):

  mi — max_inflight (decode batch ceiling)   dk — speculative draft k
  pc — prefix cache on/off                   sp — sched policy (0 fcfs, 1 sjf)
  sq — shed queue-depth floor (0 = off)      so — shed occupancy floor, %
  da — degrade_after (ladder patience)       pd — disagg prefill replicas

ONLINE-ACTUATABLE vs construction-only: mi/dk/sq/so/da can change on a
live engine (mi/dk change the decode bucket lattice, which is why the
actuator re-runs `warmup_decode`); pc and sp would rebuild live objects
(the cache trie, the scheduler) and pd re-roles a fleet — those three are
proposed and logged, but only honored at construction time.
"""
from __future__ import annotations

import itertools

import numpy as np

from ... import flags

__all__ = ["KNOB_FIELDS", "ACTUATABLE", "knob_key", "parse_knobs",
           "hand_knobs", "engine_kwargs", "sweep_arms"]

KNOB_FIELDS = ("mi", "dk", "pc", "sp", "sq", "so", "da", "pd")
ACTUATABLE = ("mi", "dk", "sq", "so", "da")

# sweep candidate values per field — a deliberately small lattice around
# the hand defaults (TVM's lesson: a bounded, structured space beats an
# open-ended one at this budget)
_SWEEP_SPACE = {
    "mi": (2, 4, 8),
    "dk": (0, 2),
    "pc": (1,),
    "sp": (0, 1),
    "sq": (4, 8, 16),
    "so": (90, 95),
    "da": (1, 2, 4),
    "pd": (0,),
}


def knob_key(knobs: dict) -> str:
    """Canonical arm spelling (field order fixed, every field spelled —
    two dicts describing one config cannot mint two arms)."""
    return " ".join(f"{f}={int(knobs.get(f, 0))}" for f in KNOB_FIELDS)


def parse_knobs(arm: str) -> dict | None:
    """Inverse of knob_key, fail-soft: None for a spelling that is not a
    knob arm (the store may hold foreign rows)."""
    out = {}
    try:
        for tok in str(arm).split():
            k, v = tok.split("=", 1)
            out[k] = int(v)
    except ValueError:
        return None
    return out if set(out) == set(KNOB_FIELDS) else None


def hand_knobs(**overrides) -> dict:
    """The hand-flag config as a knob dict — the fallback every
    confidence-gated proposal resolves to, and the reference arm every
    sweep measures alongside its candidates."""
    k = {
        "mi": int(flags.get_flag("serving_max_inflight")),
        "dk": int(flags.get_flag("serving_draft_k")),
        "pc": int(bool(flags.get_flag("serving_prefix_cache"))),
        "sp": int(str(flags.get_flag("serving_sched_policy")) == "sjf"),
        "sq": int(flags.get_flag("serving_shed_queue_depth")),
        "so": int(round(100 * float(
            flags.get_flag("serving_shed_occupancy")))),
        "da": int(flags.get_flag("serving_degrade_after")),
        "pd": int(flags.get_flag("disagg_prefill_replicas")),
    }
    k.update({f: int(v) for f, v in overrides.items()})
    return k


def engine_kwargs(knobs: dict) -> dict:
    """ServingEngine ctor kwargs for one knob config (pd is fleet-level
    and does not appear — the router consumes it)."""
    return {
        "max_inflight": int(knobs["mi"]),
        "draft_k": int(knobs["dk"]),
        "prefix_cache": bool(knobs["pc"]),
        "policy": "sjf" if knobs["sp"] else "fcfs",
        "shed_queue_depth": int(knobs["sq"]),
        "shed_occupancy": knobs["so"] / 100.0,
        "degrade_after": int(knobs["da"]),
    }


def sweep_arms(n: int, seed: int = 0, include: dict | None = None) -> list:
    """`n` knob configs to sweep: a seeded latin-hypercube-style draw from
    the candidate lattice (deterministic for a given (n, seed)), with
    `include` (the hand config, typically) always first so every regime
    measures the reference arm. Returns knob dicts, no duplicates."""
    grid = [dict(zip(_SWEEP_SPACE, combo))
            for combo in itertools.product(*_SWEEP_SPACE.values())]
    grid.sort(key=knob_key)
    rng = np.random.default_rng(seed)
    picked: list[dict] = []
    seen: set[str] = set()
    if include is not None:
        picked.append(dict(include))
        seen.add(knob_key(include))
    # stratify the draw over mi (the dominant axis) so a small n still
    # spans the batch-geometry range instead of clustering by chance
    by_mi: dict[int, list] = {}
    for g in grid:
        by_mi.setdefault(g["mi"], []).append(g)
    lanes = [by_mi[m] for m in sorted(by_mi)]
    all_keys = {knob_key(g) for g in grid}
    li = 0
    while len(picked) < n and not all_keys <= seen:
        lane = lanes[li % len(lanes)]
        li += 1
        order = rng.permutation(len(lane))
        for i in order:
            k = knob_key(lane[int(i)])
            if k not in seen:
                seen.add(k)
                picked.append(dict(lane[int(i)]))
                break
    return picked[:max(1, n)]
