"""Bounded online exploration: sweep-in-production (FLAGS_tuning_mode=explore).

Consult mode leaves `candidate` DB entries forever unmeasured unless an
offline sweep (the JAX package's `tools/tune.py`; the port has none yet)
happens to visit the box.
Explore mode closes that loop from inside the running job, with the TVM
bounds (arXiv:1802.04799) that make online measurement safe:

  * paced      — at most ONE candidate is probed every
                 FLAGS_tuning_explore_every run_async steps (the probe rides
                 the window-drain idle gap at the end of run_async; steady
                 training throughput, not the probe, owns the device);
  * bounded    — each probe is a handful of tiny timed windows
                 (EXPLORE_ITERS x EXPLORE_PASSES), never an open-ended
                 sweep;
  * band-gated — a verdict is accepted ONLY outside the interference band
                 (max of the 5% floor and every arm's measured spread); a
                 tie keeps the candidate AND attaches the evidence, so a
                 later offline sweep starts from data, not zero;
  * write-equal — promotions land as `source="swept"` entries with the
                 SAME measured-evidence schema offline sweeps write
                 (db.evidence), so nothing downstream can tell who swept.

Every probe's raw windows also land in the measurement store
(source="explore"), unless FLAGS_tuning_record is 'off' — exploration grows
the learned tier's training set as a side effect, which is the whole point.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ... import flags
from ..db import evidence
from . import features, store

# the JAX package's tools/_timing.DEFAULT_BAND: margins inside 5% are
# machine noise, not a measured win
EXPLORE_BAND = 0.05
EXPLORE_ITERS = 2
EXPLORE_PASSES = 3

__all__ = ["maybe_explore", "explore_one", "reset_state",
           "EXPLORE_BAND", "EXPLORE_ITERS", "EXPLORE_PASSES"]

_lock = threading.Lock()
_state = {"steps": 0, "done": set()}


def reset_state() -> None:
    with _lock:
        _state["steps"] = 0
        _state["done"] = set()


def maybe_explore() -> dict | None:
    """The executor's per-step hook: cheap no-op outside explore mode; in
    it, every Nth step probes the next unmeasured candidate. Returns the
    probe result dict (or None) — callers ignore it; tests don't."""
    from .. import policy

    if policy.mode() != "explore":
        return None
    try:
        every = int(flags.get_flag("tuning_explore_every"))
    except (TypeError, ValueError):
        return None
    if every <= 0:
        return None
    with _lock:
        _state["steps"] += 1
        if _state["steps"] % every:
            return None
    return explore_one()


def explore_one() -> dict | None:
    """Probe the first unvisited candidate key for THIS device_kind.
    Unbuildable keys (op families without an arm builder, platform-gated
    kernels) are marked visited and skipped — explore never retries a key
    in-process, so a stuck candidate cannot eat every idle gap."""
    from .. import policy

    db = policy.get_db()
    dk = policy.device_kind()
    for key in sorted(db.entries):
        entry = db.entries[key]
        if entry.get("source") != "candidate":
            continue
        if not key.endswith("|" + dk):
            continue
        with _lock:
            if key in _state["done"]:
                continue
            _state["done"].add(key)
        out = _probe(db, key, entry)
        if out is not None:
            return out
    return None


def _probe(db, key: str, entry: dict) -> dict | None:
    from .. import policy

    parts = key.split("|")
    if len(parts) != 4:
        return None
    op, shape_key, dtype, _dev = parts
    field = features.decision_field(op)
    if field is None:
        return None
    arms = _build_arms(op, shape_key, dtype)
    if not arms or len(arms) < 2:
        return None
    measured = {a: _measure(arms[a]) for a in sorted(arms)}
    if store.recording_enabled():
        store.record_measured(key, measured, source="explore")
    base = str(entry.get("decision", {}).get(field, ""))
    if base not in measured:
        base = sorted(measured)[0]
    best = min(sorted(measured), key=lambda a: measured[a]["median_s"])
    band = max([EXPLORE_BAND] + [m["band"] for m in measured.values()])
    verdict = _verdict(measured[base]["median_s"],
                       measured[best]["median_s"], band) \
        if best != base else "retire"
    path = str(flags.get_flag("tuning_db")).strip()
    if verdict == "tie":
        # inside the band: the analytic candidate stands, but now with
        # measured evidence attached (the db.py satellite fix — candidates
        # carry times when available)
        db.put(key, entry.get("decision", {}), source="candidate",
               measured=evidence(measured),
               note="explore: tie inside band")
        result = {"key": key, "verdict": "tie", "decision": None}
    else:
        winner = best if verdict == "keep" else base
        db.put(key, {field: winner}, source="swept",
               measured=evidence(measured),
               note=f"explore: verdict={verdict} base={base}")
        _bump_promotion(op)
        result = {"key": key, "verdict": verdict, "decision": winner}
    if path:
        try:
            db.save(path)
            policy.invalidate_db_cache()
        except OSError:
            pass  # read-only FS: the in-memory entry still serves
    result["measured"] = {a: m["median_s"] for a, m in measured.items()}
    return result


def _bump_promotion(op: str) -> None:
    from . import bump_promotion

    bump_promotion(op)


def _verdict(base_s: float, cand_s: float, band: float) -> str:
    if cand_s < (1.0 - band) * base_s:
        return "keep"
    if cand_s > (1.0 + band) * base_s:
        return "retire"
    return "tie"


def _measure(fn) -> dict:
    """Tiny bounded version of tools/_timing.measure: one warmup call,
    then EXPLORE_PASSES windows of EXPLORE_ITERS calls each, each window
    ended by a device sync where the arm's output lies on a card (the JAX
    package's `jax.block_until_ready`)."""
    def done(out):
        if isinstance(out, torch.Tensor) and out.device.type == "cuda":
            torch.cuda.synchronize(out.device)

    done(fn())
    windows = []
    for _ in range(EXPLORE_PASSES):
        t0 = time.perf_counter()
        out = None
        for _ in range(EXPLORE_ITERS):
            out = fn()
        done(out)
        windows.append((time.perf_counter() - t0) / EXPLORE_ITERS)
    ws = np.asarray(windows, dtype=np.float64)
    med = float(np.median(ws))
    return {
        "median_s": med,
        "min_s": float(ws.min()),
        "windows_s": [round(float(w), 9) for w in windows],
        "band": round(float((ws.max() - ws.min()) / med), 4)
        if med > 0 else 0.0,
    }


def _build_arms(op: str, shape_key: str, dtype: str) -> dict | None:
    """Reconstruct the timed arms for one candidate key, rebuilt from the
    key alone. Only attention keys with Sq = Sk > 1 are buildable in the
    port: its conv has one route (F.conv2d), paged decode runs on K1 alone,
    and epilogue/xent have one kernel each on the card; those keys return
    None and are skipped."""
    kv = features.parse_shape_key(op, shape_key)
    if kv is None:
        return None
    try:
        if op == "attention" and kv.get("sq", 0) > 1 \
                and kv.get("sq") == kv.get("sk"):
            return _attention_arms(kv, dtype)
    except Exception:  # noqa: BLE001 - an unbuildable arm must never crash the train loop
        return None
    return None


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _attention_arms(kv: dict, dtype: str) -> dict | None:
    """Forward + backward of the port's own routes at the key's shape,
    through `_AttentionFn` with the route forced, on the device the
    decision is for (the current card, or the CPU where there is none):
    "pallas_short" (K2/K4) and "flash_bundled" (K10/K11), each where its
    kernel takes the shape. No torch-composition arm: the port runs none
    for a CUDA tensor."""
    from ...ops.attention_ops import _AttentionFn, runnable

    if dtype not in _DTYPES:
        return None
    b, nh, s, dh = kv["b"], kv["nh"], kv["sq"], kv["dh"]
    causal = bool(kv.get("causal", 0))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() else torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((b, nh, s, dh), generator=g).to(
        dev, _DTYPES[dtype]) for _ in range(4))
    sm = dh ** -0.5

    def mk(route):
        def run():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = _AttentionFn.apply(qq, kk, vv, causal, sm, route)
            return torch.autograd.grad(out, (qq, kk, vv), do)[0]
        return run

    return {r: mk(r) for r in ("pallas_short", "flash_bundled")
            if runnable(r, (b, nh, s, dh))}
