"""Seeded-deterministic ridge regression over the hand features.

One tiny linear model per (op, device_kind, arm): standardized features ->
log(median seconds), closed-form ridge solve (numpy only — the tuner must
never grow a dependency). Per-arm time models compose into an arm RANKING
(argmin of predicted times), which is all the policy tier consumes — the
absolute times only have to be monotone enough to order two lowerings.

The artifact (MODEL_SCHEMA = 1) is a single JSON file next to the tuning
DB, written atomically (temp+rename, the checkpoint discipline):

    {
      "schema": 1, "seed": 0, "ridge": 1.0, "holdout_frac": 0.25,
      "groups": {
        "conv2d|cpu": {
          "decision_field": "lowering",
          "feature_names": [...],            # refuse drift at predict time
          "mean": [...], "std": [...],       # train standardization
          "fmin": [...], "fmax": [...],      # extrapolation envelope
          "arms": {"direct": {"w": [...]}, "igemm": {"w": [...]}},
          "n_train_keys": 21, "holdout_keys": ["<shape_key>|<dtype>", ...],
          "holdout": {"rank_acc": 0.83, "analytic_rank_acc": 0.5,
                      "mae_log": 0.21, "n": 6}
        }, ...
      }
    }

Confidence gates at predict time (both must pass, else the caller falls
back to the analytic prior — arXiv:2008.01040's lesson that a learned
model is a prior, not an oracle):

  * holdout gate — the group's held-out arm-ranking accuracy must clear
    RANK_ACC_FLOOR (a model that cannot rank its own holdout has no
    business ranking production shapes);
  * envelope gate — every feature must lie within the training range
    widened by ENVELOPE_MARGIN of its span (linear-in-log models
    extrapolate confidently and wrongly; a 10x-beyond-envelope shape is
    rejected, not predicted).

Cross-device transfer: when no group exists for the current device_kind,
the same-op group from another device (CPU-collected data, typically) is
used for arm RANKING only — relative ordering transfers across devices far
better than absolute times (the TVM transfer observation), and both gates
still apply.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from . import features

MODEL_SCHEMA = 1
RANK_ACC_FLOOR = 0.6     # holdout confidence gate
ENVELOPE_MARGIN = 0.25   # fraction of the train span features may overhang
RANK_TIE_BAND = 0.05     # near-ties count as correctly ranked (gate.py band)
MIN_GROUP_KEYS = 6       # fewer measured keys cannot support a holdout
MIN_ARM_SAMPLES = 3      # fewer rows than this cannot fit an arm

__all__ = ["MODEL_SCHEMA", "RANK_ACC_FLOOR", "ENVELOPE_MARGIN",
           "train_model", "eval_model", "save_model", "load_model",
           "predict_times", "group_samples"]


def group_samples(records) -> dict:
    """Fold store records into {(op, device_kind): {(shape_key, dtype):
    {arm: median_s}}}. Multiple records of one (key, arm) reduce by median
    — repeated sweeps refine, not duplicate. Non-featurizable op families
    and unusable rows are dropped."""
    acc: dict = {}
    for rec in records:
        op = rec.get("op")
        if op not in features.FAMILIES:
            continue
        t = rec.get("median_s")
        if not isinstance(t, (int, float)) or t <= 0:
            continue
        g = acc.setdefault((op, str(rec.get("device_kind", "cpu"))), {})
        k = (str(rec.get("shape_key", "")), str(rec.get("dtype", "")))
        g.setdefault(k, {}).setdefault(str(rec["arm"]), []).append(float(t))
    out: dict = {}
    for gk, keys in acc.items():
        out[gk] = {k: {a: float(np.median(ts)) for a, ts in arms.items()}
                   for k, arms in keys.items()}
    return out


def _ridge_fit(X: np.ndarray, y: np.ndarray, ridge: float) -> np.ndarray:
    """Closed-form ridge with an unpenalized bias column (penalizing the
    intercept would drag every prediction toward 1 second)."""
    Xb = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
    reg = ridge * np.eye(Xb.shape[1])
    reg[-1, -1] = 0.0
    return np.linalg.solve(Xb.T @ Xb + reg, Xb.T @ y)


def _predict_arm(w, x_std) -> float:
    xb = np.concatenate([x_std, [1.0]])
    return float(np.exp(np.clip(xb @ np.asarray(w, dtype=np.float64),
                                -60.0, 60.0)))


def _rank_correct(times: dict, picked: str | None) -> bool:
    """A pick is correct when its measured time is within RANK_TIE_BAND of
    the measured best — the same near-tie tolerance the A/B verdicts use
    (a 'wrong' pick inside machine noise is not a ranking error)."""
    if picked is None or picked not in times:
        return False
    return times[picked] <= min(times.values()) * (1.0 + RANK_TIE_BAND)


def train_model(records, seed: int = 0, holdout_frac: float = 0.25,
                ridge: float = 1.0) -> dict:
    """Fit every (op, device_kind) group with enough measured keys.
    Deterministic for a given (records, seed): keys are sorted before the
    seeded permutation, so CI retrains reproduce the committed artifact
    byte-for-byte. The holdout split is BY KEY (all arms of a shape stay
    on one side — splitting arms of one shape across the fence would leak
    the very timings the holdout is supposed to be blind to)."""
    groups = {}
    for (op, dev), keys in sorted(group_samples(records).items()):
        names = features.feature_names(op)
        usable = []
        for k in sorted(keys):
            shape_key, dtype = k
            f = features.featurize(op, shape_key, dtype)
            arms = {a: t for a, t in keys[k].items() if t > 0}
            if f is not None and len(arms) >= 2:
                usable.append((k, np.asarray(f, dtype=np.float64), arms))
        if len(usable) < MIN_GROUP_KEYS:
            continue
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(usable))
        n_hold = max(1, int(round(holdout_frac * len(usable))))
        hold_idx = set(int(i) for i in perm[:n_hold])
        train = [u for i, u in enumerate(usable) if i not in hold_idx]
        hold = [u for i, u in enumerate(usable) if i in hold_idx]
        if len(train) < MIN_GROUP_KEYS - 1:
            continue
        Xtr = np.stack([f for _, f, _ in train])
        mean = Xtr.mean(axis=0)
        std = Xtr.std(axis=0)
        std[std < 1e-12] = 1.0
        arms_w = {}
        for arm in sorted({a for _, _, arms in train for a in arms}):
            rows = [(f, arms[arm]) for _, f, arms in train if arm in arms]
            if len(rows) < MIN_ARM_SAMPLES:
                continue
            Xa = (np.stack([f for f, _ in rows]) - mean) / std
            ya = np.log(np.asarray([t for _, t in rows]))
            arms_w[arm] = {"w": [round(float(v), 10)
                                 for v in _ridge_fit(Xa, ya, ridge)]}
        if len(arms_w) < 2:
            continue  # one fitted arm cannot rank anything
        group = {
            "decision_field": features.decision_field(op),
            "feature_names": list(names),
            "mean": [round(float(v), 10) for v in mean],
            "std": [round(float(v), 10) for v in std],
            "fmin": [round(float(v), 10) for v in Xtr.min(axis=0)],
            "fmax": [round(float(v), 10) for v in Xtr.max(axis=0)],
            "arms": arms_w,
            "n_train_keys": len(train),
            "holdout_keys": sorted(f"{k[0]}|{k[1]}" for k, _, _ in hold),
        }
        group["holdout"] = _eval_group(op, group, hold)
        groups[f"{op}|{dev}"] = group
    return {"schema": MODEL_SCHEMA, "seed": int(seed), "ridge": float(ridge),
            "holdout_frac": float(holdout_frac), "groups": groups}


def _group_predict(group: dict, f: np.ndarray) -> dict:
    x = (f - np.asarray(group["mean"])) / np.asarray(group["std"])
    return {arm: _predict_arm(spec["w"], x)
            for arm, spec in group["arms"].items()}


def _eval_group(op: str, group: dict, hold) -> dict:
    """Holdout metrics: learned vs analytic arm-ranking accuracy on the
    SAME keys, plus mean |log t_pred - log t_meas| over measured arms."""
    n = correct = analytic_correct = 0
    abs_log_err = []
    for (shape_key, dtype), f, arms in hold:
        pred = _group_predict(group, np.asarray(f, dtype=np.float64))
        scored = {a: pred[a] for a in arms if a in pred}
        if len(scored) < 2:
            continue
        n += 1
        pick = min(sorted(scored), key=lambda a: scored[a])
        correct += _rank_correct(arms, pick)
        analytic_correct += _rank_correct(
            arms, features.analytic_decision(op, shape_key, dtype))
        abs_log_err.extend(abs(np.log(pred[a]) - np.log(arms[a]))
                           for a in scored)
    return {
        "n": n,
        "rank_acc": round(correct / n, 4) if n else None,
        "analytic_rank_acc": round(analytic_correct / n, 4) if n else None,
        "mae_log": round(float(np.mean(abs_log_err)), 4)
        if abs_log_err else None,
    }


def eval_model(model: dict, records) -> dict:
    """Re-score every group against its RECORDED holdout keys in a dataset
    — the gate.py --costmodel path: committed model + committed dataset
    must reproduce (and clear) the training-time holdout numbers."""
    samples = group_samples(records)
    out = {}
    for gkey, group in sorted(model.get("groups", {}).items()):
        op, dev = gkey.split("|", 1)
        keys = samples.get((op, dev), {})
        hold = []
        want = set(group.get("holdout_keys", []))
        for (shape_key, dtype), arms in sorted(keys.items()):
            if f"{shape_key}|{dtype}" not in want:
                continue
            f = features.featurize(op, shape_key, dtype)
            if f is not None and len(arms) >= 2:
                hold.append(((shape_key, dtype),
                             np.asarray(f, dtype=np.float64), arms))
        out[gkey] = _eval_group(op, group, hold)
    return {"groups": out}


def predict_times(model: dict, op: str, shape_key: str, dtype: str,
                  device_kind: str, gated: bool = True):
    """Per-arm predicted times for one key, or (None, {"reason": ...}).
    With gated=True (the policy tier) the holdout + envelope confidence
    gates apply; gated=False is the eval path's raw prediction."""
    groups = model.get("groups", {})
    gkey = f"{op}|{device_kind}"
    info: dict = {}
    group = groups.get(gkey)
    if group is None:
        # cross-device transfer: same-op group from another device ranks
        # arms (CPU-first — the committed dataset's device)
        others = sorted(g for g in groups if g.split("|", 1)[0] == op)
        others.sort(key=lambda g: (not g.endswith("|cpu"), g))
        if not others:
            return None, {"reason": "no_group"}
        group = groups[others[0]]
        info["transfer_from"] = others[0]
    f = features.featurize(op, shape_key, dtype)
    if f is None:
        return None, {"reason": "features"}
    names = features.feature_names(op)
    if list(group.get("feature_names", [])) != list(names):
        return None, {"reason": "feature_drift"}
    fv = np.asarray(f, dtype=np.float64)
    if gated:
        hold = group.get("holdout", {})
        acc = hold.get("rank_acc")
        if acc is None or acc < RANK_ACC_FLOOR:
            return None, {"reason": "accuracy", **info}
        fmin = np.asarray(group["fmin"])
        fmax = np.asarray(group["fmax"])
        span = np.maximum(fmax - fmin, 1e-9)
        lo = fmin - ENVELOPE_MARGIN * span
        hi = fmax + ENVELOPE_MARGIN * span
        if bool(np.any(fv < lo)) or bool(np.any(fv > hi)):
            return None, {"reason": "envelope", **info}
    times = _group_predict(group, fv)
    info["decision_field"] = group.get(
        "decision_field", features.decision_field(op))
    return times, info


def save_model(model: dict, path: str) -> str:
    """Atomic temp+rename write, sorted keys — retraining on identical data
    with an identical seed reproduces the artifact byte-for-byte."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".costmodel.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(model, f, indent=1, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_model(path: str) -> dict | None:
    """None for a missing file (no model yet — the learned tier simply
    does not exist); ValueError for a present-but-unusable one (the policy
    layer warns once and fails open to the analytic tier, the tuning-DB
    read discipline)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable ({e})") from e
    if not isinstance(raw, dict):
        raise ValueError("top level is not an object")
    if raw.get("schema") != MODEL_SCHEMA:
        raise ValueError(f"schema {raw.get('schema')!r} != {MODEL_SCHEMA}")
    if not isinstance(raw.get("groups"), dict):
        raise ValueError("'groups' is not an object")
    return raw
