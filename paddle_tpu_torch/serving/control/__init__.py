"""Learned serving control (the JAX package's serving/control/).

The kernel cost-model loop (store -> ridge prior -> confidence-gated
decision, tuning/learned/) generalized from (op-shape, kernel-arm) -> runtime
to (traffic-regime, knob-config) -> goodput:

  regime.py     — the regime featurizer: arrival rate, prompt/output
                  percentiles, prefix-hit rate, occupancy, queue depth,
                  SLO headroom, folded into one canonical spelling;
  knobs.py      — the knob space (batch geometry, draft k, shed floors,
                  sched policy, prefill:decode split) and its canonical
                  arm spelling;
  policy.py     — the ridge-tier proposal over the shared measurement
                  store/model, hand flags as the gated fallback;
  controller.py — the bounded online actuator: epoch ticks, shadow vs
                  apply, safe-boundary staging via engine.propose_config.

Modes (FLAGS_serve_control_mode): `off` — hand flags, no observation;
`shadow` (default) — observe regimes, propose, log and count, never
touch a knob; `apply` — stage confident proposals for adoption at the
next idle gap / epoch boundary.
"""
from __future__ import annotations

from . import controller, knobs, policy, regime
from .controller import Controller, engine_knobs
from .knobs import (ACTUATABLE, KNOB_FIELDS, engine_kwargs, hand_knobs,
                    knob_key, parse_knobs, sweep_arms)
from .policy import (CONTROL_OP, get_model, invalidate_model_cache, mode,
                     model_path, propose, record_row, role_split_prior,
                     store_path)
from .regime import (REGIME_FIELDS, bucket_signals, observe, parse_regime,
                     regime_id, regime_key, workload_signals)

__all__ = [
    "controller", "knobs", "policy", "regime",
    "Controller", "engine_knobs",
    "ACTUATABLE", "KNOB_FIELDS", "engine_kwargs", "hand_knobs", "knob_key",
    "parse_knobs", "sweep_arms",
    "CONTROL_OP", "get_model", "invalidate_model_cache", "mode",
    "model_path", "propose", "record_row", "role_split_prior", "store_path",
    "REGIME_FIELDS", "bucket_signals", "observe", "parse_regime",
    "regime_id", "regime_key",
    "workload_signals",
]
