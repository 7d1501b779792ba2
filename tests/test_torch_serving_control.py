"""The port's learned serving control (paddle_tpu_torch/serving/control/)
and the engine's EngineConfig on the CPU: the control plane's pure
functions held against the JAX package's (regime and knob keys,
`sweep_arms`, store rows either package reads, the trained model's bytes
and proposals, `role_split_prior`), the confidence-gate fallbacks, the
actuator's rails (a staged config adopts only at an idle boundary, a
geometry change re-runs `warmup_decode` and leaves no cold decode
signature on the serving path, shadow mode never applies), and the
router's placement costs."""
import pytest

from torch_serving_parity import drain, port_engine, prompt

from paddle_tpu import flags as jflags
from paddle_tpu.serving import control as j_control
from paddle_tpu.tuning import learned as j_learned
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.serving import FleetRouter
from paddle_tpu_torch.serving import control as sv_control
from paddle_tpu_torch.serving.control import controller as sv_controller
from paddle_tpu_torch.serving.control import policy as sv_policy
from paddle_tpu_torch.tuning import learned
from paddle_tpu_torch.tuning.learned import features

ARM_FAST = {"mi": 8, "dk": 0, "pc": 1, "sp": 0,
            "sq": 8, "so": 95, "da": 2, "pd": 0}
ARM_HAND = {"mi": 4, "dk": 0, "pc": 1, "sp": 0,
            "sq": 8, "so": 95, "da": 2, "pd": 0}
ARM_SLOW = {"mi": 2, "dk": 0, "pc": 1, "sp": 1,
            "sq": 4, "so": 90, "da": 4, "pd": 0}

# eight regimes spanning every feature axis, so a mid signal lands inside
# the trained envelope (the gate refuses extrapolations)
_REGIMES = [
    dict(rate=2, p50=8, p95=16, out=4, hit=0.0, occ=0.05, q=0, hr=1.0),
    dict(rate=4, p50=8, p95=16, out=8, hit=0.2, occ=0.10, q=1, hr=1.0),
    dict(rate=8, p50=16, p95=32, out=4, hit=0.4, occ=0.20, q=2, hr=0.5),
    dict(rate=16, p50=16, p95=32, out=8, hit=0.6, occ=0.30, q=4, hr=1.0),
    dict(rate=32, p50=32, p95=64, out=16, hit=0.8, occ=0.50, q=8, hr=0.0),
    dict(rate=64, p50=32, p95=64, out=4, hit=0.9, occ=0.70, q=2, hr=0.5),
    dict(rate=128, p50=8, p95=16, out=8, hit=0.5, occ=0.80, q=1, hr=1.0),
    dict(rate=256, p50=16, p95=32, out=16, hit=0.3, occ=0.90, q=0, hr=1.0),
]
_SIG_MID = dict(rate=48, p50=16, p95=32, out=8, hit=0.5, occ=0.4, q=2,
                hr=1.0)

_CTRL_FLAGS = ("serve_control_mode", "serve_control_store",
               "serve_control_model", "serve_control_conf",
               "serve_control_epoch_s", "tuning_record",
               "tuning_measurements", "tuning_model", "tuning_mode",
               "disagg_prefill_replicas")


class _BothFlags:
    """set_flags on both packages (the parity calls read each its own)."""

    @staticmethod
    def set_flags(values):
        tflags.set_flags(values)
        jflags.set_flags(values)


@pytest.fixture
def ctrl_flags():
    snap_t = {k: tflags.get_flag(k) for k in _CTRL_FLAGS}
    snap_j = {k: jflags.get_flag(k) for k in _CTRL_FLAGS}
    yield _BothFlags
    tflags.set_flags(snap_t)
    jflags.set_flags(snap_j)
    sv_control.invalidate_model_cache()
    j_control.invalidate_model_cache()


def _seed_store(path, flags):
    """A deterministic store: goodput = mult * (10 + rate), ARM_FAST 2x
    ARM_SLOW at every key, written by the port and read back by both
    packages."""
    flags.set_flags({"tuning_record": "on"})
    for sig in _REGIMES:
        for arm, mult in ((ARM_FAST, 2.0), (ARM_HAND, 1.5), (ARM_SLOW, 1.0)):
            assert sv_control.record_row(sig, arm, mult * (10.0 + sig["rate"]),
                                         source="sweep", tool=True, path=path)
    return list(learned.iter_records(path))


def _engine(**kw):
    kw.setdefault("pool_pages", 32)
    kw.setdefault("max_inflight", 2)
    return port_engine(**kw)


# -- spellings, against the JAX package --------------------------------------

def test_regime_key_round_trip_and_equals_jax():
    key = sv_control.regime_key(_SIG_MID)
    sig = sv_control.parse_regime(key)
    assert sig is not None and sv_control.regime_key(sig) == key
    assert sv_control.parse_regime("rate=8 p50=16") is None
    assert sv_control.parse_regime("not a regime") is None
    for s in _REGIMES + [_SIG_MID]:
        assert sv_control.regime_key(s) == j_control.regime_key(s)
        assert sv_control.regime_id(sv_control.regime_key(s)) \
            == j_control.regime_id(j_control.regime_key(s))
    reqs = [(0.0, prompt(i, 3 + i), 4 + i) for i in range(6)]
    assert sv_control.workload_signals(reqs, 12.0, hit=0.3) \
        == j_control.workload_signals(reqs, 12.0, hit=0.3)


def test_regime_key_featurizes():
    key = sv_control.regime_key(_SIG_MID)
    f = features.featurize("serving.control", key, "-")
    assert len(f) == len(features.feature_names("serving.control")) == 8


def test_knob_key_round_trip_and_equals_jax():
    key = sv_control.knob_key(ARM_FAST)
    assert key == j_control.knob_key(ARM_FAST)
    assert sv_control.parse_knobs(key) == ARM_FAST
    assert sv_control.parse_knobs("mi=4 dk=0") is None
    assert sv_control.parse_knobs("conv:igemm") is None
    assert sv_control.hand_knobs(mi=3) == j_control.hand_knobs(mi=3)
    assert sv_control.engine_kwargs(ARM_SLOW) \
        == j_control.engine_kwargs(ARM_SLOW)


def test_sweep_arms_deterministic_hand_first_and_equal_jax():
    a1 = sv_control.sweep_arms(6, seed=3, include=ARM_HAND)
    assert a1 == sv_control.sweep_arms(6, seed=3, include=ARM_HAND)
    assert a1 == j_control.sweep_arms(6, seed=3, include=ARM_HAND)
    assert a1[0] == ARM_HAND
    keys = [sv_control.knob_key(a) for a in a1]
    assert len(set(keys)) == len(keys)
    assert len({a["mi"] for a in a1}) >= 2


def test_live_regime_observation_equals_jax_spelling():
    """`observe` on a port engine and on the JAX engine after the same
    requests spells the same regime (the window's rate pinned)."""
    from torch_serving_parity import jax_engine

    sigs = []
    for eng, control in ((_engine(), sv_control),
                         (jax_engine(pool_pages=32, max_inflight=2),
                          j_control)):
        drain(eng, [prompt(s, 5 + s % 3) for s in range(3)], 3)
        sigs.append(control.regime_key(dict(control.observe(eng), rate=4)))
    assert sigs[0] == sigs[1]


# -- the store and the trained model -----------------------------------------

def test_store_row_shape_and_jax_reads_it(tmp_path, ctrl_flags):
    store = str(tmp_path / "ctrl.jsonl")
    recs = _seed_store(store, ctrl_flags)
    assert len(recs) == 3 * len(_REGIMES)
    rec = recs[0]
    assert rec["op"] == "serving.control" and rec["dtype"] == "-"
    assert sv_control.parse_knobs(rec["arm"]) is not None
    assert sv_control.parse_regime(rec["shape_key"]) is not None
    assert rec["median_s"] == pytest.approx(
        1.0 / (2.0 * (10.0 + _REGIMES[0]["rate"])))
    assert list(j_learned.iter_records(store)) == recs


def test_record_row_gating(tmp_path, ctrl_flags):
    store = str(tmp_path / "gated.jsonl")
    ctrl_flags.set_flags({"tuning_record": "off"})
    assert not sv_control.record_row(_SIG_MID, ARM_FAST, 100.0, tool=True,
                                     path=store)
    ctrl_flags.set_flags({"tuning_record": "on"})
    assert not sv_control.record_row(_SIG_MID, ARM_FAST, 0.0, tool=True,
                                     path=store)
    assert sv_control.record_row(_SIG_MID, ARM_FAST, 100.0, tool=True,
                                 path=store)
    ctrl_flags.set_flags({"tuning_record": "auto", "tuning_mode": "off"})
    assert not sv_control.record_row(_SIG_MID, ARM_FAST, 100.0, path=store)


def test_trained_model_bytes_and_proposals_equal_jax(tmp_path, ctrl_flags):
    """The same store trains the same model file, byte for byte, in both
    packages; each package's model proposes the 2x arm for the mid
    regime."""
    store = str(tmp_path / "ctrl.jsonl")
    recs = _seed_store(store, ctrl_flags)
    m1 = learned.train_model(recs, seed=0)
    m2 = j_learned.train_model(list(j_learned.iter_records(store)), seed=0)
    p1, p2 = str(tmp_path / "m1.json"), str(tmp_path / "m2.json")
    learned.save_model(m1, p1)
    j_learned.save_model(m2, p2)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    assert m1["groups"]["serving.control|cpu"]["holdout"]["rank_acc"] >= 0.6
    ctrl_flags.set_flags({"serve_control_mode": "shadow"})
    k1, i1 = sv_control.propose(_SIG_MID, model=learned.load_model(p2))
    k2, i2 = j_control.propose(_SIG_MID, model=m2)
    assert (k1, i1["tier"]) == (k2, i2["tier"]) == (ARM_FAST, "learned")
    assert i1["times"] == pytest.approx(i2["times"])


def test_confidence_gate_fallback_ladder(tmp_path, ctrl_flags):
    store = str(tmp_path / "ctrl.jsonl")
    model = learned.train_model(_seed_store(store, ctrl_flags), seed=0)
    hand = sv_control.hand_knobs()
    ctrl_flags.set_flags({"serve_control_mode": "off"})
    assert sv_control.propose(_SIG_MID, model=model) \
        == (hand, {"tier": "hand", "reason": "off"})
    ctrl_flags.set_flags({"serve_control_mode": "shadow",
                          "serve_control_model": str(tmp_path / "no.json")})
    sv_control.invalidate_model_cache()
    k, info = sv_control.propose(_SIG_MID)
    assert (k, info["reason"]) == (hand, "no_model")
    k, info = sv_control.propose(_SIG_MID, model=model, dev="NVIDIA H100")
    assert (k, info["reason"]) == (hand, "no_group")
    ctrl_flags.set_flags({"serve_control_conf": 1.01})
    k, info = sv_control.propose(_SIG_MID, model=model)
    assert (k, info["reason"]) == (hand, "accuracy")


# -- the actuator's rails ----------------------------------------------------

def test_staged_config_adopts_only_at_idle_boundary():
    eng = _engine()
    eng.warmup_decode(24)
    eng.submit([1, 2, 3], 4)
    eng.step()
    assert eng.propose_config({"mi": 4, "sq": 16}) is True
    eng.step()
    assert eng.max_inflight == 2 and eng.shed_queue_depth == 0
    while eng.has_work():
        eng.step()
    eng.submit([4, 5, 6], 4)
    assert eng.max_inflight == 4 and eng.shed_queue_depth == 16
    assert eng.stats["control.applies"] == 1
    assert eng.stats["control.rewarmups"] == 1
    while eng.has_work():
        eng.step()


def test_rewarmup_leaves_no_cold_decode_signature():
    """The port's counterpart of the JAX package's zero-compiles contract:
    after an adoption that moved the bucket geometry re-ran the warmup,
    every decode signature the serving steps hit was warmed. Without the
    re-warmup the widened batch's buckets would be cold."""
    eng = _engine()
    assert eng.warmup_decode(24) == 2 * 4   # batch {1, 2} x pages {1..8}
    drain(eng, [[1, 2, 3]], 4)
    eng.propose_config({"mi": 4})
    eng.submit([7, 8, 9], 4)
    assert eng.max_inflight == 4
    assert eng.stats["control.rewarmups"] == 1
    for i in range(3):
        eng.submit([10 + i, 2, 3, 4, 5], 4)
    eng.run_until_drained()
    assert any(bb == 4 for bb, _ in eng.stats["decode_signatures"])
    assert eng.stats["cold_decode_signatures"] == set()
    eng._warm_sigs = {(1, 1)}   # as if the re-warmup had not run
    drain(eng, [[1, 2, 3, 4, 5]] * 3, 4)
    assert eng.stats["cold_decode_signatures"]


def test_warmup_moves_no_engine_state():
    """Masked warmup rows write nothing: the tokens after a warmup equal a
    cold engine's, and the pool's pages are all free."""
    prompts = [prompt(s, 6) for s in (1, 2, 3)]
    want, _ = drain(_engine(prefix_cache=False), prompts, 5)
    eng = _engine(prefix_cache=False, draft_k=2)
    eng.warmup_decode(16)
    assert eng.pool.free_count == eng.pool.num_pages
    got, _ = drain(eng, prompts, 5)
    assert got == want


def test_same_config_proposal_clears_pending():
    eng = _engine()
    assert eng.propose_config({"mi": 4}) is True
    assert eng._pending_ecfg is not None
    assert eng.propose_config({"mi": 2}) is False
    assert eng._pending_ecfg is None
    assert eng.maybe_adopt_config() is False
    assert eng.stats["control.applies"] == 0


def test_propose_config_clamps_and_ignores_construction_knobs():
    eng = _engine()
    before = sv_control.engine_knobs(eng)
    eng.propose_config({"mi": 0, "dk": -3, "so": 250,
                        "pc": 1 - before["pc"], "sp": 1 - before["sp"]})
    assert eng.maybe_adopt_config() is True
    assert (eng.max_inflight, eng.draft_k, eng.shed_occupancy) == (1, 0, 1.0)
    after = sv_control.engine_knobs(eng)
    assert (after["pc"], after["sp"]) == (before["pc"], before["sp"])


def _fake_proposal(monkeypatch):
    monkeypatch.setattr(
        sv_policy, "propose",
        lambda sig, **kw: (dict(ARM_FAST),
                           {"tier": "learned", "arm": "fake", "times": {}}))


def test_controller_shadow_never_applies(ctrl_flags, monkeypatch):
    ctrl_flags.set_flags({"serve_control_mode": "shadow"})
    eng = _engine()
    _fake_proposal(monkeypatch)
    ctrl = sv_controller.Controller(epoch_s=1.0)
    assert ctrl.tick(eng, now=100.0) is False
    assert ctrl.tick(eng, now=100.5) is False
    assert ctrl.tick(eng, now=101.5) is True
    assert ctrl.last_info[id(eng)]["tier"] == "learned"
    assert eng._pending_ecfg is None
    assert eng.stats["control.applies"] == 0


def test_controller_apply_stages_then_engine_adopts(ctrl_flags, monkeypatch):
    ctrl_flags.set_flags({"serve_control_mode": "apply"})
    eng = _engine()
    eng.warmup_decode(24)
    _fake_proposal(monkeypatch)
    ctrl = sv_controller.Controller(epoch_s=1.0)
    ctrl.tick(eng, now=100.0)
    assert ctrl.tick(eng, now=101.5) is True
    assert eng._pending_ecfg is not None and eng.max_inflight == 2
    eng.submit([1, 2, 3], 2)
    assert (eng.max_inflight, eng.shed_queue_depth, eng.degrade_after) == (
        ARM_FAST["mi"], ARM_FAST["sq"], ARM_FAST["da"])
    eng.run_until_drained()
    assert eng.stats["cold_decode_signatures"] == set()


def test_controller_off_mode_skips_epochs(ctrl_flags):
    ctrl_flags.set_flags({"serve_control_mode": "off"})
    eng = _engine()
    ctrl = sv_controller.Controller(epoch_s=1.0)
    ctrl.tick(eng, now=100.0)
    assert ctrl.tick(eng, now=105.0) is False


def test_engine_config_snapshot_is_single_source(ctrl_flags):
    eng = _engine(shed_queue_depth=8, shed_occupancy=0.95, degrade_after=2)
    cfg = eng.engine_config
    assert (cfg.max_inflight, cfg.shed_queue_depth, cfg.shed_occupancy,
            cfg.degrade_after) == (2, 8, 0.95, 2)
    assert cfg.bucket_geometry() == (2, 0)
    tflags.set_flags({"serving_shed_queue_depth": 3})   # a flag flip mid-run
    try:
        assert eng.shed_queue_depth == 8
    finally:
        tflags.set_flags({"serving_shed_queue_depth": 0})


# -- the fleet: the role prior and placement costs ---------------------------

def _pd_row(pd, median_s, fleet_n=3):
    return {"op": "serving.control", "shape_key": "r",
            "arm": sv_control.knob_key(dict(ARM_HAND, pd=pd)),
            "median_s": median_s, "fleet_n": fleet_n}


def test_role_split_prior_picks_best_recorded_pd(ctrl_flags):
    ctrl_flags.set_flags({"serve_control_mode": "shadow"})
    rows = [_pd_row(1, 0.002), _pd_row(1, 0.002),
            _pd_row(2, 0.004), _pd_row(2, 0.005)]
    got = sv_control.role_split_prior(3, records=rows)
    assert got == j_control.role_split_prior(3, records=rows)
    assert (got[0], got[1]["tier"]) == (1, "learned")
    n_pre, info = sv_control.role_split_prior(
        3, records=[_pd_row(1, 0.001, fleet_n=4)])
    assert (n_pre, info["reason"]) == (0, "no_rows")


def test_role_split_prior_fallbacks(ctrl_flags):
    ctrl_flags.set_flags({"serve_control_mode": "shadow",
                          "disagg_prefill_replicas": 1})
    cases = [([], "no_rows"),
             ([_pd_row(1, 0.002), _pd_row(2, 0.004)], "hand_best"),
             ([_pd_row(1, 0.00100), _pd_row(2, 0.00097)], "tie_band")]
    for rows, reason in cases:
        got = sv_control.role_split_prior(3, records=rows)
        assert got == j_control.role_split_prior(3, records=rows)
        assert (got[0], got[1]["reason"]) == (1, reason)
    ctrl_flags.set_flags({"serve_control_mode": "off"})
    assert sv_control.role_split_prior(3, records=cases[2][0]) \
        == (1, {"tier": "hand", "reason": "off"})


def test_router_placement_costs_neutral_unless_apply(ctrl_flags):
    ctrl_flags.set_flags({"serve_control_mode": "shadow"})
    with FleetRouter(lambda role=None: _engine(), 2, heartbeat_s=30.0) as fr:
        assert set(fr._placement_costs(fr.replicas).values()) == {1.0}
        ctrl_flags.set_flags({"serve_control_mode": "apply"})
        e0, e1 = fr.replicas[0].engine, fr.replicas[1].engine
        e0._ctrl.last_cost[id(e0)] = 0.002
        assert set(fr._placement_costs(fr.replicas).values()) == {1.0}
        e1._ctrl.last_cost[id(e1)] = 0.004
        costs = fr._placement_costs(fr.replicas)
        assert costs[0] == pytest.approx(0.002)
        assert costs[1] == pytest.approx(0.004)
