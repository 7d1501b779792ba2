"""The port's numeric guardrails (paddle_tpu_torch/resilience/guardrails.py,
the health_sentinel op, the executor's guard hooks) held against the JAX
package's on the CPU, after tests/test_guardrails.py: the guarded programs
equal the JAX package's through to_dict(); the same seeded feeds give the
same Health = [loss, gnorm, nonfinite, bad] and State = [ema, seen] within
HEALTH_RTOL (1e-6, relative, NaN where the JAX package has NaN); a NaN step
leaves SGD parameters bit for bit; the rewind's blame names the JAX
package's op and var; the replay leaves the live scope bit for bit."""
import numpy as np
import pytest
import torch

import torch_parity as tp

import jax

import paddle_tpu as jpt
import paddle_tpu.resilience as JR
from paddle_tpu import flags as jflags
import paddle_tpu_torch as tpt
import paddle_tpu_torch.resilience as TR
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.resilience.guardrails import (GUARD_HEALTH_NAME,
                                                    GUARD_STATE_NAME, H_BAD,
                                                    H_GNORM, H_NONFINITE)
from paddle_tpu_torch.weights import load_params

HEALTH_RTOL = 1e-6      # Health/State against the JAX package's, relative
# under bf16 AMP the two packages' bf16 products round apart: the loss and
# the grad norm within 3e-2 relative (tests/test_torch_amp.py's bound), the
# verdicts exactly
AMP_RTOL = 3e-2
PARAM_RTOL = 1e-6       # parameters after a few SGD steps, relative
PARAM_ATOL = 1e-7

FLAGS = ("guard_numerics", "guard_spike_factor", "max_inflight_steps",
         "check_nan_inf", "device_prefetch_depth", "guard_bad_step_budget",
         "guard_lr_backoff", "guard_max_rewinds")


@pytest.fixture
def both_flags():
    saved = [{k: f.get_flag(k) for k in FLAGS} for f in (jflags, tflags)]

    def set_both(d):
        jflags.set_flags(d)
        tflags.set_flags(d)

    yield set_both
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


def _sgd(pkg, lr=0.1, width=4):
    L = pkg["L"]
    x = L.data(name="x", shape=[width], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    loss = L.mean(L.square_error_cost(L.fc(x, size=1), y))
    pkg["pt"].optimizer.SGD(lr).minimize(loss)
    return loss


def _feed(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((8, 4)).astype(np.float32),
            "y": np.ones((8, 1), np.float32)}


def _nan_feed(seed=0):
    f = _feed(seed)
    f["x"] = f["x"].copy()
    f["x"][0, 0] = np.nan
    return f


class Pair:
    """One program built through both packages, both startups run, the
    JAX package's weights carried into the port's scope."""

    def __init__(self, fn, seed=0):
        self.j = tp.build(tp.J, fn, seed)
        self.t = tp.build(tp.T, fn, seed)
        (jm, js, self.jloss), (tm, ts, self.tloss) = self.j, self.t
        assert tm.to_dict() == jm.to_dict()
        assert ts.to_dict() == js.to_dict()
        self.jm, self.tm = jm, tm
        self.jscope, self.jexe = jpt.Scope(), jpt.Executor()
        self.jexe.run(js, scope=self.jscope)
        self.tscope, self.texe = tpt.Scope(), tpt.Executor(place="cpu")
        self.texe.run(ts, scope=self.tscope)
        load_params(self.tscope, tm, {
            p.name: np.asarray(self.jscope.find_var(p.name))
            for p in jm.all_parameters()})
        self.w = jm.all_parameters()[0].name

    def run(self, feed):
        (jl,) = self.jexe.run(self.jm, feed=feed, fetch_list=[self.jloss],
                              scope=self.jscope)
        (tl,) = self.texe.run(self.tm, feed=feed, fetch_list=[self.tloss],
                              scope=self.tscope)
        return np.asarray(jl), tl

    def var(self, name):
        return (np.asarray(self.jscope.find_var(name)),
                self.tscope.find_var(name).numpy())

    def hold_health(self, rtol=HEALTH_RTOL):
        for name in (GUARD_HEALTH_NAME, GUARD_STATE_NAME):
            j, t = self.var(name)
            np.testing.assert_allclose(t, j, rtol=rtol, atol=0,
                                       equal_nan=True, err_msg=name)
        j, t = self.var(GUARD_HEALTH_NAME)
        np.testing.assert_array_equal(t[H_NONFINITE:], j[H_NONFINITE:])
        return t


# -- in-graph sentinel: skip semantics ----------------------------------------

def test_nan_step_skipped_bit_exact(both_flags):
    both_flags({"guard_numerics": True})
    p = Pair(lambda pkg: _sgd(pkg))
    ops = [op.type for op in p.tm.global_block.ops]
    assert ops.count("health_sentinel") == 1
    assert ops.index("health_sentinel") < ops.index("sgd")

    p.run(_feed())
    h1 = p.hold_health()
    assert h1[H_BAD] == 0 and np.isfinite(h1[H_GNORM])
    w1 = p.tscope.find_var(p.w).clone()

    p.run(_nan_feed())
    h2 = p.hold_health()
    assert h2[H_NONFINITE] == 1 and h2[H_BAD] == 1
    assert torch.equal(p.tscope.find_var(p.w), w1)        # bit for bit
    j, t = p.var(p.w)
    np.testing.assert_allclose(t, j, rtol=PARAM_RTOL, atol=PARAM_ATOL)

    p.run(_feed(1))
    p.hold_health()
    assert not torch.equal(p.tscope.find_var(p.w), w1)
    j, t = p.var(p.w)
    np.testing.assert_allclose(t, j, rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_spike_step_skipped_by_ema_gate(both_flags):
    both_flags({"guard_numerics": True, "guard_spike_factor": 10.0})
    p = Pair(lambda pkg: _sgd(pkg, lr=0.01))
    for i in range(3):      # the loss EMA
        p.run(_feed(i))
        p.hold_health()
    w_before = p.tscope.find_var(p.w).clone()
    spike = _feed(0)
    spike["x"] = spike["x"] * 1e4
    p.run(spike)
    h = p.hold_health()
    assert h[H_BAD] == 1 and h[H_NONFINITE] == 0   # finite, but a spike
    assert torch.equal(p.tscope.find_var(p.w), w_before)


def test_guard_off_appends_nothing(both_flags):
    both_flags({"guard_numerics": False})
    p = Pair(lambda pkg: _sgd(pkg))
    assert GUARD_HEALTH_NAME not in p.tm.global_block.vars
    assert not any(op.type == "health_sentinel"
                   for op in p.tm.global_block.ops)
    assert not hasattr(p.tm, "_guard_found_inf_name")


def _momentum_sched(pkg):
    """SGD-like regression under Momentum with an exponential_decay LR,
    whose step counter an `increment` op advances in place."""
    L = pkg["L"]
    x = L.data(name="x", shape=[4], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    h = L.fc(x, size=6, act="relu")
    loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
    lr = L.exponential_decay(0.1, decay_steps=2, decay_rate=0.5)
    pkg["pt"].optimizer.Momentum(lr, 0.9).minimize(loss)
    return loss


@pytest.mark.parametrize("which", ["sgd", "momentum"])
def test_sentinel_health_state_and_updates_match_jax(both_flags, which):
    """Five steps mixing good, NaN and spike batches: Health, State and the
    parameters after each step equal the JAX package's."""
    both_flags({"guard_numerics": True, "guard_spike_factor": 5.0})
    fn = (lambda pkg: _sgd(pkg, lr=0.05)) if which == "sgd" else \
        _momentum_sched
    p = Pair(fn)
    spike = _feed(4)
    spike["x"] = spike["x"] * 1e3
    verdicts = []
    for feed in (_feed(0), _feed(1), _nan_feed(2), spike, _feed(3)):
        jl, tl = p.run(feed)
        np.testing.assert_allclose(tl, jl, rtol=HEALTH_RTOL, equal_nan=True)
        verdicts.append(int(p.hold_health()[H_BAD]))
        for prm in p.jm.all_parameters():
            j, t = p.var(prm.name)
            np.testing.assert_allclose(t, j, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=prm.name)
    assert verdicts == [0, 0, 1, 1, 0]


# -- StepGuard: budget, rewind, blame -----------------------------------------

def _rewind_run(pkg_name, tmp_path, p):
    """The JAX test's rewind drill through one package: a checkpoint after
    a good step, then NaN batches through run_async under a budget-1
    guard. Returns (report, the guard, the manager, w at the checkpoint,
    lr before)."""
    if pkg_name == "jax":
        R, exe, main, scope, loss = JR, p.jexe, p.jm, p.jscope, p.jloss
        val = lambda v: np.asarray(v)
    else:
        R, exe, main, scope, loss = TR, p.texe, p.tm, p.tscope, p.tloss
        val = lambda v: v.numpy()
    mgr = R.CheckpointManager(str(tmp_path / pkg_name), main_program=main,
                              scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    mgr.save(0, executor=exe)
    w_ckpt = val(scope.find_var(p.w)).copy()
    lr0 = float(val(scope.find_var(main._guard_lr_name)).reshape(-1)[0])
    guard = R.StepGuard(mgr, budget=1, program=main, scope=scope)
    exe.set_step_guard(guard)
    report = None
    for _ in range(4):
        try:
            exe.run_async(main, feed=_nan_feed(), fetch_list=[loss],
                          scope=scope)
        except R.GuardRewind as gr:
            report = guard.rewind(exe, gr)
            break
    exe.wait()
    lr1 = float(val(scope.find_var(main._guard_lr_name)).reshape(-1)[0])
    return report, guard, mgr, w_ckpt, lr0, lr1


def test_budget_exhausted_rewinds_and_blames_as_jax(tmp_path, both_flags):
    both_flags({"guard_numerics": True, "max_inflight_steps": 1})
    p = Pair(lambda pkg: _sgd(pkg))
    jrep, jguard, jmgr, _, _, _ = _rewind_run("jax", tmp_path, p)
    rep, guard, mgr, w_ckpt, lr0, lr1 = _rewind_run("torch", tmp_path, p)
    assert rep is not None and jrep is not None
    assert (rep["op_type"], rep["var"]) == (jrep["op_type"], jrep["var"])
    assert rep["op_type"] is not None and "nan/inf" in rep["detail"]
    assert rep["feed_keys"] == jrep["feed_keys"]
    assert rep["step"] == jrep["step"]
    # rewound to the checkpoint, the LR backed off
    np.testing.assert_array_equal(p.tscope.find_var(p.w).numpy(), w_ckpt)
    assert lr1 == pytest.approx(lr0 * 0.5)
    # the same forensics, durably recorded
    actions = [e["action"] for e in mgr.guard_events()]
    assert actions == [e["action"] for e in jmgr.guard_events()]
    assert actions.count("skip") == 2 and actions[-1] == "rewind"
    assert [e["reason"] for e in guard.events] == [
        e["reason"] for e in jguard.events]
    mgr.save(1, executor=p.texe)
    assert len(mgr.read_manifest(1)["guard_events"]) == len(actions)
    assert mgr.latest_step() == 1


def test_max_rewinds_surfaces_guard_error(tmp_path, both_flags):
    both_flags({"guard_numerics": True, "max_inflight_steps": 1})
    p = Pair(lambda pkg: _sgd(pkg))
    mgr = TR.CheckpointManager(str(tmp_path / "ck"), main_program=p.tm,
                               scope=p.tscope)
    p.texe.run(p.tm, feed=_feed(), fetch_list=[p.tloss], scope=p.tscope)
    mgr.save(0, executor=p.texe)
    guard = TR.StepGuard(mgr, budget=0, max_rewinds=2)
    p.texe.set_step_guard(guard)
    lr0 = float(p.tscope.find_var(p.tm._guard_lr_name)[0])
    rewinds = 0
    with pytest.raises(TR.GuardError):
        for _ in range(10):
            try:
                p.texe.run_async(p.tm, feed=_nan_feed(), fetch_list=[],
                                 scope=p.tscope)
            except TR.GuardRewind as gr:
                guard.rewind(p.texe, gr)   # program/scope: the executor's
                rewinds += 1
                lr = float(p.tscope.find_var(p.tm._guard_lr_name)[0])
                assert lr == pytest.approx(lr0 * 0.5 ** rewinds)
    assert rewinds == 2 and guard.rewinds == 3


def test_replay_blame_leaves_the_live_scope_bit_for_bit(both_flags):
    """The port's ops write state in place (`increment` on the LR counter);
    the replay runs on clones, so every live var keeps its bits — and the
    report names the JAX package's op and var."""
    both_flags({"guard_numerics": True})
    p = Pair(_momentum_sched)
    for i in range(2):
        p.run(_feed(i))
    names = p.tscope.var_names()
    assert "@LR_DECAY_COUNTER@" in names
    before = {n: p.tscope.find_var(n) for n in names}
    snap = {n: v.clone() for n, v in before.items()}
    rep = TR.replay_blame(p.texe, p.tm, _nan_feed(), p.tscope, step_id=3)
    jrep = JR.replay_blame(p.jexe, p.jm, _nan_feed(), p.jscope, step_id=3)
    assert (rep["op_type"], rep["var"]) == (jrep["op_type"], jrep["var"])
    assert rep["op_type"] == "mul" and "nan/inf" in rep["detail"]
    assert p.tscope.var_names() == names
    for n in names:
        now = p.tscope.find_var(n)
        assert now is before[n], n                       # not replaced
        assert now.numpy().tobytes() == snap[n].numpy().tobytes(), n
    # a finite batch replays finite: the batch itself is the attribution
    rep = TR.replay_blame(p.texe, p.tm, _feed(5), p.tscope)
    assert rep["op_type"] is None and "finite" in rep["detail"]
    assert not tflags.get_flag("check_nan_inf")


def test_guard_events_survive_restart(tmp_path):
    root = str(tmp_path / "ckpt")
    mgr = TR.CheckpointManager(root)
    mgr.record_guard_event(7, "nonfinite", "skip", {"loss": float("nan")})
    fresh = TR.CheckpointManager(root)  # a restarted process
    evts = fresh.guard_events()
    assert len(evts) == 1 and evts[0]["step"] == 7
    assert fresh.latest_step() is None  # events never count as steps


# -- AMP composition ----------------------------------------------------------

def _amp_fc(pkg):
    L = pkg["L"]
    amp = pkg["pt"].contrib.mixed_precision
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    loss = L.mean(L.square_error_cost(L.fc(x, size=1), y))
    amp.decorate(pkg["pt"].optimizer.SGD(0.01), init_loss_scaling=2.0 ** 15,
                 use_dynamic_loss_scaling=True,
                 decr_every_n_nan_or_inf=1).minimize(loss)
    return loss


def test_amp_dynamic_loss_scaling_composes(both_flags):
    """AMP's found_inf machinery keeps working under the guard: the scale
    still decrements on overflow, and the sentinel hears AMP's verdict."""
    both_flags({"guard_numerics": True})
    p = Pair(_amp_fc)
    op = next(o for o in p.tm.global_block.ops if o.type == "health_sentinel")
    assert op.inputs["FoundInfinite"] == ["@FOUND_INF@"]
    assert op.inputs["Loss"] == [p.tloss.name]          # the unscaled loss
    rng = np.random.default_rng(1)
    xv = rng.standard_normal((8, 8)).astype(np.float32)
    yv = np.ones((8, 1), np.float32)
    p.run({"x": xv, "y": yv})
    p.hold_health(AMP_RTOL)
    s1 = float(p.tscope.find_var("@LOSS_SCALING@").reshape(-1)[0])
    p.run({"x": np.full((8, 8), 1e30, np.float32), "y": yv})
    h = p.hold_health(AMP_RTOL)
    s2 = float(p.tscope.find_var("@LOSS_SCALING@").reshape(-1)[0])
    assert s2 < s1 and h[H_BAD] == 1
    j, t = p.var("@LOSS_SCALING@")
    assert float(j) == float(t)
    jl, tl = p.run({"x": xv, "y": yv})
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(tl, jl, rtol=AMP_RTOL)


# -- FLAGS_check_nan_inf ------------------------------------------------------

def test_check_nan_inf_raises_on_the_jax_packages_op(both_flags):
    """The port is eager: the flag validates every op's outputs and raises
    an OpError naming the first op with a non-finite output — the op the
    JAX package names under jax.disable_jit()."""
    p = Pair(lambda pkg: _sgd(pkg))
    both_flags({"check_nan_inf": True})
    with pytest.raises(tpt.framework.OpError, match="nan/inf") as te:
        p.texe.run(p.tm, feed=_nan_feed(), fetch_list=[p.tloss],
                   scope=p.tscope)
    with jax.disable_jit():
        with pytest.raises(jpt.OpError, match="nan/inf") as je:
            p.jexe.run(p.jm, feed=_nan_feed(), fetch_list=[p.jloss],
                       scope=p.jscope)
    assert te.value.op.type == je.value.op.type
    assert te.value.op.outputs == je.value.op.outputs
    (lv,) = p.texe.run(p.tm, feed=_feed(), fetch_list=[p.tloss],
                       scope=p.tscope)
    assert np.isfinite(lv).all()


# -- numeric fault sites ------------------------------------------------------

@pytest.mark.parametrize("spec", ["numeric_nan:2", "numeric_spike:1",
                                  "numeric_nan:1;numeric_spike:3"])
def test_numeric_fault_sites_poison_as_jax(both_flags, spec):
    both_flags({"guard_numerics": True, "guard_spike_factor": 10.0})
    p = Pair(lambda pkg: _sgd(pkg))
    bads = []
    with JR.fault_scope(spec) as jplan, TR.fault_scope(spec) as tplan:
        for i in range(4):
            p.run(_feed(i))
            bads.append(int(p.hold_health()[H_BAD]))
    assert tplan.stats()["fired"] == jplan.stats()["fired"]
    assert sum(bads) >= 1
    j, t = p.var(p.w)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=PARAM_RTOL, atol=PARAM_ATOL)


def _chaos_build(pkg):
    L = pkg["L"]
    img = L.data(name="img", shape=[64], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    h = L.fc(img, size=32, act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=10), label))
    pkg["pt"].optimizer.SGD(0.1).minimize(loss)
    return loss


def _chaos_feed(step):
    rng = np.random.default_rng(500 + step)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    w = np.random.default_rng(9).standard_normal((64, 10)).astype(np.float32)
    return {"img": x,
            "label": np.argmax(x @ w, axis=1).astype(np.int64)[:, None]}


def _chaos(R, exe, main, scope, loss, root, steps=6):
    """tools/chaos.py run_numeric_smoke through one package."""
    mgr = R.CheckpointManager(root, main_program=main, scope=scope)
    guard = R.StepGuard(mgr, program=main, scope=scope)
    exe.set_step_guard(guard)
    exe.run(main, feed=_chaos_feed(0), fetch_list=[loss], scope=scope)
    mgr.save(0, executor=exe)
    with R.fault_scope("numeric_nan:3;numeric_spike:5"):
        for step in range(1, steps + 1):
            exe.run_async(main, feed=_chaos_feed(step), fetch_list=[loss],
                          scope=scope)
        exe.wait()
    (lv,) = exe.run(main, feed=_chaos_feed(steps + 1), fetch_list=[loss],
                    scope=scope)
    return guard, float(np.asarray(lv).reshape(-1)[0])


@pytest.mark.chaos
def test_numeric_chaos_drill_as_jax(tmp_path, both_flags):
    """The kill-free numeric drill (tools/chaos.py run_numeric_smoke):
    seeded NaN and spike faults under the guard; both skips recorded, no
    rewind, the final loss finite and the JAX package's."""
    both_flags({"guard_numerics": True, "guard_spike_factor": 50.0,
                "max_inflight_steps": 2})
    p = Pair(_chaos_build)
    jg, jl = _chaos(JR, p.jexe, p.jm, p.jscope, p.jloss, str(tmp_path / "j"))
    tg, tl = _chaos(TR, p.texe, p.tm, p.tscope, p.tloss, str(tmp_path / "t"))
    assert tg.rewinds == jg.rewinds == 0 and tg.skips == jg.skips >= 2
    assert [(e["step"], e["reason"]) for e in tg.events] == [
        (e["step"], e["reason"]) for e in jg.events]
    assert {"nonfinite", "loss_spike"} <= {e["reason"] for e in tg.events}
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


# -- train_from_dataset under the guard ---------------------------------------

def _tfd(pkg, tmp_path, path):
    L, pt = pkg["L"], pkg["pt"]
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 0
    with pt.program_guard(main, startup), pkg["un"].guard():
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        loss = L.mean(L.square_error_cost(L.fc(x, size=1), y))
        pt.optimizer.SGD(0.1).minimize(loss)
    ds = pt.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(4)
    ds.set_use_var([x, y])
    ds.set_filelist([str(path)])
    return main, startup, ds


def test_train_from_dataset_survives_guard(tmp_path, both_flags):
    """numeric_nan injected mid-epoch through the async train_from_dataset
    path of both packages: the epoch completes, one skip, no rewind, the
    weights finite and the JAX package's."""
    both_flags({"guard_numerics": True, "max_inflight_steps": 2,
                "device_prefetch_depth": 2})
    rng = np.random.default_rng(0)
    path = tmp_path / "part-0"
    with open(path, "w") as f:
        for _ in range(24):  # 6 batches of 4
            vals = " ".join(f"{v:.4f}" for v in rng.random(4))
            f.write(f"4 {vals} 1 {rng.integers(0, 2)}\n")
    out = {}
    w0 = None
    for pkg, R in ((tp.J, JR), (tp.T, TR)):
        main, startup, ds = _tfd(pkg, tmp_path, path)
        exe, scope = pkg["exe"](), pkg["scope"]()
        exe.run(startup, scope=scope)
        w = main.all_parameters()[0].name
        if w0 is None:
            w0 = {p.name: np.asarray(scope.find_var(p.name))
                  for p in main.all_parameters()}
        else:
            load_params(scope, main, w0)
        guard = R.StepGuard(R.CheckpointManager(
            str(tmp_path / pkg["name"]), main_program=main, scope=scope),
            program=main, scope=scope)
        with R.fault_scope("numeric_nan:3"):
            exe.train_from_dataset(main, ds, scope=scope,
                                   print_period=10 ** 9, guard=guard)
        assert guard.skips == 1 and guard.rewinds == 0
        out[pkg["name"]] = np.asarray(scope.find_var(w))
    assert np.isfinite(out["torch"]).all()
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=PARAM_RTOL,
                               atol=PARAM_ATOL)


def test_train_from_dataset_rewinds_past_a_poisoned_run(tmp_path,
                                                        both_flags):
    """A run of NaN batches past the budget inside train_from_dataset: the
    loop rewinds to the checkpoint, backs the LR off and goes on past the
    poisoned batches to the end of the epoch."""
    both_flags({"guard_numerics": True, "max_inflight_steps": 1,
                "device_prefetch_depth": 0})
    rng = np.random.default_rng(1)
    path = tmp_path / "part-0"
    with open(path, "w") as f:
        for i in range(32):  # 8 batches of 4; batches 3-5 poisoned
            vals = rng.random(4)
            if 8 <= i < 20 and i % 4 == 0:
                vals[0] = np.nan
            f.write("4 " + " ".join(f"{v:.4f}" for v in vals)
                    + f" 1 {rng.integers(0, 2)}\n")
    main, startup, ds = _tfd(tp.T, tmp_path, path)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    mgr = TR.CheckpointManager(str(tmp_path / "ck"), main_program=main,
                               scope=scope)
    mgr.save(0, executor=exe)
    lr0 = float(scope.find_var(main._guard_lr_name)[0])
    guard = TR.StepGuard(mgr, budget=1)
    exe.train_from_dataset(main, ds, scope=scope, print_period=10 ** 9,
                           guard=guard)
    # batch 3 skips, batch 4 exhausts the budget when batch 5's dispatch
    # drains it; the rewind discards batch 5 with the window
    assert guard.rewinds == 1 and guard.skips == 2
    assert guard.last_blame["op_type"] == "mul"
    assert float(scope.find_var(main._guard_lr_name)[0]) == pytest.approx(
        lr0 * 0.5)
    assert torch.isfinite(scope.find_var(main.all_parameters()[0].name)).all()
