"""The port's resilience runtime (paddle_tpu_torch/resilience/: fault
plans, retry policies, the stall watchdog, CheckpointManager over
io.save_sharded / load_sharded) held against the JAX package's on the CPU:
the same plans parse and fire alike, the policies back off alike, and the
manifests carry the same program hash."""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_parity as tp

import paddle_tpu.resilience as J
import paddle_tpu_torch as tpt
import paddle_tpu_torch.resilience as R
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture
def restore_flags():
    names = ("watchdog_stall_s", "watchdog_scale")
    saved = {n: tflags.get_flag(n) for n in names}
    yield
    tflags.set_flags(saved)


SPECS = ["ckpt.write:2;ps.send:1,4",
         "rand:p=0.5,seed=3,sites=ps.send|ps.recv,max=2",
         "rand:p=0.2,seed=7", "emb_host_stall:2", "pipeline_stall:1,3", ""]


# -- fault plans --------------------------------------------------------------

def test_fault_sites_are_the_jax_packages():
    assert R.FAULT_SITES == J.FAULT_SITES


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_as_jax(spec):
    a, b = R.FaultPlan.parse(spec), J.FaultPlan.parse(spec)
    assert (a.schedule, a.p, a.seed, a.sites, a.max_faults, a.spec) == (
        b.schedule, b.p, b.seed, b.sites, b.max_faults, b.spec)


@pytest.mark.parametrize("bad,match", [
    ("not.a.site:1", "unknown fault site"),
    ("rand:p=0.5,sites=bogus", "unknown fault site"),
    ("rand:q=1", "unknown fault-plan key")])
def test_fault_plan_rejects_as_jax(bad, match):
    for pkg in (R, J):
        with pytest.raises(ValueError, match=match):
            pkg.FaultPlan.parse(bad)


def test_fault_plan_rand_draws_as_jax():
    """The seeded Bernoulli draw is pure in (seed, site, hit) and equal to
    the JAX package's draw by draw; sites draw independent streams."""
    a, b = R.FaultPlan.parse("rand:p=0.4,seed=11"), J.FaultPlan.parse(
        "rand:p=0.4,seed=11")
    for site in ("ps.send", "ps.recv", "emb_host_stall"):
        assert [a._draw(site, i) for i in range(64)] == [
            b._draw(site, i) for i in range(64)]
    assert [a._draw("ps.send", i) for i in range(64)] != [
        a._draw("ps.recv", i) for i in range(64)]


def _fire_pattern(pkg, spec, sites, n):
    fired = []
    with pkg.fault_scope(spec) as plan:
        for i in range(n):
            for s in sites:
                try:
                    pkg.fault_point(s)
                except pkg.InjectedFault as e:
                    fired.append((e.site, e.hit))
        stats = plan.stats()
    return fired, stats


@pytest.mark.parametrize("spec", ["ckpt.write:2;ps.send:1,4",
                                  "rand:p=0.3,seed=5,max=4",
                                  "rand:p=1.0,sites=pipeline_stall"])
def test_fault_scope_fires_as_jax(spec):
    sites = ("ckpt.write", "ps.send", "pipeline_stall")
    assert _fire_pattern(R, spec, sites, 6) == _fire_pattern(J, spec, sites, 6)


def test_fault_scope_fires_on_schedule_and_restores():
    with R.fault_scope("ckpt.write:2") as plan:
        R.fault_point("ckpt.write")
        with pytest.raises(R.InjectedFault) as ei:
            R.fault_point("ckpt.write")
        assert ei.value.site == "ckpt.write" and ei.value.hit == 2
        assert isinstance(ei.value, ConnectionError)
        R.fault_point("ckpt.write")
        assert plan.stats()["fired"] == [("ckpt.write", 2)]
        assert R.fault_stats()["spec"] == "ckpt.write:2"
    R.fault_point("ckpt.write")
    assert R.fault_stats() == {}


def test_fault_point_rejects_unknown_site():
    with R.fault_scope("rand:p=1.0"):
        with pytest.raises(ValueError, match="unknown fault site"):
            R.fault_point("typo.site")


def test_fault_plan_from_the_environment():
    """FLAGS_fault_plan is read at import, so a subprocess trainer inherits
    its plan."""
    code = ("from paddle_tpu_torch.resilience import fault_point, "
            "InjectedFault\n"
            "try:\n    fault_point('ckpt.write')\nexcept InjectedFault as e:\n"
            "    print('fired', e.hit)\n")
    env = dict(os.environ, FLAGS_fault_plan="ckpt.write:1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "fired 1", out.stderr[-2000:]


# -- retry --------------------------------------------------------------------

def test_retry_succeeds_after_transient_failures():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return "ok"

    assert R.RetryPolicy(max_attempts=4, base_delay=0.001,
                         max_delay=0.002).call(flaky) == "ok"
    assert len(calls) == 3


def test_retry_does_not_mask_application_errors():
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("no such var")

    with pytest.raises(RuntimeError):
        R.RetryPolicy(max_attempts=5, base_delay=0.001).call(broken)
    assert len(calls) == 1


def test_retry_exhausts_attempts_and_deadline():
    calls = []

    def always():
        calls.append(1)
        raise EOFError("dead")

    with pytest.raises(EOFError):
        R.RetryPolicy(max_attempts=3, base_delay=0.001).call(always)
    assert len(calls) == 3
    slept = []
    pol = R.RetryPolicy(max_attempts=50, base_delay=10.0, max_delay=10.0,
                        deadline=0.5, sleep=slept.append)
    with pytest.raises(ConnectionError):
        pol.call(lambda: (_ for _ in ()).throw(ConnectionError("x")))
    assert slept == []


@pytest.mark.parametrize("kw", [dict(), dict(base_delay=0.001, jitter=0.5,
                                             seed=9),
                                dict(base_delay=0.2, multiplier=3.0,
                                     max_delay=1.0, jitter=0.0)])
def test_retry_delays_equal_jax(kw):
    """Backoff with deterministic jitter, delay for delay the JAX
    package's."""
    a, b = R.RetryPolicy(**kw), J.RetryPolicy(**kw)
    assert [a.delay(i) for i in range(1, 12)] == [b.delay(i)
                                                 for i in range(1, 12)]


def test_retry_on_retry_hook_and_injected_fault():
    seen = []
    pol = R.RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0.5, seed=9,
                        sleep=lambda d: None)
    with pytest.raises(ConnectionError):
        pol.call(lambda: (_ for _ in ()).throw(ConnectionError("x")),
                 on_retry=lambda attempt, exc: seen.append(attempt))
    assert seen == [1, 2]
    with R.fault_scope("ps.send:1"):
        R.RetryPolicy(max_attempts=2, base_delay=0.001).call(R.fault_point,
                                                             "ps.send")


def test_io_policy_equals_jax():
    a, b = R.io_policy(), J.io_policy()
    assert (a.max_attempts, a.base_delay, a.max_delay, a.deadline,
            a.multiplier, a.jitter) == (b.max_attempts, b.base_delay,
                                        b.max_delay, b.deadline, b.multiplier,
                                        b.jitter)


@pytest.mark.parametrize("name,item", [
    ("rpc_policy", "parallel and distributed"),
    ("connect_policy", "parallel and distributed")])
def test_unported_policies_name_their_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        getattr(R, name)()


@pytest.mark.parametrize("name", ["fleet_policy", "serving_policy"])
def test_serving_policies_equal_jax(name):
    """The serving dispatch and fleet failover policies have the JAX
    package's fields (the fleet's counts the engines' AdmissionRejected as
    transient, each package its own class)."""
    from paddle_tpu.resilience import retry as jretry

    a, b = getattr(R, name)(), getattr(jretry, name)()
    assert (a.max_attempts, a.base_delay, a.max_delay, a.deadline,
            a.multiplier, a.jitter) == (b.max_attempts, b.base_delay,
                                        b.max_delay, b.deadline,
                                        b.multiplier, b.jitter)
    assert [e.__name__ for e in a.retryable] \
        == [e.__name__ for e in b.retryable]
    assert a.delay(2) == b.delay(2)


# -- the watchdog -------------------------------------------------------------

def test_watchdog_raises_with_the_state_dump(restore_flags):
    tflags.set_flags({"watchdog_stall_s": 0.1, "watchdog_scale": 2.0})
    assert R.stall_window_s() == pytest.approx(0.2)
    wd = R.Watchdog()
    assert wd.enabled and wd.window_s == pytest.approx(0.2)
    t0 = time.monotonic()
    with pytest.raises(R.StallError) as exc:
        wd.wait(lambda: False, lambda: R.runtime_state(queue_depth=3),
                what="test wait")
    assert time.monotonic() - t0 >= 0.2
    assert exc.value.state["queue_depth"] == 3
    assert "profiler_stages" in exc.value.state
    assert "test wait" in str(exc.value)
    wd.wait(lambda: True)
    tflags.set_flags({"watchdog_scale": 0.5})
    assert R.watchdog_scale() == 1.0
    tflags.set_flags({"watchdog_stall_s": 0.0})
    assert not R.Watchdog().enabled


def test_stall_error_is_counted_and_evented():
    from paddle_tpu_torch import observability as obs

    before = obs.snapshot()["counters"].get("watchdog.stalls", 0)
    R.StallError("x", 1.0, {"a": 1})
    snap = obs.snapshot()
    assert snap["counters"]["watchdog.stalls"] == before + 1
    assert snap["events"][-1]["name"] == "watchdog.stall"


def test_heartbeat_monitor_flags_the_overdue():
    hb = R.HeartbeatMonitor(1.0, scale=1.0)
    hb.register("a", now=0.0)
    hb.register("b", now=0.0)
    hb.beat("a", now=1.5)
    assert hb.overdue(now=1.8) == ["b"]
    assert hb.age("a", now=2.0) == pytest.approx(0.5)
    hb.deregister("b")
    assert hb.overdue(now=1.8) == []
    assert R.HeartbeatMonitor(0.0).overdue() == []


def test_prefetch_stall_raises_the_watchdogs_stall_error():
    """reader.StallError is the watchdog's: the DeviceLoader's and the
    prefetch's stalls are one type."""
    from paddle_tpu_torch import reader

    assert reader.StallError is R.StallError
    release = threading.Event()

    def wedged():
        yield 1
        release.wait(30)

    it = reader._prefetch_iter(wedged, 2, stall_window=0.2,
                               stall_what="test prefetch")
    assert next(it) == 1
    with pytest.raises(R.StallError) as exc:
        next(it)
    release.set()
    assert exc.value.state["producer_alive"] is True


@pytest.mark.chaos
def test_device_loader_pipeline_stall_raises(restore_flags):
    from paddle_tpu_torch.pipeline import DeviceLoader

    tflags.set_flags({"watchdog_stall_s": 0.2})
    with R.fault_scope("pipeline_stall:2"):
        it = iter(DeviceLoader(lambda: iter([{"x": np.zeros(2)}] * 4),
                               depth=1, device="cpu"))
        next(it)
        with pytest.raises(R.StallError) as exc:
            next(it)
    assert "DeviceLoader" in exc.value.what
    assert exc.value.state["queue_depth"] == 0


# -- save_sharded / load_sharded ----------------------------------------------

def _regression(pkg):
    L = pkg["L"]
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    loss = L.mean(L.square_error_cost(L.fc(x, size=4), y))
    pkg["pt"].optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _feed():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((8, 8)).astype(np.float32)
    W = rng.standard_normal((8, 1)).astype(np.float32)
    return {"x": X, "y": (X @ W).astype(np.float32)}


def _setup(steps=0):
    main, startup, loss = tp.build(tp.T, _regression)
    exe, scope = tp.T["exe"](), tpt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(steps):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    return main, exe, scope, loss


def _values(scope):
    return {n: scope.find_var(n).clone() for n in scope.var_names()}


def test_save_sharded_roundtrip_in_the_jax_packages_bytes(tmp_path):
    """save_sharded writes one .npy a persistable var, save_vars' files
    (the JAX package's bytes), renamed into place; load_sharded restores
    them bit for bit on the executor's device."""
    main, exe, scope, _ = _setup(steps=2)
    d = str(tmp_path / "ck")
    tio.save_sharded(exe, d, main_program=main, scope=scope)
    assert not os.path.exists(d + ".tmp-stage")
    want = _values(scope)
    names = sorted(os.listdir(d))
    assert names == sorted(tio._encode_name(n) + ".npy" for n in want)
    for n, t in want.items():
        np.testing.assert_array_equal(
            np.load(os.path.join(d, tio._encode_name(n) + ".npy")), t.numpy())
    fresh = tpt.Scope()
    tio.load_sharded(exe, d, main_program=main, scope=fresh)
    for n, t in want.items():
        assert torch.equal(fresh.find_var(n), t), n
    tio.save_sharded(exe, d, main_program=main, scope=scope)  # replaces
    assert sorted(os.listdir(d)) == names


def test_save_sharded_retries_a_transient_write(tmp_path):
    main, exe, scope, _ = _setup()
    d = str(tmp_path / "ck")
    with R.fault_scope("ckpt.write:1") as plan:
        tio.save_sharded(exe, d, main_program=main, scope=scope)
    assert plan.stats()["fired"] == [("ckpt.write", 1)]
    assert os.path.isdir(d)


def test_sharded_checkpoints_refuse_more_than_one_rank(tmp_path):
    """A ZeRO-1 checkpoint saved over two ranks, with rank 1's shard file
    missing, refuses a load at one (resharding reads every rank's shard),
    and a world-size-1 save round-trips."""
    from torch_dp_cases import zero1_checkpoint_as_rank0_of_2

    main, exe, scope, _ = _setup()
    tio.save_sharded(exe, str(tmp_path / "one"), main_program=main,
                     scope=scope)
    tio.load_sharded(exe, str(tmp_path / "one"), main_program=main,
                     scope=scope)
    zmain, zstart, zexe, _ = zero1_checkpoint_as_rank0_of_2(
        str(tmp_path / "ck"))
    zscope = tpt.Scope()
    zexe.run(zstart, scope=zscope)
    with pytest.raises(FileNotFoundError, match="rank 1's shard"):
        tio.load_sharded(zexe, str(tmp_path / "ck"), main_program=zmain,
                         scope=zscope)


# -- CheckpointManager --------------------------------------------------------

def test_checkpoint_manager_roundtrip_and_latest(tmp_path):
    main, exe, scope, _ = _setup(steps=2)
    mgr = R.CheckpointManager(str(tmp_path / "ck"), main_program=main,
                              scope=scope)
    assert mgr.latest_step() is None
    mgr.save(5, executor=exe)
    mgr.save(9, executor=exe)
    assert mgr.steps() == [5, 9] and mgr.latest_step() == 9
    before = _values(scope)
    for n, t in before.items():
        scope.set_var(n, torch.zeros_like(t))
    assert mgr.restore(executor=exe) == 9
    for n, t in before.items():
        assert torch.equal(scope.find_var(n), t), n


def test_checkpoint_manager_needs_a_scope(tmp_path):
    with pytest.raises(ValueError, match="scope"):
        R.CheckpointManager(str(tmp_path / "ck")).save(0)


def test_checkpoint_manager_keep_last_k_gc(tmp_path):
    main, exe, scope, _ = _setup(steps=1)
    mgr = R.CheckpointManager(str(tmp_path / "ck"), keep_last_k=2,
                              main_program=main, scope=scope)
    for s in range(5):
        mgr.save(s, executor=exe)
    assert mgr.steps() == [3, 4]


def test_checkpoint_manifest_provenance_equals_jax(tmp_path):
    """The manifest records the step, the RNG run counter and the
    persistables; its program_hash equals the JAX package's manifest's for
    the same program (both hash to_dict()); restore puts the counter
    back."""
    jm, js, _ = tp.build(tp.J, _regression)
    jscope, jexe = tp.J["scope"](), tp.J["exe"]()
    jexe.run(js, scope=jscope)
    jmgr = J.CheckpointManager(str(tmp_path / "jax"), main_program=jm,
                               scope=jscope)
    jmgr.save(3, executor=jexe)
    main, exe, scope, _ = _setup(steps=3)
    mgr = R.CheckpointManager(str(tmp_path / "ck"), main_program=main,
                              scope=scope)
    mgr.save(3, executor=exe)
    m, jmf = mgr.read_manifest(3), jmgr.read_manifest(3)
    assert m["program_hash"] == jmf["program_hash"]
    assert m["format"] == jmf["format"] and m["step"] == 3
    assert m["rng_counter"] == scope._run_counter == 4
    assert m["var_names"] == sorted(scope.var_names())
    assert set(m["var_names"]) == set(jmf["var_names"])
    scope._run_counter = 999
    mgr.restore(executor=exe)
    assert scope._run_counter == m["rng_counter"]


def test_checkpoint_failed_save_leaves_no_half_checkpoint(tmp_path):
    main, exe, scope, _ = _setup(steps=1)
    root = str(tmp_path / "ck")
    mgr = R.CheckpointManager(root, main_program=main, scope=scope)
    mgr.save(1, executor=exe)
    with R.fault_scope("ckpt.write:" + ",".join(map(str, range(1, 20)))):
        with pytest.raises(ConnectionError):
            mgr.save(2, executor=exe)
    assert mgr.steps() == [1]
    assert [n for n in os.listdir(root) if n.startswith(".tmp")] == []
    assert mgr.restore(executor=exe) == 1


def test_checkpoint_corrupt_rolls_back_to_last_good(tmp_path):
    main, exe, scope, loss = _setup(steps=2)
    root = str(tmp_path / "ck")
    mgr = R.CheckpointManager(root, main_program=main, scope=scope)
    mgr.save(1, executor=exe)
    good = _values(scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    mgr.save(2, executor=exe)
    with open(os.path.join(root, "step_00000002", "manifest.json"), "w") as f:
        f.write("{ not json")
    with pytest.warns(UserWarning, match="quarantined"):
        assert mgr.restore(executor=exe) == 1
    for n, t in good.items():
        assert torch.equal(scope.find_var(n), t), n
    assert mgr.steps() == [1]


def test_checkpoint_explicit_step_does_not_substitute(tmp_path):
    main, exe, scope, _ = _setup(steps=1)
    mgr = R.CheckpointManager(str(tmp_path / "ck"), main_program=main,
                              scope=scope)
    mgr.save(4, executor=exe)
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=7, executor=exe)
    assert mgr.restore(step=4, executor=exe) == 4


def test_checkpoint_program_hash_mismatch_warns(tmp_path):
    main, exe, scope, _ = _setup(steps=1)
    mgr = R.CheckpointManager(str(tmp_path / "ck"), main_program=main,
                              scope=scope)
    mgr.save(0, executor=exe)
    other, _, _ = tp.build(tp.T, lambda p: p["L"].fc(
        p["L"].data(name="x", shape=[8], dtype="float32"), size=4))
    with pytest.warns(UserWarning, match="different program"):
        mgr.restore(executor=exe, main_program=other)


def test_checkpoint_guard_events_persist(tmp_path):
    main, exe, scope, _ = _setup()
    root = str(tmp_path / "ck")
    mgr = R.CheckpointManager(root, main_program=main, scope=scope)
    mgr.record_guard_event(3, "nonfinite", "skip")
    mgr.save(4, executor=exe)
    assert mgr.read_manifest(4)["guard_events"][0]["action"] == "skip"
    again = R.CheckpointManager(root, main_program=main, scope=scope)
    assert [e["step"] for e in again.guard_events()] == [3]


def test_new_modules_import_no_jax():
    code = ("import sys, paddle_tpu_torch.embedding, "
            "paddle_tpu_torch.observability, paddle_tpu_torch.resilience, "
            "paddle_tpu_torch.io, paddle_tpu_torch.passes; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu', 'triton', 'tools')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
