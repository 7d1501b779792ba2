"""The port's CheckpointedRunner (paddle_tpu_torch/resilience/runner.py)
held against the JAX package's on the CPU, after tests/test_resilience.py's
runner tests and tests/test_kill_resume.py: with a seeded fault plan at
executor.compile, collective.step and ckpt.write the run completes with
the JAX package's retries and fired hits, and its loss trajectory equals
an undisturbed run's bit for bit (tolerance 0) and the JAX package's within
LOSS_RTOL; a SIGKILLed trainer resumes from latest_step() and reproduces
the uninterrupted trajectory bit for bit."""
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_parity as tp

import jax.numpy as jnp

import paddle_tpu.resilience as JR
import paddle_tpu_torch as tpt
import paddle_tpu_torch.resilience as TR
from paddle_tpu.resilience.runner import StepFailure as JStepFailure
from paddle_tpu_torch.resilience.runner import StepFailure
from paddle_tpu_torch.weights import load_params

LOSS_RTOL = 1e-6    # the port's losses against the JAX package's, relative

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_DIR)
_SCRIPT = os.path.join(_DIR, "torch_ckpt_resume.py")


def _model(pkg):
    L = pkg["L"]
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    loss = L.mean(L.square_error_cost(L.fc(x, size=4), y))
    pkg["pt"].optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _feed_fn():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((16, 8)).astype(np.float32)
    W = rng.standard_normal((8, 1)).astype(np.float32)
    Y = (X @ W).astype(np.float32)
    return lambda step: {"x": X + 0.01 * step, "y": Y}


_W0 = {}


def _fresh(pkg, root, R, **kw):
    """(runner, manager, loss) over a fresh program and scope, the JAX
    package's startup weights in both packages."""
    main, startup, loss = tp.build(pkg, _model)
    exe, scope = pkg["exe"](), pkg["scope"]()
    exe.run(startup, scope=scope)
    if not _W0:
        _W0.update({p.name: np.asarray(scope.find_var(p.name))
                    for p in main.all_parameters()})
    elif pkg is tp.T:
        load_params(scope, main, _W0)
    else:
        for n, v in _W0.items():
            scope.set_var(n, jnp.asarray(v))
    mgr = R.CheckpointManager(root, keep_last_k=3, main_program=main,
                              scope=scope)
    runner = R.CheckpointedRunner(exe, mgr, main_program=main, scope=scope,
                                  **kw)
    return runner, mgr, loss


def _losses(result):
    return [float(np.asarray(v[0]).reshape(-1)[0])
            for _, v in sorted(result["results"].items())]


@pytest.fixture(autouse=True)
def _first_weights():
    """Each test starts from the weights of its first built program."""
    _W0.clear()
    yield
    _W0.clear()


PLAN = "executor.compile:1;collective.step:4;ckpt.write:2"


def test_runner_faulted_trajectory_bit_identical_to_baseline(tmp_path):
    """Faults at executor.compile, collective.step and ckpt.write: the run
    completes with bounded retries, every site fires at the JAX package's
    hits, and the losses equal an undisturbed run's bit for bit."""
    feed_fn = _feed_fn()
    out = {}
    for pkg, R in ((tp.J, JR), (tp.T, TR)):
        runner, mgr, loss = _fresh(pkg, str(tmp_path / pkg["name"]), R,
                                   save_every=2, max_retries=5)
        with R.fault_scope(PLAN) as plan:
            res = runner.run(feed_fn, 6, fetch_list=[loss])
        fired = plan.stats()["fired"]
        assert {s for s, _ in fired} == {"executor.compile",
                                         "collective.step", "ckpt.write"}
        assert 0 < res["retries"] <= runner.max_retries * 6
        assert mgr.latest_step() == 5
        out[pkg["name"]] = (res, fired)
    (jres, jfired), (tres, tfired) = out["jax"], out["torch"]
    assert tfired == jfired and tres["retries"] == jres["retries"]

    base_runner, _, loss = _fresh(tp.T, str(tmp_path / "base"), TR,
                                  save_every=2)
    base = base_runner.run(feed_fn, 6, fetch_list=[loss])
    assert base["retries"] == 0
    assert _losses(tres) == _losses(base)
    np.testing.assert_allclose(_losses(tres), _losses(jres), rtol=LOSS_RTOL)


def test_runner_resumes_from_latest_checkpoint(tmp_path):
    feed_fn = _feed_fn()
    root = str(tmp_path / "ck")
    r1, _, loss = _fresh(tp.T, root, TR, save_every=1)
    first = r1.run(feed_fn, 3, fetch_list=[loss])
    # "a new process": a fresh scope; resume must restore the checkpoint
    r2, _, loss2 = _fresh(tp.T, root, TR, save_every=1)
    second = r2.run(feed_fn, 6, fetch_list=[loss2])
    assert second["start_step"] == 3
    assert sorted(second["results"]) == [3, 4, 5]
    base_r, _, loss3 = _fresh(tp.T, str(tmp_path / "base"), TR, save_every=1)
    base = base_r.run(feed_fn, 6, fetch_list=[loss3])
    assert _losses(first) + _losses(second) == _losses(base)
    jbase_r, _, jloss = _fresh(tp.J, str(tmp_path / "jbase"), JR,
                               save_every=1)
    jbase = jbase_r.run(feed_fn, 6, fetch_list=[jloss])
    np.testing.assert_allclose(_losses(base), _losses(jbase), rtol=LOSS_RTOL)


def test_runner_surfaces_persistent_failure_with_bounded_attempts(tmp_path):
    attempts = {}
    for pkg, R, failure in ((tp.J, JR, JStepFailure), (tp.T, TR,
                                                       StepFailure)):
        runner, _, loss = _fresh(pkg, str(tmp_path / pkg["name"]), R,
                                 save_every=1, max_retries=3)
        # collective.step fires on every hit: the step can never succeed
        with R.fault_scope("collective.step:" + ",".join(
                map(str, range(1, 60)))):
            with pytest.raises(failure) as ei:
                runner.run(_feed_fn(), 2, fetch_list=[loss])
        attempts[pkg["name"]] = (ei.value.attempts, ei.value.step)
    assert attempts["torch"] == attempts["jax"] == (4, 0)


def test_runner_invalidates_the_prepared_program_on_second_failure(tmp_path):
    runner, _, loss = _fresh(tp.T, str(tmp_path / "ck"), TR, save_every=1,
                             max_retries=5)
    exe = runner.exe
    calls = []
    orig = exe.invalidate_cache
    exe.invalidate_cache = lambda p=None: (calls.append(p), orig(p))[1]
    # two step faults on the same step: rung 2 must invalidate, and the
    # program's next run fires executor.compile again
    with TR.fault_scope("collective.step:2,3") as plan:
        out = runner.run(_feed_fn(), 3, fetch_list=[loss])
    assert calls == [runner.program]
    assert sorted(out["results"]) == [0, 1, 2]
    assert plan.stats()["hits"]["executor.compile"] == 2


def test_executor_invalidate_cache_prepares_again():
    main, startup, loss = tp.build(tp.T, _model)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    feed = _feed_fn()(0)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert main in exe._prepared and startup in exe._prepared
    exe.invalidate_cache(main)
    assert main not in exe._prepared and startup in exe._prepared
    with TR.fault_scope("executor.compile:1") as plan:
        with pytest.raises(TR.InjectedFault):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(lv).all()
    assert plan.stats()["hits"]["executor.compile"] == 2
    exe.invalidate_cache()
    assert not list(exe._prepared)


# -- SIGKILL and resume --------------------------------------------------------

TOTAL_STEPS = 10
KILL_AT = 4


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("FLAGS_fault_plan", None)
    return env


def _run(root, losses, kill_at, check=True):
    p = subprocess.run(
        [sys.executable, _SCRIPT, root, losses, str(TOTAL_STEPS),
         str(kill_at)], env=_env(), capture_output=True, timeout=240)
    if check:
        assert p.returncode == 0, p.stderr.decode()[-3000:]
    return p


def _trajectory(path):
    """step -> the printed loss; a resumed run's replay of the crash step
    wins (the last line of a step)."""
    out = {}
    with open(path) as f:
        for line in f:
            step, loss = line.split()
            out[int(step)] = loss
    return out


def test_sigkill_mid_run_then_resume_bit_identical(tmp_path):
    base_losses = str(tmp_path / "base.txt")
    _run(str(tmp_path / "base_ck"), base_losses, -1)
    baseline = _trajectory(base_losses)
    assert sorted(baseline) == list(range(TOTAL_STEPS))

    root = str(tmp_path / "ck")
    losses = str(tmp_path / "resumed.txt")
    p = _run(root, losses, KILL_AT, check=False)
    assert p.returncode == -9, (p.returncode, p.stderr.decode()[-2000:])
    assert sorted(_trajectory(losses)) == list(range(KILL_AT + 1))

    latest = TR.CheckpointManager(root).latest_step()
    assert latest is not None and KILL_AT - 1 <= latest <= KILL_AT, latest

    p = _run(root, losses, -1)
    assert f"start={latest + 1}".encode() in p.stdout, p.stdout
    combined = _trajectory(losses)
    assert sorted(combined) == list(range(TOTAL_STEPS))
    assert combined == baseline
