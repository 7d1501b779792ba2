"""The port's collective fleet outside a process group, its refusals, the
`collective_stall` watchdog drill, and the launcher (two gloo ranks as
subprocesses, a dying rank, the timeout, the PS launcher's refusal)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu_torch as tpt
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.parallel import get_comm_context, make_mesh

import torch_dp_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mlp(spec):
    main, startup, loss, _ = cases.programs(tpt, spec, 1)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    return main, loss, exe, scope


def test_one_rank_fleet_equals_the_plain_program_bit_for_bit():
    """World size 1: the transpiled program under with_collective (every
    op over a group of one) gives the untranspiled program's bits."""
    feed = {"x": np.ones((4, 16), np.float32), "y": np.ones((4, 1),
                                                            np.float32)}
    runs = {}
    for mode in ("plain", "fleet"):
        main, loss, exe, scope = _mlp(dict(model="mlp", mode=mode,
                                           opt="adam", zero1=True))
        target = (main if mode == "plain" else
                  tpt.CompiledProgram(main).with_collective(mesh=make_mesh()))
        for _ in range(3):
            exe.run(target, feed=feed, fetch_list=[loss], scope=scope)
        runs[mode] = {p.name: np.asarray(scope.find_var(p.name))
                      for p in main.all_parameters()}
    for n, a in runs["plain"].items():
        assert np.array_equal(a, runs["fleet"][n]), n


def test_collective_stall_raises_stall_error_in_shard_map_mode():
    from paddle_tpu_torch.resilience.faults import fault_scope
    from paddle_tpu_torch.resilience.watchdog import StallError

    main, loss, exe, scope = _mlp(dict(model="mlp", mode="grad_allreduce",
                                       bucket_mb=4.0))
    feed = {"x": np.ones((4, 16), np.float32), "y": np.ones((4, 1),
                                                            np.float32)}
    compiled = tpt.CompiledProgram(main).with_collective(mesh=make_mesh())
    saved = tflags.get_flag("watchdog_stall_s")
    tflags.set_flags({"watchdog_stall_s": 0.25})
    try:
        with fault_scope("collective_stall:1") as plan:
            exe.run_async(main, feed=feed, scope=scope)
            exe.wait()    # a plain step does not reach the site
            assert plan.stats()["hits"].get("collective_stall", 0) == 0
            exe.run_async(compiled, feed=feed, scope=scope)
            with pytest.raises(StallError) as ei:
                exe.wait()
        err = ei.value
        assert "collective allreduce" in str(err)
        assert err.state["spmd_mode"] == "shard_map"
        assert err.state["inflight_step_ids"] and err.state["inflight_depth"]
        exe.drain_quiet()
    finally:
        tflags.set_flags({"watchdog_stall_s": saved})


def test_a_ring_registered_to_a_missing_axis_raises():
    main, loss, exe, scope = _mlp(dict(model="mlp", mode="fleet"))
    ctx = get_comm_context()
    ctx.register_ring(3, "tp")
    try:
        compiled = tpt.CompiledProgram(main).with_collective(mesh=make_mesh())
        with pytest.raises(ValueError, match="ring 3 .* 'tp'"):
            exe.run(compiled, feed={"x": np.ones((2, 16), np.float32),
                                    "y": np.ones((2, 1), np.float32)},
                    scope=scope)
    finally:
        ctx.unregister_ring(3)


def test_a_batch_that_does_not_divide_over_the_ranks_raises():
    mesh = make_mesh()
    mesh.groups["dp"].size = 2      # as a rank of a world of two sees it
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_feed({"x": np.ones((3, 4), np.float32)})


def test_nccl_with_two_ranks_on_one_device_raises(monkeypatch):
    import torch

    from paddle_tpu_torch.distributed import init_parallel_env

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("PADDLE_NPROC_PER_NODE", "2")
    with pytest.raises(ValueError, match="NCCL cannot run two ranks"):
        init_parallel_env("127.0.0.1:1", 2, 0, backend="nccl",
                          device="cuda:0")
    with pytest.raises(ValueError, match="carries CUDA tensors"):
        init_parallel_env("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")


def test_fleet_parameter_server_mode_raises_naming_the_ps_stack():
    from paddle_tpu_torch.incubate.fleet import parameter_server as ps

    with pytest.raises(NotImplementedError, match="parallel and distributed"):
        ps.fleet.distributed_optimizer(tpt.optimizer.SGD(0.1))


_SCRIPT = textwrap.dedent("""
    import os, sys, time
    if os.environ.get("DIE_RANK") == os.environ["PADDLE_TRAINER_ID"]:
        sys.exit(3)
    if os.environ.get("HANG"):
        time.sleep(60)
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.ops.collective_ops import _all_reduce
    from paddle_tpu_torch.parallel import make_mesh
    env = init_parallel_env(device="cpu")
    g = make_mesh().group("dp")
    s = _all_reduce(g, torch.tensor([env.rank + 1.0]))
    print("rank", env.rank, "of", env.world_size, g.backend, float(s))
""")


def _launch(tmp_path, extra_env=None, timeout=60, cli=False):
    """Two gloo ranks of the job script: through `python -m ...launch`
    (cli) or the launcher's `launch(args)` in this process. Returns (exit
    code, the ranks' logs)."""
    from paddle_tpu_torch.distributed import launch

    script = tmp_path / "job.py"
    script.write_text(_SCRIPT.format(repo=REPO))
    argv = ["--nproc_per_node", "2", "--backend", "gloo", "--log_dir",
            str(tmp_path / "log"), "--timeout", str(timeout), str(script)]
    env = dict(os.environ, **(extra_env or {}))
    if cli:
        rc = subprocess.run([sys.executable, "-m",
                             "paddle_tpu_torch.distributed.launch", *argv],
                            cwd=REPO, env=env, timeout=120).returncode
    else:
        saved = dict(os.environ)
        os.environ.update(env)
        try:
            rc = launch.launch(launch._parse_args(argv))
        finally:
            os.environ.clear()
            os.environ.update(saved)
    logs = [(tmp_path / "log" / f"workerlog.{i}").read_text()
            for i in range(2)]
    return rc, logs


def test_launcher_runs_two_gloo_ranks(tmp_path):
    rc, logs = _launch(tmp_path, cli=True)
    assert rc == 0, logs
    for i, log in enumerate(logs):
        assert f"rank {i} of 2 gloo 3.0" in log, log


def test_launcher_stops_the_job_when_a_rank_dies(tmp_path):
    rc, logs = _launch(tmp_path, {"DIE_RANK": "1"})
    assert rc == 3, logs


def test_launcher_kills_the_job_past_its_timeout(tmp_path):
    rc, _ = _launch(tmp_path, {"HANG": "1"}, timeout=1)
    assert rc == 124


def test_parameter_server_launcher_raises():
    from paddle_tpu_torch.distributed import launch

    args = launch._parse_args(["--server_num", "1", "x.py"])
    with pytest.raises(NotImplementedError, match="PS stack"):
        launch.launch(args)
