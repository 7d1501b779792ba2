"""The port's pipeline parallelism (parallel/pipeline.py, PipelineOptimizer,
the executor's delegation, FLAGS_pipeline_schedule) against the JAX
package's, on the CPU: each case of tests/test_pipeline.py and the
schedule cases of tests/test_multichip.py run through both packages on the
same programs, the port from the JAX startup's weights. The stage programs
are compared by to_dict(), losses and parameters at the JAX tests' own
rtol 1e-5 (atol 1e-6), the dispatch orders, stash peaks and bubble
accounts exactly; the port's two schedules give the same bits.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import flags as jflags
from paddle_tpu.parallel import pipeline as jpipe
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.parallel import pipeline as tpipe


def _L(pkg):
    return importlib.import_module(pkg.__name__ + ".layers")


def _exe(pkg):
    return jpt.Executor() if pkg is jpt else tpt.Executor(place="cpu")


def _build_mlp(pkg):
    L = _L(pkg)
    x = L.data(name="x", shape=[16], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    h = L.fc(x, size=8, act="relu")
    loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
    return h, loss


def _batch(rng, bs=32):
    x = rng.standard_normal((bs, 16)).astype(np.float32)
    w = rng.standard_normal((16, 1)).astype(np.float32)
    return x, (x @ w).astype(np.float32)


class _Run:
    """One package's startup and steps of a program: the JAX package's run
    makes `init` (its startup's persistables), which the port's run loads
    in place of its own startup's values."""

    def __init__(self, pkg, main, startup, init=None):
        self.pkg, self.main = pkg, main
        self.exe, self.scope = _exe(pkg), pkg.Scope()
        self.exe.run(startup, scope=self.scope)
        if pkg is jpt:
            self.init = {v.name: np.asarray(self.scope.find_var(v.name))
                         for v in startup.list_vars()
                         if self.scope.find_var(v.name) is not None}
        else:
            for k, v in (init or {}).items():
                self.scope.set_var(k, torch.from_numpy(np.array(v)))

    def step(self, feed, fetch):
        return [np.asarray(v) for v in self.exe.run(
            self.main, feed=feed, fetch_list=fetch, scope=self.scope)]

    def params(self):
        return {p.name: np.asarray(self.scope.find_var(p.name))
                for p in self.main.all_parameters()}


def _programs(pkg, build, pipeline=None, seed=7):
    """(main, startup, loss) of `build` under SGD, or under a
    PipelineOptimizer with `pipeline`'s keyword arguments (its `cut` the
    index of the value of build's first output to cut at)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        h, loss = build(pkg)
        lr = (pipeline or {}).pop("lr", 0.05)
        if pipeline is not None:
            pkg.optimizer.PipelineOptimizer(
                pkg.optimizer.SGD(lr), cut_list=[[h]], **pipeline
            ).minimize(loss)
        else:
            pkg.optimizer.SGD(lr).minimize(loss)
    return main, startup, loss


def _both(build, steps, feed, pipeline=None, fetch=(), port_pipeline=None):
    """The JAX and the port runs of one program (the port's under
    `port_pipeline` where given): each (losses, params, main, extra
    fetches of the last step, the _Run)."""
    out, init = {}, None
    for pkg in (jpt, tpt):
        pipe = port_pipeline if pkg is tpt and port_pipeline else pipeline
        main, startup, loss = _programs(pkg, build, dict(pipe)
                                        if pipe is not None else None)
        run = _Run(pkg, main, startup, init)
        init = getattr(run, "init", init)
        hist, last = [], None
        for _ in range(steps):
            vals = run.step(feed, [loss.name] + list(fetch))
            hist.append(float(vals[0].reshape(-1)[0]))
            last = vals[1:]
        out[pkg.__name__] = (hist, run.params(), main, last, run)
    return out["paddle_tpu"], out["paddle_tpu_torch"]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for n, w in want[1].items():
        np.testing.assert_allclose(got[1][n], w, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


FEED = dict(zip(("x", "y"), _batch(np.random.default_rng(0))))


@pytest.mark.parametrize("M", [4, 8], ids=["four_microbatches",
                                           "eight_microbatches"])
def test_two_stage_pipeline_matches_jax_and_the_single_device(M):
    """test_pipeline.py:59 and :68: 5 SGD steps of the 2-stage split equal
    the JAX plan's and the port's own unsplit program's."""
    jax_run, port = _both(_build_mlp, 5, FEED, dict(num_microbatches=M))
    assert len(port[2]._pipeline.stages) == 2
    _close(port, jax_run)
    _, single = _both(_build_mlp, 5, FEED)
    _close(port, single)


def test_stage_programs_equal_jax():
    """test_pipeline.py:78: each stage's forward, backward and update
    programs equal the JAX plan's by to_dict(), and so do its names."""
    jm, _, _ = _programs(jpt, _build_mlp, dict(num_microbatches=4))
    tm, _, _ = _programs(tpt, _build_mlp, dict(num_microbatches=4))
    for js, ts in zip(jm._pipeline.stages, tm._pipeline.stages):
        for which in ("fwd", "bwd", "update"):
            a, b = getattr(js, which), getattr(ts, which)
            assert (a is None) == (b is None)
            if a is not None:
                assert b.to_dict() == a.to_dict(), (js.idx, which)
        for key in ("ext_inputs", "out_names", "param_names",
                    "in_grad_names", "param_grad_names", "update_feed"):
            assert getattr(ts, key) == getattr(js, key), key
    s0, s1 = tm._pipeline.stages
    assert any(n.startswith("fc_0") for n in s0.param_names)
    assert any(n.startswith("fc_1") for n in s1.param_names)
    assert "y" in s1.ext_inputs and set(s0.out_names) <= set(s1.ext_inputs)


def _build_bn(pkg):
    L = _L(pkg)
    x = L.data(name="x", shape=[16], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    h = L.batch_norm(L.fc(x, size=8))
    return h, L.mean(L.square_error_cost(L.fc(h, size=1), y))


def test_backward_replay_shields_batch_norm_statistics():
    """test_pipeline.py:91: with lr 0 the moving mean after one pipelined
    step (2 microbatches) equals the JAX plan's, and the replay added no
    update: less than 2.1 times the unsplit program's."""
    x, y = _batch(np.random.default_rng(0), bs=8)
    feed = {"x": x, "y": y}
    means = {}
    for key, pipe in (("piped", dict(num_microbatches=2, lr=0.0)),
                      ("single", None)):
        jax_run, port = _both(_build_bn, 1, feed, pipe)
        name = next(n for n in port[4].scope.var_names() if "mean" in n)
        got = np.asarray(port[4].scope.find_var(name))
        np.testing.assert_allclose(
            got, np.asarray(jax_run[4].scope.find_var(name)), rtol=1e-5,
            atol=1e-6)
        means[key] = got
    assert np.abs(means["piped"]).sum() < \
        2.1 * np.abs(means["single"]).sum() + 1e-6


def test_batch_fetch_concatenates_over_microbatches():
    """test_pipeline.py:133: a batch-dim fetch comes back joined (8 rows
    from 4 microbatches of 2), equal to the JAX plan's."""
    x, y = _batch(np.random.default_rng(0), bs=8)
    got = {}
    init = None
    for pkg in (jpt, tpt):
        main, startup, _ = _programs(pkg, _build_mlp,
                                     dict(num_microbatches=4, lr=0.01))
        run = _Run(pkg, main, startup, init)
        init = getattr(run, "init", init)
        pred = next(v for s in main._pipeline.stages
                    for v in [s.fwd.global_block.vars.get("fc_1.tmp_1")] if v)
        got[pkg.__name__] = run.step({"x": x, "y": y}, [pred.name])[0]
    assert got["paddle_tpu_torch"].shape[0] == 8
    np.testing.assert_allclose(got["paddle_tpu_torch"], got["paddle_tpu"],
                               rtol=1e-5, atol=1e-6)


def _scheduler_lr(pkg):
    L = _L(pkg)
    with pkg.program_guard(pkg.Program(), pkg.Program()):
        x = L.data(name="x", shape=[4], dtype="float32")
        a = L.fc(x, size=4)
        loss = L.mean(L.fc(a, size=1))
        lr = L.exponential_decay(0.1, 100, 0.9)
        pkg.optimizer.PipelineOptimizer(pkg.optimizer.SGD(lr),
                                        cut_list=[[a]]).minimize(loss)


def _unordered_cuts(pkg):
    L = _L(pkg)
    with pkg.program_guard(pkg.Program(), pkg.Program()):
        x = L.data(name="x", shape=[4], dtype="float32")
        a = L.fc(x, size=4)
        b = L.fc(a, size=4)
        pkg.optimizer.PipelineOptimizer(
            pkg.optimizer.SGD(0.1), cut_list=[[b], [a]]).minimize(L.mean(b))


def _bad_batch_split(pkg):
    main, startup, _ = _programs(pkg, _build_mlp, dict(num_microbatches=4))
    scope = pkg.Scope()
    _exe(pkg).run(startup, scope=scope)
    main._pipeline.run_step(_exe(pkg), scope,
                            {"x": np.zeros((30, 16), np.float32),
                             "y": np.zeros((30, 1), np.float32)}, [])


def _tied_weights(pkg, places):
    L = _L(pkg)
    helper_mod = importlib.import_module(pkg.__name__ + ".layer_helper")
    with pkg.program_guard(pkg.Program(), pkg.Program()), \
            pkg.unique_name.guard():
        x = L.data(name="x", shape=[8], dtype="float32")
        w = helper_mod.LayerHelper("tied", name="tied").create_parameter(
            attr=pkg.ParamAttr(name="tied_w"), shape=[8, 8], dtype="float32")
        b = L.relu(L.mul(x, w))
        loss = L.mean(L.mul(b, w))
        pkg.optimizer.PipelineOptimizer(pkg.optimizer.SGD(0.1),
                                        cut_list=[[b]],
                                        place_list=places).minimize(loss)


REFUSALS = {
    "scheduler_lr": (_scheduler_lr, NotImplementedError, "scheduler"),
    "bad_batch_split": (_bad_batch_split, ValueError, "divisible"),
    "unordered_cuts": (_unordered_cuts, ValueError, "order"),
    "tied_weights": (None, NotImplementedError, "tied"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    """test_pipeline.py:153, :165, :177, :241: both packages refuse, with
    the same exception type and message."""
    fn, exc, match = REFUSALS[case]
    msgs = []
    for pkg in (jpt, tpt):
        with pytest.raises(exc, match=match) as e:
            if case == "tied_weights":
                import jax

                _tied_weights(pkg, jax.devices()[:2] if pkg is jpt
                              else [tpt.CPUPlace(), "cpu"])
            else:
                fn(pkg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_device_placement_matches_jax_and_keeps_state_on_its_device():
    """test_pipeline.py:189: stages placed on two devices (the port: two
    CPU places, named two ways; JAX: two virtual CPU devices) follow the
    unplaced trajectory, and each stage's parameters live on its stage's
    device."""
    import jax

    jax_run, port = _both(
        _build_mlp, 5, FEED,
        dict(num_microbatches=4, place_list=jax.devices()[:2]),
        port_pipeline=dict(num_microbatches=4,
                           place_list=[tpt.CPUPlace(), torch.device("cpu")]))
    _close(port, jax_run)
    _, unplaced = _both(_build_mlp, 5, FEED, dict(num_microbatches=4))
    _close(port, unplaced)
    plan = port[2]._pipeline
    assert plan.devices == [torch.device("cpu")] * 2
    for stage, dev in zip(plan.stages, plan.devices):
        for p in stage.param_names:
            assert port[4].scope.find_var(p).device == dev


def test_resolve_devices_refuses_to_guess():
    with pytest.raises(TypeError, match="refusing to guess"):
        tpipe.resolve_devices([object(), "cpu"], 2)
    with pytest.raises(ValueError, match="one device per stage"):
        tpipe.resolve_devices(["cpu"], 2)
    assert tpipe.resolve_devices([tpt.CPUPlace(), "cpu"], 2) == \
        [torch.device("cpu")] * 2


def test_clock_cycle_interleave_is_the_jax_dispatch_order():
    """test_pipeline.py:216: with two placed stages the forward fill and
    the backward drain interleave, in exactly the JAX plan's order."""
    import jax

    orders = {}
    for pkg, places in ((jpt, jax.devices()[:2]), (tpt, ["cpu", "cpu"])):
        main, startup, loss = _programs(pkg, _build_mlp,
                                        dict(num_microbatches=4,
                                             place_list=places))
        _Run(pkg, main, startup).step(FEED, [loss.name])
        orders[pkg.__name__] = list(main._pipeline.last_dispatch)
    trace = orders["paddle_tpu_torch"]
    assert [tuple(t) for t in trace] == [tuple(t) for t in
                                         orders["paddle_tpu"]]
    fwd = [e for e in trace if e[0] == "f"]
    bwd = [e for e in trace if e[0] == "b"]
    assert fwd.index(("f", 1, 0)) < fwd.index(("f", 0, 3))
    assert bwd.index(("b", 0, 0)) < bwd.index(("b", 1, 3))


def _three_stage(pkg, M, schedule, width=12):
    """tests/test_pipeline.py:261 (width 12) and tests/test_multichip.py:269
    (width 16): x -> fc relu -> fc relu -> fc, cut at both hiddens."""
    L = _L(pkg)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data(name="x", shape=[16], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h1 = L.fc(x, size=width, act="relu")
        h2 = L.fc(h1, size=8 if width == 12 else width, act="relu")
        loss = L.mean(L.square_error_cost(L.fc(h2, size=1), y))
        plan_mod = jpipe if pkg is jpt else tpipe
        main._pipeline = plan_mod.build_pipeline_plan(
            main, loss, [h1, h2], pkg.optimizer.SGD(0.05), M, startup,
            schedule=schedule)
    return main, startup, loss


def _three_stage_runs(M, schedules, steps, width=12):
    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((32, 16)).astype(np.float32),
            "y": rng.standard_normal((32, 1)).astype(np.float32)}
    out = {}
    for schedule in schedules:
        init = None
        for pkg in (jpt, tpt):
            main, startup, loss = _three_stage(pkg, M, schedule, width)
            run = _Run(pkg, main, startup, init)
            init = getattr(run, "init", init)
            hist = [float(run.step(feed, [loss.name])[0].reshape(-1)[0])
                    for _ in range(steps)]
            plan = main._pipeline
            out[(pkg.__name__, schedule)] = dict(
                hist=hist, params=run.params(), plan=plan,
                dispatch=[tuple(t) for t in plan.last_dispatch],
                peak=plan.last_peak_stash, bubble=dict(plan.last_bubble))
    return out


def test_1f1b_schedule_order_and_stash_bound_are_jax():
    """test_pipeline.py:280: 1F1B's per-stage warm-up / alternate / drain
    order and stash peaks (<= S + 1 against M for GPipe), as the JAX plan
    dispatches them."""
    M, S = 8, 3
    out = _three_stage_runs(M, ("1f1b", "gpipe"), 1)
    for schedule in ("1f1b", "gpipe"):
        t, j = out[("paddle_tpu_torch", schedule)], out[("paddle_tpu",
                                                         schedule)]
        assert t["dispatch"] == j["dispatch"] and t["peak"] == j["peak"]
    plan = out[("paddle_tpu_torch", "1f1b")]
    for s in range(S):
        seq = [k for (k, ss, _) in plan["dispatch"] if ss == s]
        w = min(S - 1 - s, M)
        assert seq == ["f"] * w + ["f", "b"] * (M - w) + ["b"] * w
    assert out[("paddle_tpu_torch", "gpipe")]["peak"] == M
    assert plan["peak"] <= S + 1


def test_1f1b_and_gpipe_give_the_same_bits_and_follow_jax():
    """test_pipeline.py:317: 5 steps of the 3-stage split under each
    schedule: the port's two schedules agree bit for bit, and each follows
    the JAX plan and the unsplit program."""
    out = _three_stage_runs(8, ("1f1b", "gpipe"), 5)
    a, b = out[("paddle_tpu_torch", "1f1b")], out[("paddle_tpu_torch",
                                                    "gpipe")]
    assert a["hist"] == b["hist"]
    for n in a["params"]:
        assert np.array_equal(a["params"][n], b["params"][n]), n
    for schedule in ("1f1b", "gpipe"):
        t, j = out[("paddle_tpu_torch", schedule)], out[("paddle_tpu",
                                                         schedule)]
        _close((t["hist"], t["params"]), (j["hist"], j["params"]))


def test_dropout_replay_uses_the_forward_masks():
    """test_pipeline.py:345: loss = mean(dropout(x W)); the update the
    pipelined step applies is the analytic one of the masks the forward
    drew (recovered from the fetched dropout output), and equals the sum
    over microbatches of plain-program gradients run at the same
    rng_counter. The JAX plan's streams differ; its update follows the
    same analytic law."""
    lr, M = 0.05, 4
    xv = np.random.default_rng(5).standard_normal((32, 16)).astype(np.float32)
    for pkg in (jpt, tpt):
        L = _L(pkg)
        plan_mod = jpipe if pkg is jpt else tpipe
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 13
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = L.data(name="x", shape=[16], dtype="float32")
            h = L.fc(x, size=8, bias_attr=False)
            d = L.dropout(h, dropout_prob=0.5)
            loss = L.mean(d)
            main._pipeline = plan_mod.build_pipeline_plan(
                main, loss, [h], pkg.optimizer.SGD(lr), M, startup,
                schedule="1f1b")
        run = _Run(pkg, main, startup)
        wname = main.all_parameters()[0].name
        w0 = np.asarray(run.scope.find_var(wname)).copy()
        _, dv = run.step({"x": xv}, [loss.name, d.name])
        w1 = np.asarray(run.scope.find_var(wname))
        mask = (dv != 0).astype(np.float32)
        assert dv.shape == (32, 8) and 0 < mask.mean() < 1
        np.testing.assert_allclose(w1, w0 - lr * xv.T @ (mask / dv.size),
                                   rtol=1e-4, atol=1e-5)
        if pkg is jpt:
            continue
        # the plain stage-1 program of each microbatch at the plan's keys
        plan = main._pipeline
        S, step = len(plan.stages), plan._step_counter
        grads = []
        for m in range(M):
            key = (1 << 30) + step * S * M + 1 * M + m
            plain, pstart = tpt.Program(), tpt.Program()
            plain.random_seed = pstart.random_seed = 13
            with tpt.program_guard(plain, pstart), tpt.unique_name.guard():
                hv = L.data(name=h.name, shape=[8], dtype="float32")
                dl = L.mean(L.dropout(hv, dropout_prob=0.5))
                (gh,) = tpt.backward.gradients([dl], [hv])
            hm = xv[m * 8:(m + 1) * 8] @ w0
            (g,) = tpt.Executor(place="cpu").run(
                plain, feed={h.name: hm}, fetch_list=[gh],
                scope=tpt.Scope(), rng_counter=key)
            grads.append(xv[m * 8:(m + 1) * 8].T @ np.asarray(g))
        np.testing.assert_allclose(w1, w0 - lr * sum(grads) / M, rtol=1e-5,
                                   atol=1e-6)


def test_non_differentiable_boundary_var():
    """test_pipeline.py:381: an int mask crossing the cut gets a zero
    cotangent of its forward shape, under both schedules, and the loss
    follows the JAX plan's."""
    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((16, 16)).astype(np.float32),
            "y": rng.standard_normal((16, 1)).astype(np.float32)}
    losses, init = {}, None
    for pkg in (jpt, tpt):
        L = _L(pkg)
        plan_mod = jpipe if pkg is jpt else tpipe
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = L.data(name="x", shape=[16], dtype="float32")
            y = L.data(name="y", shape=[1], dtype="float32")
            mask_i = L.cast(L.greater_than(x, L.zeros_like(x)), "int64")
            h = L.fc(x, size=16, act="relu")
            gate = L.reduce_mean(L.cast(mask_i, "float32"), dim=[1],
                                 keep_dim=True)
            pred = L.fc(L.elementwise_mul(h, L.cast(mask_i, "float32")),
                        size=1)
            loss = L.mean(L.square_error_cost(L.elementwise_mul(pred, gate),
                                              y))
            main._pipeline = plan_mod.build_pipeline_plan(
                main, loss, [h], pkg.optimizer.SGD(0.05), 4, startup,
                schedule="1f1b")
        assert mask_i.name in main._pipeline.stages[0].out_names
        run = _Run(pkg, main, startup, init)
        init = getattr(run, "init", init)
        for schedule in ("1f1b", "gpipe"):
            main._pipeline.schedule = schedule
            losses[(pkg.__name__, schedule)] = float(
                run.step(feed, [loss.name])[0].reshape(-1)[0])
    for schedule in ("1f1b", "gpipe"):
        got = losses[("paddle_tpu_torch", schedule)]
        assert np.isfinite(got)
        np.testing.assert_allclose(got, losses[("paddle_tpu", schedule)],
                                   rtol=1e-5)


def test_bubble_accounting_equals_jax():
    """test_multichip.py:288: both schedules report the analytic
    (S-1)/(M+S-1); GPipe stalls exactly 2(S-1) slots a stage; 1F1B stalls
    some and bounds the stash; the losses are equal; every count is the
    JAX plan's."""
    M, S = 8, 3
    out = _three_stage_runs(M, ("gpipe", "1f1b"), 1, width=16)
    for schedule in ("gpipe", "1f1b"):
        t, j = out[("paddle_tpu_torch", schedule)], out[("paddle_tpu",
                                                         schedule)]
        assert t["bubble"] == j["bubble"], (t["bubble"], j["bubble"])
        assert t["bubble"]["analytic_frac"] == round(
            tpipe.bubble_fraction(S, M), 4)
    g, f = out[("paddle_tpu_torch", "gpipe")], out[("paddle_tpu_torch",
                                                     "1f1b")]
    assert g["hist"] == f["hist"]
    assert g["bubble"]["stall_rounds_per_stage"] == [2 * (S - 1)] * S
    assert g["bubble"]["observed_frac"] == round(
        tpipe.bubble_fraction(S, M), 4)
    assert sum(f["bubble"]["stall_rounds_per_stage"]) > 0
    assert f["peak"] <= S + 1 < M <= g["peak"]


def test_pipeline_schedule_flag_default():
    """test_multichip.py:319: FLAGS_pipeline_schedule picks the schedule
    when none is passed; its default is the JAX package's, 1f1b."""
    assert tflags.get_flag("pipeline_schedule") == \
        jflags.get_flag("pipeline_schedule") == "1f1b"
    saved = tflags.get_flag("pipeline_schedule")
    tflags.set_flags({"pipeline_schedule": "gpipe"})
    try:
        main, _, _ = _three_stage(tpt, 8, None, 16)
        assert main._pipeline.schedule == "gpipe"
    finally:
        tflags.set_flags({"pipeline_schedule": saved})
    main, _, _ = _three_stage(tpt, 8, None, 16)
    assert main._pipeline.schedule == "1f1b"


def test_pipeline_refuses_a_mesh():
    """A pipelined program under a CompiledProgram mesh raises the JAX
    package's message; a tensor-parallel mesh= on the plan names the
    ROADMAP item."""
    from paddle_tpu_torch.parallel import make_mesh

    main, startup, loss = _programs(tpt, _build_mlp, dict(num_microbatches=4))
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    target = tpt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=make_mesh())
    with pytest.raises(NotImplementedError, match="CompiledProgram mesh"):
        exe.run(target, feed=FEED, fetch_list=[loss], scope=scope)
    with pytest.raises(NotImplementedError, match="parallel and distributed"):
        tpipe.build_pipeline_plan(main, loss, [], tpt.optimizer.SGD(0.1), 2,
                                  startup, mesh=make_mesh())


def test_parallel_exports_the_pipeline():
    assert tpt.parallel.PipelinePlan is tpipe.PipelinePlan
    assert tpt.parallel.build_pipeline_plan is tpipe.build_pipeline_plan
    assert tpt.parallel.bubble_fraction(2, 4) == jpipe.bubble_fraction(2, 4)


def test_pipeline_under_amp_follows_the_unsplit_amp_step():
    """PipelineOptimizer(decorate(Adam)) on bert_tiny: the stages run the
    bf16 rewrite of the forward (the same casts as the unsplit AMP
    program's), the two schedules give the same bits, and 2 steps follow
    the unsplit AMP program's losses within 2e-3 (bf16 reductions in
    microbatches); loss scaling is refused."""
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.models import transformer

    rng = np.random.default_rng(2)
    B, S = 8, 16
    feed = {"src_ids": rng.integers(0, 1024, (B, S)).astype(np.int64),
            "pos_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
            "lm_label": rng.integers(0, 1024, (B, S)).astype(np.int64),
            "lm_weight": np.ones((B, S), np.float32)}
    out = {}
    for schedule in ("gpipe", "1f1b", None):
        main, startup = tpt.Program(), tpt.Program()
        main.random_seed = startup.random_seed = 3
        with tpt.program_guard(main, startup), tpt.unique_name.guard():
            cfg = transformer.bert_tiny(use_tp=False)
            loss, _ = transformer.bert_pretrain(cfg, seq_len=S)
            opt = amp.decorate(tpt.optimizer.Adam(1e-3))
            if schedule is None:
                opt.minimize(loss)
            else:
                cut = [op for op in main.global_block.ops
                       if op.type == "layer_norm"][2].output("Y")[0]
                tpt.optimizer.PipelineOptimizer(
                    opt, cut_list=[[main.global_block.var(cut)]],
                    num_microbatches=2, schedule=schedule).minimize(loss)
        types = [op.type for op in main.global_block.ops]
        assert "cast" in types
        exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(2)]
        out[schedule] = (losses, {p.name: np.asarray(scope.find_var(p.name))
                                  for p in main.all_parameters()})
    assert out["gpipe"][0] == out["1f1b"][0]
    for n, a in out["gpipe"][1].items():
        assert np.array_equal(a, out["1f1b"][1][n]), n
    np.testing.assert_allclose(out["1f1b"][0], out[None][0], rtol=2e-3)
    with pytest.raises(NotImplementedError, match="loss scaling"):
        with tpt.program_guard(tpt.Program(), tpt.Program()):
            h, loss = _build_mlp(tpt)
            tpt.optimizer.PipelineOptimizer(
                amp.decorate(tpt.optimizer.SGD(0.1), init_loss_scaling=2.0),
                cut_list=[[h]]).minimize(loss)
