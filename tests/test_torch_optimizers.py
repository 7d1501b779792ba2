"""The port's optimizers, their update ops and wrappers
(paddle_tpu_torch/optimizer.py, ops/optimizer_ops.py) held against the JAX
package's.

* Each of the nine optimizers the port added (DGC and LARS momentum,
  Adagrad, Adamax, DecayedAdagrad, Adadelta, RMSProp, Ftrl, Lamb; RMSProp
  also centered, Ftrl also at another lr_power) and the three wrappers
  (ModelAverage, Lookahead, ExponentialMovingAverage), each under one of
  the learning-rate schedules in turn, on fc -> relu -> fc -> square error
  at B=16: the main and startup programs equal the JAX package's through
  to_dict(), then 3 steps from the JAX startup's weights and state
  (`load_params`, `load_state`) leave every parameter and every persistable
  var (accumulators, beta powers, counters, shadows, slow copies) within
  rtol 1e-5 / atol 1e-7 of the JAX package's; the wrappers' apply swaps in
  the same averages and restore brings the parameters back.
* LAMB steps 4-6 from the JAX package's step-3 state, carried by
  `load_state` (the schedule's counter, the moments and beta powers).
* DGC's in-graph sparsity ramp, step by step, against its closed form.
* `dgc` on 2^24 + 1 elements, past torch.quantile's limit, bit for bit
  against the JAX op.
* Lookahead's slow copies own their storage; `load_state`'s checks; the
  wrappers and ops not ported, which raise.

The learning rates are those of real use (1e-2 and below): with a rate of
0.1 an RMSProp step moves a weight by about 0.45, and a weight that lands
near 0 after three such steps keeps the packages' fp32 rounding of the
steps (a few units of 1e-7) against a value of 1e-2.
"""
import importlib

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU here)

import paddle_tpu as jpt
from paddle_tpu import unique_name as jun
from paddle_tpu.executor import scope_guard
import paddle_tpu_torch as tpt
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.weights import load_params, load_state

J = dict(pt=jpt, un=jun, L=importlib.import_module("paddle_tpu.layers"),
         exe=lambda: jpt.Executor(), scope=jpt.Scope)
T = dict(pt=tpt, un=tun, L=importlib.import_module("paddle_tpu_torch.layers"),
         exe=lambda: tpt.Executor(place="cpu"), scope=tpt.Scope)
TOL = dict(rtol=1e-5, atol=1e-7)
B = 16


def _schedule(L, which):
    if which == "noam":
        return L.noam_decay(4096, 2)
    if which == "cosine":
        return L.cosine_decay(1e-2, 2, 4)
    if which == "piecewise":
        return L.piecewise_decay([1, 2], [1e-2, 5e-3, 2e-3])
    return L.linear_lr_warmup(
        L.polynomial_decay(1e-2, decay_steps=6, end_learning_rate=0.0),
        warmup_steps=2, start_lr=2e-3, end_lr=1e-2)


def _optimizer(pt, case, lr):
    o = pt.optimizer
    return {
        "dgc": lambda: o.DGCMomentumOptimizer(
            lr, 0.9, rampup_begin_step=1, rampup_step=2, sparsity=[0.5, 0.9]),
        "lars": lambda: o.LarsMomentum(lr, 0.9),
        "adagrad": lambda: o.Adagrad(lr),
        "adamax": lambda: o.Adamax(lr),
        "decayed_adagrad": lambda: o.DecayedAdagrad(lr),
        "adadelta": lambda: o.Adadelta(lr),
        "rmsprop": lambda: o.RMSProp(lr, momentum=0.9),
        "rmsprop_centered": lambda: o.RMSProp(lr, momentum=0.9, centered=True),
        "ftrl": lambda: o.Ftrl(lr, l1=1e-3, l2=1e-3),
        "ftrl_lr_power": lambda: o.Ftrl(lr, l1=1e-3, l2=1e-3, lr_power=-0.6),
        "lamb": lambda: o.Lamb(lr),
        "model_average": lambda: o.Momentum(lr, 0.9),
        "lookahead": lambda: o.LookaheadOptimizer(o.Adam(lr), alpha=0.5, k=2),
        "ema": lambda: o.SGD(lr),
    }[case]()


def _build(pkg, case, schedule):
    """fc(8 -> 16, relu) -> fc(1) -> mean square error under `case`'s
    optimizer with `schedule`'s learning rate; returns (main, startup,
    loss, wrapper), the wrapper the ModelAverage or EMA object."""
    pt, L = pkg["pt"], pkg["L"]
    main, startup = pt.Program(), pt.Program()
    wrapper = None
    with pt.program_guard(main, startup), pkg["un"].guard():
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(x, size=16, act="relu")
        loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
        _optimizer(pt, case, _schedule(L, schedule)).minimize(loss)
        if case == "model_average":
            wrapper = pt.optimizer.ModelAverage(
                0.15, min_average_window=3, max_average_window=4)
        elif case == "ema":
            wrapper = pt.optimizer.ExponentialMovingAverage(0.9)
            wrapper.update()
    return main, startup, loss, wrapper


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((B, 8)).astype(np.float32),
             "y": rng.standard_normal((B, 1)).astype(np.float32)}
            for _ in range(n)]


def _state_names(program):
    return [v.name for v in program.global_block.vars.values()
            if v.persistable]


def _snapshot(program, scope):
    return {n: np.array(scope.find_var(n)) for n in _state_names(program)}


def _carry(tm, ts, arrays):
    """A port scope after its startup, holding `arrays` (a JAX scope's
    parameters and persistable vars)."""
    tscope = tpt.Scope()
    tpt.Executor(place="cpu").run(ts, scope=tscope)
    params = {p.name for p in tm.all_parameters()}
    load_params(tscope, tm, {n: a for n, a in arrays.items() if n in params})
    load_state(tscope, tm, {n: a for n, a in arrays.items()
                            if n not in params})
    return tscope


def _hold(program, jscope, tscope, what):
    for n in _state_names(program):
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)), **TOL,
                                   err_msg=f"{what}: {n}")


CASES = [(c, ("noam", "cosine", "piecewise", "warmup_poly")[i % 4])
         for i, c in enumerate(["dgc", "lars", "adagrad", "adamax",
                                "decayed_adagrad", "adadelta", "rmsprop",
                                "rmsprop_centered", "ftrl", "ftrl_lr_power",
                                "lamb", "model_average", "lookahead", "ema"])]


@pytest.mark.parametrize("case,schedule", CASES,
                         ids=[f"{c}-{s}" for c, s in CASES])
def test_optimizer_matches_jax_over_three_steps(case, schedule):
    jm, js, jl, jw = _build(J, case, schedule)
    tm, ts, tl, tw = _build(T, case, schedule)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    tscope, texe = _carry(tm, ts, _snapshot(jm, jscope)), tpt.Executor(place="cpu")
    for feed in _batches(3):
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5)
    _hold(jm, jscope, tscope, case)
    if jw is None:
        return
    names = [p.name for p in jm.all_parameters()]
    before = {n: tscope.find_var(n).clone() for n in names}
    with scope_guard(jscope), jw.apply(jexe), tw.apply(texe, scope=tscope):
        for n in names:
            swapped = tscope.find_var(n).numpy()
            np.testing.assert_allclose(swapped, np.asarray(jscope.find_var(n)),
                                       **TOL, err_msg=f"{case} apply: {n}")
            assert not np.array_equal(swapped, before[n].numpy()), n
    for n in names:
        assert torch.equal(tscope.find_var(n), before[n]), f"{case} restore {n}"


def test_lookahead_slow_copies_own_their_storage():
    """The startup program's `assign` gives each slow copy a tensor of its
    own: parameters loaded afterwards (load_params writes in place) leave
    the slow copies at their startup values."""
    tm, ts, _, _ = _build(T, "lookahead", "noam")
    scope = tpt.Scope()
    tpt.Executor(place="cpu").run(ts, scope=scope)
    slow = {op.inputs["Param"][0]: op.inputs["SlowParam"][0]
            for op in tm.global_block.ops if op.type == "lookahead"}
    assert len(slow) == len(tm.all_parameters())
    before = {n: scope.find_var(n).clone() for n in slow.values()}
    for p, n in slow.items():
        assert torch.equal(scope.find_var(p), before[n])
    load_params(scope, tm, {p.name: np.zeros(p.shape, np.float32)
                            for p in tm.all_parameters()})
    for n, t in before.items():
        assert torch.equal(scope.find_var(n), t), n


def test_lamb_steps_4_to_6_continue_from_the_jax_step_3_state():
    """The JAX package runs 6 LAMB steps under warmup + polynomial decay;
    the port starts from its state after step 3 (the counter, moments,
    beta powers and weights, by load_params and load_state) and runs steps
    4-6 on the same batches."""
    jm, js, jl, _ = _build(J, "lamb", "warmup_poly")
    tm, ts, tl, _ = _build(T, "lamb", "warmup_poly")
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    feeds = _batches(6, seed=1)
    for feed in feeds[:3]:
        jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
    snap = _snapshot(jm, jscope)
    assert float(snap["@LR_DECAY_COUNTER@"][0]) == 2.0
    tscope, texe = _carry(tm, ts, snap), tpt.Executor(place="cpu")
    lr_name = [op for op in jm.global_block.ops if op.type == "lamb"][0] \
        .inputs["LearningRate"][0]
    for feed in feeds[3:]:
        ja, jlr = jexe.run(jm, feed=feed, fetch_list=[jl, lr_name],
                           scope=jscope)
        ta, tlr = texe.run(tm, feed=feed, fetch_list=[tl, lr_name],
                           scope=tscope)
        np.testing.assert_allclose(ta, np.asarray(ja), rtol=1e-5)
        np.testing.assert_allclose(tlr, np.asarray(jlr), rtol=1e-6)
    _hold(jm, jscope, tscope, "lamb steps 4-6")
    assert float(tscope.find_var("@LR_DECAY_COUNTER@")[0]) == 5.0


def test_dgc_sparsity_ramp_follows_its_schedule():
    """rampup_begin_step 2, rampup_step 4 over a ramp of 4: sparsity 0 on
    steps 0-1, then each ramp entry for one step, then the last held; both
    packages fetch the same per-step Sparsity and dgc_v."""
    ramp = [0.25, 0.5, 0.75, 0.9]
    want = [0.0, 0.0, 0.25, 0.5, 0.75, 0.9, 0.9, 0.9]
    got = {}
    for key, pkg in (("jax", J), ("torch", T)):
        pt, L = pkg["pt"], pkg["L"]
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pkg["un"].guard():
            x = L.data(name="x", shape=[8], dtype="float32")
            y = L.data(name="y", shape=[1], dtype="float32")
            loss = L.mean(L.square_error_cost(L.fc(x, size=1), y))
            pt.optimizer.DGCMomentumOptimizer(
                1e-2, 0.9, rampup_begin_step=2, rampup_step=4,
                sparsity=ramp).minimize(loss)
        sp = [op.outputs["Sparsity"][0] for op in main.global_block.ops
              if op.type == "dgc"]
        v = [op.outputs["VOut"][0] for op in main.global_block.ops
             if op.type == "dgc"]
        scope, exe = pkg["scope"](), pkg["exe"]()
        exe.run(startup, scope=scope)
        if key == "torch":
            params = {p.name for p in main.all_parameters()}
            load_params(scope, main, {n: a for n, a in jstart.items()
                                      if n in params})
        else:
            jstart = _snapshot(main, scope)
        got[key] = [[np.asarray(a).copy() for a in exe.run(
            main, feed=f, fetch_list=sp + v, scope=scope)]
            for f in _batches(len(want))]
    for step, (j, t) in enumerate(zip(got["jax"], got["torch"])):
        for a, b in zip(j, t):
            np.testing.assert_allclose(b, a, **TOL, err_msg=f"step {step}")
        n = len(j) // 2
        assert [float(s[0]) for s in t[:n]] == [np.float32(want[step])] * n


def test_dgc_past_two_to_the_24_elements_matches_a_float64_quantile():
    """2^24 + 1 elements, which torch.quantile refuses. The threshold is
    the 0.999 quantile of |v| by jnp.quantile's linear interpolation, with
    the position q (n - 1) in float64: the JAX op computes it in float32,
    where n = 2^24 + 1 itself rounds to 2^24, and so takes the order
    statistic one below (the packages agree wherever n - 1 and the
    position are exact in float32, as in the tests above). U and V start
    at zero, as the optimizer's accumulators do, so v is g exactly and the
    released entries must be exactly those at or past the reference
    threshold."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    n = 2 ** 24 + 1
    g = torch.from_numpy(
        np.random.default_rng(3).standard_normal(n).astype(np.float32))

    class Op:
        type, inputs, outputs = "dgc", {"Grad": ["g"], "U": ["u"],
                                        "V": ["v"]}, {}
        attrs = {"momentum": 0.9, "sparsity": 0.999}

    env = {"g": g, "u": torch.zeros(n), "v": torch.zeros(n)}
    out = get_op_def("dgc").compute(ExecContext(Op, env, torch.device("cpu")))
    a = np.sort(np.abs(g.numpy())).astype(np.float64)
    pos = float(np.float32(0.999)) * (n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    thr = np.float32(a[lo] * (1 - (pos - lo)) + a[hi] * (pos - lo))
    keep = torch.from_numpy(np.abs(g.numpy()) >= thr)
    assert int(keep.sum()) == n - lo
    assert float(out["Sparsity"][0]) == np.float32(0.999)
    assert torch.equal(out["GradOut"], torch.where(keep, g, 0))
    assert torch.equal(out["VOut"], torch.where(keep, 0, g))
    assert torch.equal(out["UOut"], torch.where(keep, 0, g))


def test_load_state_checks_names_shapes_and_dtypes_before_any_write():
    tm, ts, _, _ = _build(T, "lamb", "noam")
    scope = tpt.Scope()
    tpt.Executor(place="cpu").run(ts, scope=scope)
    params = {p.name for p in tm.all_parameters()}
    good = {n: a for n, a in _snapshot(tm, scope).items() if n not in params}
    good = {n: a + 1 if a.dtype.kind == "f" else a for n, a in good.items()}
    before = _snapshot(tm, scope)
    some = sorted(good)[0]
    bad_shape = np.zeros((3, 3), np.float32)
    for bad, err in ((dict(good, extra=np.zeros(1, np.float32)), KeyError),
                     ({n: a for n, a in good.items() if n != some}, KeyError),
                     ({**good, some: bad_shape}, ValueError),
                     ({**good, some: good[some].astype(np.float64)},
                      TypeError)):
        with pytest.raises(err):
            load_state(scope, tm, bad)
        for n, a in before.items():
            np.testing.assert_array_equal(scope.find_var(n).numpy(), a)
    load_state(scope, tm, good)
    for n, a in good.items():
        np.testing.assert_array_equal(scope.find_var(n).numpy(), a)


def _sparse_lamb():
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    class Op:
        type, inputs, outputs, attrs = "lamb", {
            n: [n.lower()] for n in ("Param", "Grad", "Moment1", "Moment2",
                                     "Beta1Pow", "Beta2Pow",
                                     "LearningRate")}, {}, {}

    env = {n.lower(): torch.ones(4, 2) for n in ("Param", "Moment1",
                                                 "Moment2")}
    env.update(beta1pow=torch.ones(1), beta2pow=torch.ones(1),
               learningrate=torch.ones(1),
               grad=SelectedRows(torch.zeros(2, dtype=torch.int32),
                                 torch.ones(2, 2), 4))
    get_op_def("lamb").compute(ExecContext(Op, env, torch.device("cpu")))


def _health_sentinel():
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    class Op:
        type, inputs, outputs, attrs = "health_sentinel", {}, {}, {}

    get_op_def("health_sentinel").compute(ExecContext(Op, {}, torch.device("cpu")))


def _sharded_checkpoint_over_two_ranks():
    """save_sharded checkpoints at world size 1 only."""
    from unittest import mock

    import torch.distributed as dist

    with mock.patch.object(dist, "is_initialized", lambda: True), \
            mock.patch.object(dist, "get_world_size", lambda: 2):
        tpt.io.save_sharded(dirname="ckpt", scope=tpt.Scope())


def _dataset_guard():
    ds = tpt.DatasetFactory().create_dataset("QueueDataset")
    tpt.Executor(place="cpu").train_from_dataset(
        tpt.Program(), ds, scope=tpt.Scope(), guard=object())


@pytest.mark.parametrize("call,match", [
    (_sharded_checkpoint_over_two_ranks, "parallel and distributed"),
    (lambda: tpt.optimizer.PipelineOptimizer(tpt.optimizer.Adam(1e-3)),
     "parallel and distributed"),
    (_sparse_lamb, "does not support SelectedRows .* use SGD for "
                   "is_sparse embeddings, or is_sparse=False"),
    (_health_sentinel, "the guardrails and the runner"),
    (_dataset_guard, "the guardrails and the runner"),
], ids=["sharded_checkpoint", "pipeline", "sparse_grad", "health_sentinel",
        "dataset_guard"])
def test_what_is_not_ported_raises_naming_its_roadmap_item(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call()
