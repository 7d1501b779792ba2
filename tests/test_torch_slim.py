"""The port's quant ops and contrib/slim held against the JAX package on the
CPU.

* The four quant ops as one-op programs through both packages: outputs
  bit for bit (both land on the same levels: the port follows what XLA
  compiles the JAX ops to), the straight-through grads equal.
* QuantizationTransformPass rewrites the JAX package's program (main and
  startup by to_dict(), before and after minimize); QAT steps through both
  packages agree within 1e-5; the JAX package's QAT case
  (tests/test_losses_and_quant.py:133) trains on the port.
* From one trained state in both scopes, QuantizationFreezePass,
  ConvertToInt8Pass and PostTrainingQuantization give the JAX package's
  programs and scope values; the int8 model saves and loads through the
  port's io and gives the frozen model's outputs.
* MagnitudePruner, sensitivity, the NAS controller and the distillation
  losses against the JAX package's.
"""
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from torch_parity import J, T, build, close, op_outputs_and_grads, run_both
from paddle_tpu_torch.weights import load_params, load_state


def _r(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


QUANT = {
    "abs_max8": ("fake_quantize_dequantize_abs_max", {"X": {"x": _r((4, 33), 1, 3.0)}},
                 {"Out": ["o"], "OutScale": ["s"]}, {"bit_length": 8}, ()),
    "abs_max4": ("fake_quantize_dequantize_abs_max", {"X": {"x": _r((3, 17), 2)}},
                 {"Out": ["o"], "OutScale": ["s"]}, {"bit_length": 4}, ()),
    "moving": ("fake_quantize_dequantize_moving_average_abs_max",
               {"X": {"x": _r((4, 33), 3, 2.0)},
                "InScale": {"ins": np.array([0.7], np.float32)}},
               {"Out": ["o"], "OutScale": ["s"]}, {"bit_length": 8,
                                                  "moving_rate": 0.9}, ("ins",)),
    "moving_test": ("fake_quantize_dequantize_moving_average_abs_max",
                    {"X": {"x": _r((4, 33), 4, 2.0)},
                     "InScale": {"ins": np.array([1.3], np.float32)}},
                    {"Out": ["o"], "OutScale": ["s"]},
                    {"bit_length": 8, "is_test": True}, ("ins",)),
    "static": ("fake_quantize_dequantize_static", {"X": {"x": _r((5, 21), 5, 2.0)}},
               {"Out": ["o"]}, {"scale": 2.7183, "bit_length": 8}, ()),
    "dequantize": ("dequantize_abs_max",
                   {"X": {"x": np.random.default_rng(6).integers(
                       -127, 128, (4, 9)).astype(np.int8)},
                    "Scale": {"sc": np.array([0.37], np.float32)}},
                   {"Out": ["o"]}, {"bit_length": 8}, ("sc",)),
}


@pytest.mark.parametrize("case", sorted(QUANT))
def test_quant_op_matches_jax(case):
    op, ins, outs, attrs, nograd = QUANT[case]
    cots = ({} if op == "dequantize_abs_max"
            else {"o": _r(ins["X"]["x"].shape, 9)})
    jo, jg, _ = op_outputs_and_grads(J, op, ins, outs, attrs, cots, nograd)
    to, tg, _ = op_outputs_and_grads(T, op, ins, outs, attrs, cots, nograd)
    assert set(to) == set(jo) and set(tg) == set(jg)
    for n in jo:
        assert to[n].dtype == jo[n].dtype, n
        np.testing.assert_array_equal(to[n], jo[n], err_msg=f"{case} {n}")
    for n in jg:
        np.testing.assert_array_equal(tg[n], cots["o"], err_msg=f"{case} d{n}")
        np.testing.assert_array_equal(tg[n], jg[n])
    if op != "dequantize_abs_max":
        # the output lies on 2^bits - 1 levels of its scale
        scale = to["s"][0] if "s" in to else np.float32(attrs["scale"])
        n = 2 ** (attrs["bit_length"] - 1) - 1
        lv = to["o"] / scale * n
        assert np.abs(lv - np.round(lv)).max() < 1e-3
        assert len(np.unique(to["o"])) <= 2 * n + 1


def _mlp(pkg, qat=True, test_clone=None):
    L, pt = pkg["L"], pkg["pt"]
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    pred = L.fc(L.fc(x, size=16, act="relu"), size=1)
    loss = L.mean(L.square_error_cost(pred, y))
    if qat:
        pkg["qpass"].QuantizationTransformPass().apply(
            pt.default_main_program(), pt.default_startup_program())
    if test_clone is not None:
        test_clone.append(pt.default_main_program().clone(for_test=True))
    pt.optimizer.SGD(0.05).minimize(loss)
    return loss, pred


def _pkgs():
    from paddle_tpu.contrib.slim import quantization as jq
    from paddle_tpu_torch.contrib.slim import quantization as tq

    return dict(J, qpass=jq), dict(T, qpass=tq)


def _feeds(n, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8, 1)).astype(np.float32)
    out = []
    for _ in range(n):
        xb = rng.standard_normal((32, 8)).astype(np.float32)
        out.append({"x": xb, "y": xb @ w})
    return out


def test_transform_pass_and_qat_steps_match_jax():
    jp, tp = _pkgs()
    jm, js, (jloss, _) = build(jp, _mlp, seed=7)
    tm, ts, (tloss, _) = build(tp, _mlp, seed=7)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    types = [op.type for op in tm.global_block.ops]
    assert types.count("fake_quantize_dequantize_abs_max") == 2
    assert types.count("fake_quantize_dequantize_moving_average_abs_max") == 2
    assert "fake_quantize_dequantize_abs_max_grad" in types
    jout, tout, jscope, tscope = run_both((jm, js), (tm, ts), _feeds(6),
                                          [jloss.name])
    close([t[0] for t in tout], [j[0] for j in jout], what="QAT losses")
    states = [v.name for v in tm.list_vars() if ".ma_scale" in v.name]
    assert states
    for n in states:
        close([tscope.find_var(n).numpy()], [np.asarray(jscope.find_var(n))],
              what=n)


def test_quantization_pass_qat_trains():
    """tests/test_losses_and_quant.py:133 on the port: 60 QAT steps of SGD
    cut the loss fivefold."""
    _, tp = _pkgs()
    main, startup, (loss, _) = build(tp, _mlp, seed=0)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
              for f in _feeds(60)]
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])


def _trained_pair():
    """The QAT program and its test clone through both packages, the JAX
    package's state after 60 steps in both scopes (the port's loaded from
    the JAX arrays)."""
    jp, tp = _pkgs()
    jt, tt = [], []
    jm, js, (_, jpred) = build(jp, lambda p: _mlp(p, test_clone=jt), seed=7)
    tm, ts, (_, tpred) = build(tp, lambda p: _mlp(p, test_clone=tt), seed=7)
    jexe, jscope = jpt.Executor(), jpt.Scope()
    jexe.run(js, scope=jscope)
    for f in _feeds(60):
        jexe.run(jm, feed=f, scope=jscope)
    texe, tscope = tpt.Executor(place="cpu"), tpt.Scope()
    texe.run(ts, scope=tscope)
    params = {p.name for p in jm.all_parameters()}
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jm.list_vars() if v.persistable}
    load_params(tscope, tm, {n: a for n, a in arrays.items() if n in params})
    load_state(tscope, tm, {n: a for n, a in arrays.items() if n not in params})
    return (jt[0], jexe, jscope, jpred), (tt[0], texe, tscope, tpred)


def test_freeze_and_int8_passes_match_jax(tmp_path):
    from paddle_tpu.contrib.slim import quantization as jq
    from paddle_tpu_torch.contrib.slim import quantization as tq

    (jtest, jexe, jscope, jpred), (ttest, texe, tscope, tpred) = _trained_pair()
    xq = {"x": _r((16, 8), 11), "y": np.zeros((16, 1), np.float32)}
    (qat_out,) = texe.run(ttest, feed=xq, fetch_list=[tpred.name], scope=tscope)
    jq.QuantizationFreezePass(jscope).apply(jtest)
    tq.QuantizationFreezePass(tscope).apply(ttest)
    assert ttest.to_dict() == jtest.to_dict()
    for w in ("fc_0.w_0", "fc_1.w_0", "fc_0.w_0@quant_scale"):
        np.testing.assert_array_equal(tscope.find_var(w).numpy(),
                                      np.asarray(jscope.find_var(w)), err_msg=w)
    assert any("in_scales" in op.attrs for op in ttest.global_block.ops)
    (frozen,) = texe.run(ttest, feed=xq, fetch_list=[tpred.name], scope=tscope)
    (jfrozen,) = jexe.run(jtest, feed=xq, fetch_list=[jpred.name], scope=jscope)
    close([frozen], [np.asarray(jfrozen)], what="frozen model")
    # the activation fakes are gone: close to the QAT clone, not equal
    np.testing.assert_allclose(frozen, qat_out, rtol=0.15, atol=0.05)
    jq.ConvertToInt8Pass(jscope).apply(jtest)
    tq.ConvertToInt8Pass(tscope).apply(ttest)
    assert ttest.to_dict() == jtest.to_dict()
    w8 = tscope.find_var("fc_0.w_0")
    assert str(w8.dtype) == "torch.int8"
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jscope.find_var("fc_0.w_0")))
    (int8_out,) = texe.run(ttest, feed=xq, fetch_list=[tpred.name], scope=tscope)
    (jint8,) = jexe.run(jtest, feed=xq, fetch_list=[jpred.name], scope=jscope)
    close([int8_out], [np.asarray(jint8)], what="int8 model")
    np.testing.assert_allclose(int8_out, frozen, rtol=1e-5)
    d = str(tmp_path / "int8")
    tpt.io.save_inference_model(d, ["x"], [ttest.global_block.var(tpred.name)],
                                texe, main_program=ttest, scope=tscope)
    scope2 = tpt.Scope()
    prog2, _, fetches = tpt.io.load_inference_model(d, texe, scope=scope2)
    assert str(scope2.find_var("fc_0.w_0").dtype) == "torch.int8"
    (again,) = texe.run(prog2, feed={"x": xq["x"]}, fetch_list=fetches, scope=scope2)
    np.testing.assert_array_equal(again, int8_out)
    with pytest.raises(ValueError, match="scope"):
        tq.QuantizationFreezePass(None)


def test_post_training_quantization_matches_jax():
    from paddle_tpu.contrib.slim import quantization as jq
    from paddle_tpu_torch.contrib.slim import quantization as tq

    jp, tp = _pkgs()
    jt, tt = [], []
    jm, js, (_, jpred) = build(jp, lambda p: _mlp(p, qat=False, test_clone=jt))
    tm, ts, (_, tpred) = build(tp, lambda p: _mlp(p, qat=False, test_clone=tt))
    rng = np.random.default_rng(5)
    calib = [{"x": rng.standard_normal((32, 8)).astype(np.float32),
              "y": np.zeros((32, 1), np.float32)} for _ in range(3)]
    jexe, jscope = jpt.Executor(), jpt.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tpt.Executor(place="cpu"), tpt.Scope()
    texe.run(ts, scope=tscope)
    load_params(tscope, tm, {p.name: np.asarray(jscope.find_var(p.name))
                             for p in jm.all_parameters()})
    with jpt.scope_guard(jscope):
        jq_prog = jq.PostTrainingQuantization(jexe, jt[0], calib, scope=jscope).quantize()
    tq_prog = tq.PostTrainingQuantization(texe, tt[0], calib, scope=tscope).quantize()
    # the calibrated scales are abs-maxes of each package's own activations
    # (fc products that round apart), the rest of the program equal
    tdict, jdict = tq_prog.to_dict(), jq_prog.to_dict()
    tscales, jscales = ([op["attrs"].pop("scale") for op in d["blocks"][0]["ops"]
                         if op["type"] == "fake_quantize_dequantize_static"]
                        for d in (tdict, jdict))
    assert tdict == jdict
    close(tscales, jscales, what="calibrated scales")
    types = [op.type for op in tq_prog.global_block.ops]
    assert types.count("fake_quantize_dequantize_static") == 4
    (got,) = texe.run(tq_prog, feed=calib[0], fetch_list=[tpred.name], scope=tscope)
    (want,) = jexe.run(jq_prog, feed=calib[0], fetch_list=[jpred.name], scope=jscope)
    close([got], [np.asarray(want)], what="PTQ outputs")


# -- pruning, NAS, distillation ----------------------------------------------


@pytest.mark.parametrize("structured", [False, True])
def test_pruner_matches_jax(structured):
    from paddle_tpu.contrib import slim as js_
    from paddle_tpu_torch.contrib import slim as ts_

    jm, jsu, _ = build(J, lambda p: _mlp(p, qat=False))
    tm, tsu, _ = build(T, lambda p: _mlp(p, qat=False))
    names = ["fc_0.w_0", "fc_1.w_0"]
    jexe, jscope = jpt.Executor(), jpt.Scope()
    jexe.run(jsu, scope=jscope)
    texe, tscope = tpt.Executor(place="cpu"), tpt.Scope()
    texe.run(tsu, scope=tscope)
    load_params(tscope, tm, {p.name: np.asarray(jscope.find_var(p.name))
                             for p in jm.all_parameters()})
    jmasks = js_.prune.MagnitudePruner(structured).apply(
        names, {names[0]: 0.5, names[1]: 0.25}, scope=jscope, program=jm)
    tmasks = ts_.prune.MagnitudePruner(structured).apply(
        names, {names[0]: 0.5, names[1]: 0.25}, scope=tscope, program=tm)
    assert tm.to_dict() == jm.to_dict()
    for n in names:
        np.testing.assert_array_equal(tmasks[n], jmasks[n])
        np.testing.assert_array_equal(tscope.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))
    feeds = _feeds(3)
    for f in feeds:
        jexe.run(jm, feed=f, scope=jscope)
        texe.run(tm, feed=f, scope=tscope)
    for n in names:
        w = tscope.find_var(n).numpy()
        assert np.all(w[jmasks[n] == 0] == 0)
        close([w], [np.asarray(jscope.find_var(n))], what=n)

    def metric(scope, get):
        return lambda: float(np.abs(get(scope, names[0])).sum())

    js = js_.prune.sensitivity(jm, jscope, jexe, names,
                               metric(jscope, lambda s, n: np.asarray(s.find_var(n))))
    ts = ts_.prune.sensitivity(tm, tscope, texe, names,
                               metric(tscope, lambda s, n: s.find_var(n).numpy()))
    assert ts.keys() == js.keys()
    for n in names:
        close(list(ts[n].values()), list(js[n].values()), what=f"sensitivity {n}")


class _Space:
    """A toy search space: reward peaks at tokens (2, 1, 3)."""

    def init_tokens(self):
        return [0, 0, 0]

    def range_table(self):
        return [4, 3, 5]

    def flops(self, tokens):
        return sum(tokens)

    def eval_tokens(self, tokens):
        return 10.0 - float(np.sum((np.asarray(tokens) - [2, 1, 3]) ** 2)), self.flops(tokens)


def test_nas_matches_jax():
    from paddle_tpu.contrib.slim import nas as jn
    from paddle_tpu_torch.contrib.slim import nas as tn

    got = []
    for mod in (jn, tn):
        s = mod.LightNASStrategy(_Space(), max_flops=5, search_steps=40, seed=3)
        got.append(s.search())
        c = mod.SAController(seed=4)
        c.reset([4, 4], [0, 0])
        trail = []
        for i in range(10):
            t = c.next_tokens()
            c.update(t, float(sum(t) - i))
            trail.append(tuple(t))
        got.append((trail, c.best_tokens, c.max_reward))
    assert got[2:] == got[:2]
    assert sum(got[0][0]) <= 5


def _distill(pkg):
    from importlib import import_module

    L = pkg["L"]
    dist = import_module(f"{pkg['pt'].__name__}.contrib.slim.distillation")
    t = L.data(name="t", shape=[5], dtype="float32")
    s = L.data(name="s", shape=[5], dtype="float32")
    a = L.data(name="a", shape=[3, 4, 4], dtype="float32")
    b = L.data(name="b", shape=[2, 4, 4], dtype="float32")
    c = L.data(name="c", shape=[3, 4, 4], dtype="float32")
    d = L.data(name="d", shape=[2, 4, 4], dtype="float32")
    return [dist.soft_label_loss(t, s, 2.0, 3.0), dist.l2_distill_loss(t, s),
            dist.fsp_loss((a, b), (c, d))]


def test_distillation_losses_match_jax():
    jprog, tprog = build(J, _distill), build(T, _distill)
    assert tprog[0].to_dict() == jprog[0].to_dict()
    feed = {"t": _r((6, 5), 20), "s": _r((6, 5), 21), "a": _r((6, 3, 4, 4), 22),
            "b": _r((6, 2, 4, 4), 23), "c": _r((6, 3, 4, 4), 24),
            "d": _r((6, 2, 4, 4), 25)}
    jout, tout, _, _ = run_both(jprog[:2], tprog[:2], [feed],
                                [v.name for v in jprog[2]])
    close(tout[0], jout[0], what="distillation losses")
