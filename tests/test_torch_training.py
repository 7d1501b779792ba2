"""The port's training stack (paddle_tpu_torch: grad registry, backward,
ops, optimizer, BERT builder) held against the JAX package's.

* Each op on the BERT path: its grad through both packages' `gradients`
  sweeps and executors on the same numpy inputs and cotangents. The JAX
  side differentiates its ops by jax.vjp; the port replays the cheap ops
  under torch.autograd and runs the kernel-backed ones (fused_attention,
  layer_norm, softmax_with_cross_entropy) on their kernels' plain versions.
* bert_tiny(use_tp=False), seq 16, after Adam.minimize: the main and startup
  programs equal the JAX package's through to_dict(); then 3 Adam steps on
  carried weights and one batch agree in loss, step-1 gradients and
  parameters.

Tolerances, fp32 on both sides with sums in another order: 2e-5 for
elementwise grads, 1e-4 (of the grad's max-abs) for grads that sum over a
row or a batch; losses rtol 1e-4; parameters after k Adam steps atol 2 k lr,
because Adam's first steps move a weight by about lr whatever its gradient's
size, so a near-zero gradient whose sign differs between packages moves it
by 2 lr. The clip and weight-decay test instead compares the grads Adam
reads, and holds the parameters to 1e-6, far inside one step, since those
grads are nowhere near zero.
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU here)

import paddle_tpu as jpt
from paddle_tpu import backward as jbw
from paddle_tpu import unique_name as jun
from paddle_tpu.models import transformer as jtr
import paddle_tpu_torch as tpt
from paddle_tpu_torch import backward as tbw
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.weights import load_params

from __graft_entry__ import _example_feed

J = dict(pt=jpt, un=jun, bw=jbw, exe=lambda: jpt.Executor(), scope=jpt.Scope)
T = dict(pt=tpt, un=tun, bw=tbw, exe=lambda: tpt.Executor(place="cpu"),
         scope=tpt.Scope)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _grads(pkg, op_type, ins, outs, attrs, cots):
    """Build `op_type` over vars named as `ins` ({slot: {name: array}}) in
    a fresh program, differentiate its `outs` ({slot: [name]}) with the
    fed cotangents `cots` ({name: array}) by the package's `gradients`,
    and return {input name: grad} for the floating inputs, plus the
    program."""
    main = pkg["pt"].Program()
    with pkg["pt"].program_guard(main, pkg["pt"].Program()), pkg["un"].guard():
        block = main.global_block
        diff = []
        for names in ins.values():
            for n, a in names.items():
                v = block.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                                     stop_gradient=a.dtype.kind != "f")
                if a.dtype.kind == "f":
                    diff.append(v)
        block.append_op(op_type, {s: list(d) for s, d in ins.items()}, outs,
                        attrs)
        targets = [block.var(n) for n in cots]
        tgs = [block.create_var(name=n + "_cot", shape=cots[n].shape,
                                dtype="float32") for n in cots]
        gvars = pkg["bw"].gradients(targets, diff, tgs)
    feed = {n: a for d in ins.values() for n, a in d.items()}
    feed.update({n + "_cot": a for n, a in cots.items()})
    fetch = [g for g in gvars if g is not None]
    vals = pkg["exe"]().run(main, feed=feed, fetch_list=fetch,
                            scope=pkg["scope"]())
    got = {}
    for v, g in zip(diff, gvars):
        if g is not None:
            got[v.name] = np.asarray(vals[fetch.index(g)])
    return got, main


def _check_op(op_type, ins, outs, attrs, cot_shapes, rtol=2e-5, atol=2e-5):
    cots = {n: _rand(s, 100 + i) for i, (n, s) in enumerate(cot_shapes.items())}
    want, _ = _grads(J, op_type, ins, outs, attrs, cots)
    got, prog = _grads(T, op_type, ins, outs, attrs, cots)
    assert sorted(got) == sorted(want) and want
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1.0)
        np.testing.assert_allclose(got[n], want[n], rtol=rtol,
                                   atol=atol * scale, err_msg=n)
    return prog


X34 = _rand((3, 4, 5), 1)

REPLAYED = [
    ("elementwise_add", {"X": {"x": X34}, "Y": {"y": _rand((5,), 2)}},
     {"axis": -1}),
    ("elementwise_mul", {"X": {"x": X34}, "Y": {"y": _rand((3, 4, 5), 3)}},
     {"axis": -1}),
    ("elementwise_div", {"X": {"x": X34},
                         "Y": {"y": 2.5 + np.abs(_rand((4, 5), 5))}},
     {"axis": -1}),
    ("reduce_sum", {"X": {"x": X34}}, {"dim": [0], "keep_dim": False,
                                      "reduce_all": True}),
    ("reshape2", {"X": {"x": X34}}, {"shape": [0, 20]}),
    ("transpose2", {"X": {"x": X34}}, {"axis": [2, 0, 1]}),
    ("slice", {"Input": {"x": X34}}, {"axes": [0], "starts": [1], "ends": [2]}),
    ("squeeze2", {"X": {"x": _rand((3, 1, 5), 6)}}, {"axes": [1]}),
    ("unsqueeze2", {"X": {"x": X34}}, {"axes": [2]}),
    ("gelu", {"X": {"x": X34}}, {}),
    ("scale", {"X": {"x": X34}}, {"scale": -1.5, "bias": 0.25,
                                 "bias_after_scale": True}),
]


def _out_shape(op_type, ins, attrs):
    """The forward output's shape, from the port's own shape inference."""
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()), tun.guard():
        block = main.global_block
        for d in ins.values():
            for n, a in d.items():
                block.create_var(name=n, shape=a.shape, dtype=str(a.dtype))
        block.append_op(op_type, {s: list(d) for s, d in ins.items()},
                        {"Out": ["out"]}, attrs)
    return block.var("out").shape


@pytest.mark.parametrize("op_type,ins,attrs", REPLAYED,
                         ids=[r[0] for r in REPLAYED])
def test_replayed_grad_matches_jax_vjp(op_type, ins, attrs):
    _check_op(op_type, ins, {"Out": ["out"]}, attrs,
              {"out": _out_shape(op_type, ins, attrs)})


def test_mul_grad_is_two_products_matching_jax():
    """mul's registered grad (dOut Y^T, X^T dOut) on fc's flattening."""
    x, w = _rand((2, 3, 8), 7), _rand((8, 6), 8)
    prog = _check_op("mul", {"X": {"x": x}, "Y": {"w": w}}, {"Out": ["out"]},
                     {"x_num_col_dims": 2, "y_num_col_dims": 1},
                     {"out": (2, 3, 6)}, rtol=1e-4, atol=1e-5)
    assert "mul_grad" in [op.type for op in prog.global_block.ops]


def test_layer_norm_grad_with_mean_and_variance_cotangents():
    """K5's plain version plus the closed-form Mean/Variance terms beside
    it, against jax.vjp of the JAX op (all three outputs get cotangents)."""
    x = _rand((4, 6, 32), 9)
    ins = {"X": {"x": x}, "Scale": {"s": 1 + _rand((32,), 10, 0.1)},
           "Bias": {"b": _rand((32,), 11, 0.1)}}
    outs = {"Y": ["y"], "Mean": ["mean"], "Variance": ["var"]}
    _check_op("layer_norm", ins, outs,
              {"begin_norm_axis": 2, "epsilon": 1e-5},
              {"y": (4, 6, 32), "mean": (4, 6), "var": (4, 6)},
              rtol=1e-4, atol=1e-4)


def test_layer_norm_grad_from_y_only():
    x = _rand((5, 48), 12)
    ins = {"X": {"x": x}, "Scale": {"s": 1 + _rand((48,), 13, 0.1)},
           "Bias": {"b": _rand((48,), 14, 0.1)}}
    _check_op("layer_norm", ins, {"Y": ["y"], "Mean": ["mean"],
                                  "Variance": ["var"]},
              {"begin_norm_axis": 1, "epsilon": 1e-5}, {"y": (5, 48)},
              rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_grad_matches_jax(causal):
    q, k, v = (_rand((2, 3, 16, 8), 20 + i) for i in range(3))
    _check_op("fused_attention", {"Q": {"q": q}, "K": {"k": k}, "V": {"v": v}},
              {"Out": ["out"]}, {"causal": causal, "sm_scale": 8 ** -0.5,
                                 "use_pallas": False},
              {"out": (2, 3, 16, 8)}, rtol=1e-4, atol=1e-4)


def test_softmax_with_cross_entropy_grad_matches_jax():
    logits = _rand((2, 5, 300), 30, 3.0)
    label = np.random.default_rng(31).integers(0, 300, (2, 5, 1)).astype(np.int32)
    _check_op("softmax_with_cross_entropy",
              {"Logits": {"logits": logits}, "Label": {"label": label}},
              {"Softmax": ["sm"], "Loss": ["loss"]},
              {"soft_label": False, "ignore_index": -100},
              {"loss": (2, 5, 1)}, rtol=1e-4, atol=1e-5)


def test_lookup_table_grad_adds_repeated_ids():
    w = _rand((10, 4), 40)
    ids = np.asarray([[1, 3, 1], [9, 1, 0]], np.int32)
    _check_op("lookup_table", {"W": {"w": w}, "Ids": {"ids": ids}},
              {"Out": ["out"]}, {"is_sparse": False, "is_distributed": False,
                                 "padding_idx": -1},
              {"out": (2, 3, 4)})


def test_replay_raises_when_an_input_reaches_no_output(monkeypatch):
    """An op whose compute has no autograd path (as a ctypes kernel has
    none) must not silently give zero gradients."""
    monkeypatch.setitem(treg._REGISTRY, "opaque_double", treg.OpDef(
        lambda ctx: {"Out": ctx.input("X").detach() * 2}))
    monkeypatch.delitem(treg._REGISTRY, "opaque_double_grad", raising=False)
    with pytest.raises(RuntimeError, match="reaches no output"):
        _grads(T, "opaque_double", {"X": {"x": X34}}, {"Out": ["out"]}, {},
               {"out": X34})


def test_two_consumers_accumulate_through_rename_and_sum():
    """x feeds a scale and an elementwise_mul(x, x): three partial grads of
    x, summed through @RENAME@ temporaries and `sum` ops as in JAX."""
    for pkg in (J, T):
        main = pkg["pt"].Program()
        with pkg["pt"].program_guard(main, pkg["pt"].Program()), pkg["un"].guard():
            L = pkg["pt"].layers
            x = L.data(name="x", shape=[4], dtype="float32",
                       stop_gradient=False)
            y = L.elementwise_add(L.scale(x, scale=3.0),
                                  L.elementwise_mul(x, x))
            loss = L.reduce_sum(y)
            (gx,) = pkg["bw"].gradients([loss], [x])
        pkg["prog"], pkg["gx"], pkg["loss"] = main, gx, loss
    types = [op.type for op in T["prog"].global_block.ops]
    assert types == [op.type for op in J["prog"].global_block.ops]
    assert types.count("sum") == 2
    assert any("@RENAME@" in n for op in T["prog"].global_block.ops
               for n in op.output_names)
    xv = _rand((2, 4), 50)
    (got,) = T["exe"]().run(T["prog"], feed={"x": xv}, fetch_list=[T["gx"]],
                            scope=T["scope"]())
    np.testing.assert_allclose(got, 3.0 + 2 * xv, rtol=1e-6)


def test_adam_op_holds_the_jax_formula():
    """One adam op through both executors, at a late step (beta powers
    well below 1) with gradients of mixed scale."""
    p, g = _rand((6, 5), 60), _rand((6, 5), 61, 1e-3)
    m1, m2 = _rand((6, 5), 62, 1e-2), np.abs(_rand((6, 5), 63, 1e-4))
    ins = {"Param": {"p": p}, "Grad": {"g": g}, "Moment1": {"m1": m1},
           "Moment2": {"m2": m2},
           "Beta1Pow": {"b1p": np.asarray([0.9 ** 7], np.float32)},
           "Beta2Pow": {"b2p": np.asarray([0.999 ** 7], np.float32)},
           "LearningRate": {"lr": np.asarray([0.01], np.float32)}}
    outs = {"ParamOut": ["p_out"], "Moment1Out": ["m1_out"],
            "Moment2Out": ["m2_out"], "Beta1PowOut": ["b1p_out"],
            "Beta2PowOut": ["b2p_out"]}
    res = []
    for pkg in (J, T):
        main = pkg["pt"].Program()
        with pkg["pt"].program_guard(main, pkg["pt"].Program()):
            block = main.global_block
            for d in ins.values():
                for n, a in d.items():
                    block.create_var(name=n, shape=a.shape, dtype="float32")
            block.append_op("adam", {s: list(d) for s, d in ins.items()},
                            outs, {"beta1": 0.9, "beta2": 0.999,
                                   "epsilon": 1e-8})
        feed = {n: a for d in ins.values() for n, a in d.items()}
        res.append(pkg["exe"]().run(main, feed=feed,
                                    fetch_list=[o[0] for o in outs.values()],
                                    scope=pkg["scope"]()))
    for a, b in zip(*res):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["l1_and_clip_by_value", "l2_and_global_norm"])
def test_clip_and_regularization_match_jax(case):
    """apply_gradients' clip and weight-decay ops (the ported clip.py and
    regularizer.py): the same program and the same Adam step as JAX's."""
    from paddle_tpu import clip as jclip
    from paddle_tpu import regularizer as jreg
    from paddle_tpu_torch import clip as tclip
    from paddle_tpu_torch import regularizer as tregz

    x = _rand((5, 8), 90)
    res = []
    for pkg, clip, reg in ((J, jclip, jreg), (T, tclip, tregz)):
        main, startup = pkg["pt"].Program(), pkg["pt"].Program()
        L = pkg["pt"].layers
        if case == "l1_and_clip_by_value":
            attr = pkg["pt"].ParamAttr(gradient_clip=clip.GradientClipByValue(0.05))
            opt_reg = reg.L1Decay(0.01)
        else:
            attr = pkg["pt"].ParamAttr(regularizer=reg.L2Decay(0.1))
            opt_reg = None
            clip.set_gradient_clip(clip.GradientClipByGlobalNorm(0.5))
        try:
            with pkg["pt"].program_guard(main, startup), pkg["un"].guard():
                xv = L.data(name="x", shape=[8], dtype="float32")
                h = L.fc(xv, size=4, param_attr=attr)
                loss = L.reduce_sum(L.elementwise_mul(h, h))
                pkg["pt"].optimizer.Adam(learning_rate=0.01,
                                         regularization=opt_reg).minimize(loss)
        finally:
            clip.set_gradient_clip(None)
        scope = pkg["scope"]()
        pkg["exe"]().run(startup, scope=scope)
        res.append((main, startup, loss, scope))
    (jm, js, jl, jsc), (tm, ts, tl, tsc) = res
    assert tm.to_dict() == jm.to_dict()
    load_params(tsc, tm, {p.name: np.array(jsc.find_var(p.name))
                          for p in jm.all_parameters()})
    # The grads Adam reads (clipped and decayed) beside the raw ones; the
    # names are equal in both programs (to_dict above).
    params = [p.name for p in tm.all_parameters()]
    applied = [op.inputs["Grad"][0] for op in tm.global_block.ops
               if op.type == "adam"]
    raw = [n + "@GRAD" for n in params]
    assert len(applied) == len(params) and set(applied).isdisjoint(raw)
    jexe, texe = J["exe"](), T["exe"]()
    for _ in range(2):
        fetch = [tl.name] + applied + raw
        a = jexe.run(jm, feed={"x": x}, fetch_list=fetch, scope=jsc)
        b = texe.run(tm, feed={"x": x}, fetch_list=fetch, scope=tsc)
        for n, va, vb in zip(fetch, a, b):
            va, vb = np.asarray(va), np.asarray(vb)
            np.testing.assert_allclose(vb, va, rtol=1e-5,
                                       atol=1e-7 * np.abs(va).max(), err_msg=n)
        # the clip and decay ops changed every grad Adam reads
        for va, vr in zip(a[1:1 + len(applied)], a[1 + len(applied):]):
            assert not np.allclose(np.asarray(va), np.asarray(vr), rtol=1e-3)
    # Both start from the same weights and step on grads equal to 1e-5, so
    # the parameters agree far inside one Adam step (about lr = 1e-2).
    for n in params:
        np.testing.assert_allclose(tsc.find_var(n).numpy(),
                                   np.asarray(jsc.find_var(n)),
                                   rtol=0, atol=1e-6, err_msg=n)


# -- the BERT pretrain program ---------------------------------------------------

LR, STEPS, B, S = 1e-3, 3, 4, 16


def _build_bert(pkg):
    main, startup = pkg["pt"].Program(), pkg["pt"].Program()
    tr = jtr if pkg is J else ttr
    with pkg["pt"].program_guard(main, startup), pkg["un"].guard():
        loss, _ = tr.bert_pretrain(tr.bert_tiny(use_tp=False), seq_len=S)
        pkg["pt"].optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss


@pytest.fixture(scope="module")
def bert():
    """Both programs, then 3 Adam steps on one batch from the JAX startup's
    weights: (programs, losses, step-1 grads, final params) per package."""
    (jm, js, jl), (tm, ts, tl) = _build_bert(J), _build_bert(T)
    feed = _example_feed(jtr.bert_tiny(use_tp=False), B, S)
    feed["lm_weight"] = (np.random.default_rng(1).random((B, S)) < 0.5
                         ).astype(np.float32)
    js.random_seed = 5
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    names = [p.name for p in jm.all_parameters()]
    tscope, texe = tpt.Scope(), tpt.Executor(place="cpu")
    texe.run(ts, scope=tscope)
    load_params(tscope, tm, {n: np.array(jscope.find_var(n)) for n in names})
    gnames = [n + "@GRAD" for n in names]
    out = {}
    for key, exe, prog, loss, scope in (("jax", jexe, jm, jl, jscope),
                                        ("torch", texe, tm, tl, tscope)):
        losses, grads = [], None
        for step in range(STEPS):
            vals = exe.run(prog, feed=feed, scope=scope,
                           fetch_list=[loss.name] + (gnames if step == 0 else []))
            losses.append(float(np.asarray(vals[0])))
            if step == 0:
                grads = {n: np.asarray(v) for n, v in zip(names, vals[1:])}
        params = {n: np.asarray(scope.find_var(n)) for n in names}
        out[key] = (losses, grads, params)
    return {"progs": ((jm, js), (tm, ts)), **out}


def test_bert_main_program_ops_identical(bert):
    (jm, _), (tm, _) = bert["progs"]
    assert tm.to_dict()["blocks"][0]["ops"] == jm.to_dict()["blocks"][0]["ops"]


def test_bert_main_program_vars_identical(bert):
    """Every var (grads, @RENAME@-free accumulators tagged is_opt_state,
    the learning rate) with its inferred shape and dtype."""
    (jm, _), (tm, _) = bert["progs"]
    assert tm.to_dict()["blocks"][0]["vars"] == jm.to_dict()["blocks"][0]["vars"]


def test_bert_startup_program_identical(bert):
    (_, js), (_, ts) = bert["progs"]
    assert ts.to_dict()["blocks"] == js.to_dict()["blocks"]


def test_bert_losses_agree_over_three_adam_steps(bert):
    jl, tl = bert["jax"][0], bert["torch"][0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]


def test_bert_step1_gradients_agree(bert):
    jg, tg = bert["jax"][1], bert["torch"][1]
    assert sorted(tg) == sorted(jg)
    for n in jg:
        scale = max(float(np.abs(jg[n]).max()), 1e-12)
        assert float(np.abs(tg[n] - jg[n]).max()) <= 1e-4 * scale, n


def test_bert_params_agree_after_three_adam_steps(bert):
    jp, tp = bert["jax"][2], bert["torch"][2]
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=0, atol=2 * STEPS * LR,
                                   err_msg=n)


def test_bert_builder_raises_on_what_is_not_ported():
    with tpt.program_guard(tpt.Program(), tpt.Program()), tun.guard():
        with pytest.raises(NotImplementedError, match="dropout"):
            ttr.bert_pretrain(ttr.bert_base(), seq_len=8)
        with pytest.raises(NotImplementedError, match="use_sp"):
            ttr.bert_pretrain(ttr.bert_tiny(use_tp=False, use_sp=True), seq_len=8)


def test_use_tp_annotations_match_jax():
    """use_tp keeps the JAX package's sharding annotations as IR metadata."""
    progs = []
    for pkg, tr in ((J, jtr), (T, ttr)):
        main = pkg["pt"].Program()
        with pkg["pt"].program_guard(main, pkg["pt"].Program()), pkg["un"].guard():
            tr.bert_pretrain(tr.bert_tiny(use_tp=True), seq_len=8)
        progs.append(main.to_dict()["blocks"][0]["vars"])
    assert progs[1] == progs[0]
    assert progs[1]["encoder.layer0.mha.qkv.w"]["sharding"] == [None, "tp"]


def test_load_params_checks_before_writing():
    tm, ts, _ = _build_bert(T)
    scope = tpt.Scope()
    tpt.Executor(place="cpu").run(ts, scope=scope)
    params = {p.name: np.zeros(p.shape, np.float32) for p in tm.all_parameters()}
    before = scope.find_var("lm_head.w").clone()
    bad = dict(params, **{"lm_head.b": np.zeros((3,), np.float32)})
    with pytest.raises(ValueError, match="lm_head.b"):
        load_params(scope, tm, bad)
    assert torch.equal(scope.find_var("lm_head.w"), before)
    with pytest.raises(KeyError, match="missing"):
        load_params(scope, tm, {k: v for k, v in params.items() if k != "lm_head.w"})
