"""The port's ResNet training slice (paddle_tpu_torch: conv2d, pool2d,
batch_norm and conv2d_bn on the batch-norm apply kernels' plain versions,
momentum and sgd, the minimize-time passes, models.resnet) held against
the JAX package's, all on the CPU.

* Each new op: outputs and grads through both packages' `gradients` sweeps
  and executors on the same numpy inputs and cotangents. The JAX side
  differentiates by jax.vjp over its lowering; the port runs registered
  grad computes (conv2d by the library's backward call, batch_norm and
  conv2d_bn by K9's plain version plus the statistics' chain) or replays.
* The three behaviours of the epilogue pass, on the port.
* `to_dict()` equality of the training programs of resnet_cifar10 and of
  NHWC space-to-depth resnet50 (64x64) under both settings of the port's
  `fuse_epilogue` (JAX: `pallas_epilogue` "on" / "off").
* 2 Momentum steps of resnet_cifar10 (fused programs) and of NHWC
  space-to-depth resnet18 at 64x64 (unfused programs), B=4, from the JAX
  startup's weights, against the JAX package with conv_implicit_gemm off.

Tolerances, fp32 on both sides with sums in another order: op outputs
1e-5; op grads 1e-4 of the grad's max-abs (a grad through batch statistics
sums over the batch twice); network losses rtol 1e-4 and running
statistics rtol 1e-4; network gradients, and what one Momentum step makes
of them, 1e-4 of each array's max-abs as long as both packages agree on
every relu mask of the step, which the test counts (`_step1_error` says
what holds otherwise, and why).
"""
import importlib

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU here)

import paddle_tpu as jpt
from paddle_tpu import backward as jbw
from paddle_tpu import flags as jflags
from paddle_tpu import unique_name as jun
from paddle_tpu.models import resnet as jrn
import paddle_tpu_torch as tpt
from paddle_tpu_torch import backward as tbw
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.models import resnet as trn
from paddle_tpu_torch.weights import load_params
from torch_threads import one_intra_op_thread  # noqa: F401

J = dict(pt=jpt, un=jun, bw=jbw, rn=jrn, exe=lambda: jpt.Executor(),
         scope=jpt.Scope, L=importlib.import_module("paddle_tpu.layers"))
T = dict(pt=tpt, un=tun, bw=tbw, rn=trn,
         exe=lambda: tpt.Executor(place="cpu"), scope=tpt.Scope,
         L=importlib.import_module("paddle_tpu_torch.layers"))


@pytest.fixture(autouse=True)
def _flags():
    """The JAX baseline arm (conv_implicit_gemm off), and both packages'
    pass flags restored after each test."""
    saved_j = {k: jflags.get_flag(k) for k in
               ("conv_implicit_gemm", "pallas_epilogue", "bn_fuse_stats")}
    saved_t = {k: tflags.get_flag(k) for k in ("fuse_epilogue", "bn_fuse_stats")}
    jflags.set_flags({"conv_implicit_gemm": "off"})
    yield
    jflags.set_flags(saved_j)
    tflags.set_flags(saved_t)


def _set_fuse(on: bool):
    jflags.set_flags({"pallas_epilogue": "on" if on else "off"})
    tflags.set_flags({"fuse_epilogue": on})


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _run_op(pkg, op_type, ins, outs, attrs, cots=None, no_grad=()):
    """Build `op_type` over vars named as `ins` ({slot: {name: array}}) in
    a fresh program; fetch every output of `outs` ({slot: [name]}) and,
    with `cots` ({output name: cotangent}), the grads of the floating
    inputs outside `no_grad` by the package's `gradients`."""
    main = pkg["pt"].Program()
    with pkg["pt"].program_guard(main, pkg["pt"].Program()), pkg["un"].guard():
        block = main.global_block
        diff = []
        for names in ins.values():
            for n, a in names.items():
                stop = a.dtype.kind != "f" or n in no_grad
                v = block.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                                     stop_gradient=stop)
                if not stop:
                    diff.append(v)
        block.append_op(op_type, {s: list(d) for s, d in ins.items()}, outs,
                        attrs)
        gvars = []
        if cots:
            targets = [block.var(n) for n in cots]
            tgs = [block.create_var(name=n + "_cot", shape=cots[n].shape,
                                    dtype="float32") for n in cots]
            gvars = pkg["bw"].gradients(targets, diff, tgs)
    feed = {n: a for d in ins.values() for n, a in d.items()}
    feed.update({n + "_cot": a for n, a in (cots or {}).items()})
    out_names = [n for ns in outs.values() for n in ns]
    gfetch = [g for g in gvars if g is not None]
    vals = pkg["exe"]().run(main, feed=feed, fetch_list=out_names + gfetch,
                            scope=pkg["scope"]())
    res = {n: np.asarray(v) for n, v in zip(out_names, vals)}
    grads = {v.name: np.asarray(vals[len(out_names) + gfetch.index(g)])
             for v, g in zip(diff, gvars) if g is not None}
    return res, grads, main


def _check_op(op_type, ins, outs, attrs, cot_names=(), no_grad=(),
              out_tol=1e-5, grad_tol=1e-4):
    """Outputs within out_tol (rtol and atol), grads within grad_tol of
    each grad's max-abs, port against JAX. The cotangents take the JAX
    outputs' shapes."""
    want, _, _ = _run_op(J, op_type, ins, outs, attrs)
    cots = {n: _rand(want[n].shape, 100 + i) for i, n in enumerate(cot_names)}
    want, wgrads, _ = _run_op(J, op_type, ins, outs, attrs, cots, no_grad)
    got, grads, prog = _run_op(T, op_type, ins, outs, attrs, cots, no_grad)
    for n in want:
        assert got[n].shape == want[n].shape, n
        np.testing.assert_allclose(got[n], want[n], rtol=out_tol, atol=out_tol,
                                   err_msg=n)
    assert sorted(grads) == sorted(wgrads)
    assert bool(wgrads) == bool(cot_names)
    for n in wgrads:
        scale = max(float(np.abs(wgrads[n]).max()), 1e-6)
        assert float(np.abs(grads[n] - wgrads[n]).max()) <= grad_tol * scale, n
    return prog


# -- conv2d, depthwise_conv2d, pool2d ----------------------------------------

CONVS = {
    "nchw_stride2": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3),
                     dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1],
                          groups=1, data_format="NCHW")),
    "nchw_groups2_dilated": ("conv2d", (2, 4, 9, 9), (6, 2, 3, 3),
                             dict(strides=[1, 1], paddings=[2, 2],
                                  dilations=[2, 2], groups=2,
                                  data_format="NCHW")),
    "nchw_asymmetric_pads": ("conv2d", (2, 3, 8, 8), (5, 3, 4, 4),
                             dict(strides=[1, 1], paddings=[2, 1, 2, 1],
                                  dilations=[1, 1], groups=1,
                                  data_format="NCHW")),
    "nhwc_hwio_stride2": ("conv2d", (2, 9, 9, 4), (3, 3, 4, 6),
                          dict(strides=[2, 2], paddings=[1, 1],
                               dilations=[1, 1], groups=1,
                               data_format="NHWC")),
    "nhwc_asymmetric_pads": ("conv2d", (2, 8, 8, 12), (4, 4, 12, 5),
                             dict(strides=[1, 1], paddings=[2, 1, 2, 1],
                                  dilations=[1, 1], groups=1,
                                  data_format="NHWC")),
    "nhwc_groups2": ("conv2d", (2, 7, 7, 4), (3, 3, 2, 6),
                     dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1],
                          groups=2, data_format="NHWC")),
    "depthwise": ("depthwise_conv2d", (2, 4, 7, 7), (4, 1, 3, 3),
                  dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1],
                       groups=4, data_format="NCHW")),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv2d_and_its_grad_match_jax(case):
    op_type, xs, ws, attrs = CONVS[case]
    prog = _check_op(op_type, {"Input": {"x": _rand(xs, 1)},
                               "Filter": {"w": _rand(ws, 2, 0.3)}},
                     {"Output": ["out"]}, attrs, ["out"])
    # the registered grad, not a replay of the forward conv
    assert op_type + "_grad" in [op.type for op in prog.global_block.ops]


POOLS = {
    "max_nchw": ((2, 3, 9, 9), dict(pooling_type="max", ksize=[3, 3],
                                    strides=[2, 2], paddings=[1, 1])),
    "max_nhwc": ((2, 9, 9, 3), dict(pooling_type="max", ksize=[3, 3],
                                    strides=[2, 2], paddings=[1, 1],
                                    data_format="NHWC")),
    "avg_exclusive": ((2, 3, 8, 8), dict(pooling_type="avg", ksize=[3, 3],
                                         strides=[2, 2], paddings=[1, 1],
                                         exclusive=True)),
    "avg_inclusive": ((2, 3, 8, 8), dict(pooling_type="avg", ksize=[3, 3],
                                         strides=[2, 2], paddings=[1, 1],
                                         exclusive=False)),
    "avg_global_nchw": ((2, 3, 5, 6), dict(pooling_type="avg", ksize=[2, 2],
                                           global_pooling=True)),
    "avg_global_nhwc": ((2, 5, 6, 3), dict(pooling_type="avg", ksize=[2, 2],
                                           global_pooling=True,
                                           data_format="NHWC")),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pool2d_and_its_grad_match_jax(case):
    xs, attrs = POOLS[case]
    attrs = dict(dict(strides=[1, 1], paddings=[0, 0], global_pooling=False,
                      exclusive=True, data_format="NCHW"), **attrs)
    _check_op("pool2d", {"X": {"x": _rand(xs, 3)}}, {"Out": ["out"]}, attrs,
              ["out"])


# -- batch_norm, conv2d_bn ---------------------------------------------------

BN_OUTS = {"Y": ["y"], "MeanOut": ["mean"], "VarianceOut": ["var"],
           "SavedMean": ["saved_mean"], "SavedVariance": ["saved_var"]}


def _bn_ins(xs, C, residual):
    ins = {"X": {"x": _rand(xs, 10) * 2 + 0.5},
           "Scale": {"scale": 1 + _rand((C,), 11, 0.2)},
           "Bias": {"bias": _rand((C,), 12, 0.2)},
           "Mean": {"mean": _rand((C,), 13, 0.1)},
           "Variance": {"var": 1 + np.abs(_rand((C,), 14, 0.3))}}
    if residual:
        ins["Residual"] = {"res": _rand(xs, 15)}
    return ins


@pytest.mark.parametrize("layout,xs", [("NCHW", (4, 5, 6, 7)),
                                       ("NHWC", (4, 6, 7, 5))])
@pytest.mark.parametrize("is_test", [False, True], ids=["train", "is_test"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "relu_residual"])
def test_batch_norm_and_its_grad_match_jax(layout, xs, is_test, fused):
    """Y, the running statistics and the saved ones; grads of X, Scale,
    Bias (and Residual) from a cotangent on Y. Mean and Variance are
    stop_gradient, as the layer declares them."""
    attrs = dict(momentum=0.9, epsilon=1e-5, is_test=is_test,
                 data_layout=layout)
    if fused:
        attrs["act"] = "relu"
    _check_op("batch_norm", _bn_ins(xs, 5, fused), BN_OUTS, attrs, ["y"],
              no_grad=("mean", "var"))


@pytest.mark.parametrize("fmt,xs,ws", [("NCHW", (4, 3, 8, 8), (6, 3, 3, 3)),
                                       ("NHWC", (4, 8, 8, 3), (3, 3, 3, 6))])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "relu_residual"])
def test_conv2d_bn_and_its_grad_match_jax(fmt, xs, ws, fused):
    """The fused op the stats pass builds: conv, batch statistics of its
    output, apply with act and Residual; grads of Input, Filter, Scale,
    Bias and Residual."""
    ins = _bn_ins(xs, 6, False)
    ins["Input"] = {"x": ins.pop("X")["x"]}
    ins["Filter"] = {"w": _rand(ws, 16, 0.3)}
    attrs = dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1], groups=1,
                 data_format=fmt, epsilon=1e-5, momentum=0.9)
    if fused:
        attrs["act"] = "relu"
        ins["Residual"] = {"res": _rand((4, 6, 4, 4) if fmt == "NCHW"
                                        else (4, 4, 4, 6), 17)}
    _check_op("conv2d_bn", ins, BN_OUTS, attrs, ["y"], no_grad=("mean", "var"))


class _Op:
    """A bare op for an op's compute: type, slots ({slot: [name]}), attrs."""

    def __init__(self, type, inputs, outputs, attrs):
        self.type, self.inputs, self.outputs, self.attrs = (type, inputs,
                                                            outputs, attrs)


@pytest.mark.parametrize("layout,xs", [("NCHW", (4, 5, 6, 7)),
                                       ("NHWC", (4, 6, 7, 5))])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "relu_residual"])
def test_batch_norm_training_on_bf16_inputs_matches_jax_vjp(layout, xs, fused):
    """Training batch_norm with bf16 X (and Residual) and a bf16 cotangent,
    fp32 parameters and statistics: the port's op and its grad op (K9's
    plain version: the sums, their fold and the statistics' chain, dx
    rounded once) against jax.vjp of the JAX package's op on the same
    values. Y, dX and dResidual are bf16: within 2^-7 of the value plus a
    hundredth of the max-abs (sums in another order put a value near a
    rounding boundary one unit apart); dScale and dBias are fp32 sums of
    the same products in another order: within 1e-4 of the max-abs."""
    import jax.numpy as jnp
    from paddle_tpu.ops.registry import ExecContext as JCtx
    from paddle_tpu.ops.registry import get_op_def as jop
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    C = xs[1] if layout == "NCHW" else xs[-1]
    ins = _bn_ins(xs, C, fused)
    attrs = dict(momentum=0.9, epsilon=1e-5, is_test=False, data_layout=layout)
    if fused:
        attrs["act"] = "relu"
    slots = {s: list(d) for s, d in ins.items()}
    fwd = _Op("batch_norm", slots, {"Y": ["y"]}, attrs)
    low = ["x"] + (["res"] if fused else [])
    vals = {n: a for d in ins.values() for n, a in d.items()}
    cot = _rand(xs, 30)

    def jax_y(*args):
        env = {n: jnp.asarray(a) for n, a in vals.items()}
        env.update(zip(low + ["scale", "bias"], args))
        return jop("batch_norm").compute(JCtx(fwd, env))["Y"]

    jargs = [jnp.asarray(vals[n], jnp.bfloat16) for n in low]
    jargs += [jnp.asarray(vals[n]) for n in ("scale", "bias")]
    jy, pull = jax.vjp(jax_y, *jargs)
    want = dict(zip(low + ["scale", "bias"],
                    pull(jnp.asarray(cot, jnp.bfloat16))))

    env = {n: torch.from_numpy(a) for n, a in vals.items()}
    for n in low:
        env[n] = env[n].to(torch.bfloat16)
    cpu, stash = torch.device("cpu"), {}
    y = get_op_def("batch_norm").compute(ExecContext(fwd, env, cpu, stash=stash))["Y"]
    grad = _Op("batch_norm_grad",
               {"Y@GRAD": ["y@GRAD"], "Scale": ["scale"], "Bias": ["bias"],
                **({"Residual": ["res"]} if fused else {})},
               {"X@GRAD": ["x@GRAD"], "Scale@GRAD": ["scale@GRAD"],
                "Bias@GRAD": ["bias@GRAD"],
                **({"Residual@GRAD": ["res@GRAD"]} if fused else {})}, attrs)
    env["y@GRAD"] = torch.from_numpy(cot).to(torch.bfloat16)
    got = get_op_def("batch_norm_grad").compute(
        ExecContext(grad, env, cpu, stash=stash))

    def close(t, w, rtol, floor):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        np.testing.assert_allclose(t.float().numpy(), w, rtol=rtol,
                                   atol=floor * float(np.abs(w).max()))

    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    close(y, jy, 2 ** -7, 1e-2)
    for slot, n in [("X@GRAD", "x"), ("Residual@GRAD", "res")][:len(low)]:
        assert got[slot].dtype == torch.bfloat16
        close(got[slot], want[n], 2 ** -7, 1e-2)
    for slot, n in (("Scale@GRAD", "scale"), ("Bias@GRAD", "bias")):
        assert got[slot].dtype == torch.float32
        close(got[slot], want[n], 0, 1e-4)


def test_batch_norm_grad_raises_on_a_saved_statistics_cotangent():
    """A cotangent on SavedMean no longer raises: the grad op folds it into
    the statistics' chain, and X, Scale and Bias grads follow the JAX op's
    jax.vjp (tests/test_torch_dp_sync.py holds the other outputs)."""
    _check_op("batch_norm", _bn_ins((4, 5, 6, 7), 5, False), BN_OUTS,
              dict(momentum=0.9, epsilon=1e-5, is_test=False,
                   data_layout="NCHW"), ["y", "saved_mean"],
              no_grad=("mean", "var"))


# -- momentum, sgd, space_to_depth, accuracy ---------------------------------


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_op_holds_the_jax_formula(nesterov):
    ins = {"Param": {"p": _rand((6, 5), 20)}, "Grad": {"g": _rand((6, 5), 21)},
           "Velocity": {"v": _rand((6, 5), 22, 0.1)},
           "LearningRate": {"lr": np.asarray([0.1], np.float32)}}
    _check_op("momentum", ins, {"ParamOut": ["p_out"], "VelocityOut": ["v_out"]},
              {"mu": 0.9, "use_nesterov": nesterov}, out_tol=1e-6)


def test_sgd_op_holds_the_jax_formula():
    ins = {"Param": {"p": _rand((6, 5), 23)}, "Grad": {"g": _rand((6, 5), 24)},
           "LearningRate": {"lr": np.asarray([0.05], np.float32)}}
    _check_op("sgd", ins, {"ParamOut": ["p_out"]}, {}, out_tol=1e-6)


def test_sgd_raises_on_a_sparse_gradient():
    """sgd on a SelectedRows grad (duplicate rows) is the JAX sgd's row
    update within 1e-6, rows it does not name keep their bits. (Before the
    sparse path was ported this test held its refusal.)"""
    import jax.numpy as jnp
    from paddle_tpu.core.selected_rows import SelectedRows as JSR
    from paddle_tpu.ops.registry import ExecContext as JCtx
    from paddle_tpu.ops.registry import get_op_def as jdef
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    class Op:
        type, inputs, outputs, attrs = "sgd", {"Param": ["p"], "Grad": ["g"],
                                               "LearningRate": ["lr"]}, {}, {}

    p, vals = _rand((8, 2), 30), _rand((5, 2), 31)
    rows = np.array([1, 4, 1, 6, 4], np.int32)
    lr = np.asarray([0.05], np.float32)
    env = {"p": torch.from_numpy(p), "lr": torch.from_numpy(lr),
           "g": SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), 8)}
    got = get_op_def("sgd").compute(
        ExecContext(Op, env, torch.device("cpu")))["ParamOut"].numpy()
    want = np.asarray(jdef("sgd").compute(JCtx(Op, {
        "p": jnp.asarray(p), "lr": jnp.asarray(lr),
        "g": JSR(jnp.asarray(rows), jnp.asarray(vals), 8)}))["ParamOut"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    untouched = [0, 2, 3, 5, 7]
    np.testing.assert_array_equal(got[untouched], p[untouched])


def test_space_to_depth_and_its_grad_match_jax():
    _check_op("space_to_depth", {"X": {"x": _rand((2, 3, 6, 8), 25)}},
              {"Out": ["out"]}, {"blocksize": 2}, ["out"], out_tol=0)


def test_accuracy_and_top_k_match_jax():
    logits = _rand((16, 7), 26)
    label = np.random.default_rng(27).integers(0, 7, (16, 1)).astype(np.int64)
    res = []
    for pkg in (J, T):
        main = pkg["pt"].Program()
        with pkg["pt"].program_guard(main, pkg["pt"].Program()), pkg["un"].guard():
            x = pkg["L"].data(name="x", shape=[7], dtype="float32")
            y = pkg["L"].data(name="y", shape=[1], dtype="int64")
            acc = pkg["L"].accuracy(x, y, k=2)
            vals, idx = pkg["L"].topk(x, 3)
        res.append([np.asarray(v) for v in pkg["exe"]().run(
            main, feed={"x": logits, "y": label}, fetch_list=[acc, vals, idx],
            scope=pkg["scope"]())] + [main.to_dict()])
    (ja, jv, ji, jd), (ta, tv, ti, td) = res
    assert td == jd
    assert ta.shape == (1,) and 0 < float(ta[0]) < 1
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)


def test_conv2d_transpose_names_what_is_missing():
    """The layer sizes its filter from filter_size or, without one, from
    output_size; given neither it raises, naming both."""
    with tpt.program_guard(tpt.Program(), tpt.Program()), tun.guard():
        x = T["L"].data(name="x", shape=[3, 8, 8], dtype="float32")
        with pytest.raises(ValueError, match="filter_size or output_size"):
            T["L"].conv2d_transpose(x, 4)
        y = T["L"].conv2d_transpose(x, 4, output_size=17, stride=2)
    assert y.shape == (-1, 4, 17, 17)


TRANSPOSES = {
    "stride2_pad1": ((2, 4, 5, 5), (4, 3, 3, 3),
                     dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1])),
    "dilated": ((2, 3, 6, 6), (3, 5, 3, 3),
                dict(strides=[1, 1], paddings=[2, 2], dilations=[2, 2])),
    "k4_stride2": ((1, 2, 4, 7), (2, 3, 4, 4),
                   dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1])),
    "stride_1x3": ((2, 3, 5, 4), (3, 2, 2, 3),
                   dict(strides=[1, 3], paddings=[0, 1], dilations=[1, 1])),
}


@pytest.mark.parametrize("case", sorted(TRANSPOSES))
def test_conv2d_transpose_and_its_grad_match_jax(case):
    xs, ws, attrs = TRANSPOSES[case]
    _check_op("conv2d_transpose",
              {"Input": {"x": _rand(xs, 1)}, "Filter": {"w": _rand(ws, 2)}},
              {"Output": ["out"]}, attrs, cot_names=("out",))


def test_conv2d_transpose_groups_match_the_jax_op_group_by_group():
    """groups = 2 (an attr the JAX op does not read) against the JAX op run
    on each group's channels and filters: output and both grads."""
    x, w = _rand((2, 4, 5, 5), 3), _rand((4, 3, 3, 3), 4)
    attrs = dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1])
    cot = _rand((2, 6, 9, 9), 5)
    got, grads, _ = _run_op(T, "conv2d_transpose",
                            {"Input": {"x": x}, "Filter": {"w": w}},
                            {"Output": ["out"]}, dict(attrs, groups=2),
                            {"out": cot})
    parts = [_run_op(J, "conv2d_transpose",
                     {"Input": {"x": x[:, 2 * g:2 * g + 2]},
                      "Filter": {"w": w[2 * g:2 * g + 2]}},
                     {"Output": ["out"]}, attrs,
                     {"out": cot[:, 3 * g:3 * g + 3]}) for g in range(2)]
    want_out = np.concatenate([p[0]["out"] for p in parts], axis=1)
    want_dx = np.concatenate([p[1]["x"] for p in parts], axis=1)
    want_dw = np.concatenate([p[1]["w"] for p in parts], axis=0)
    np.testing.assert_allclose(got["out"], want_out, rtol=1e-5, atol=1e-5)
    for g, want in ((grads["x"], want_dx), (grads["w"], want_dw)):
        assert np.abs(g - want).max() <= 1e-4 * np.abs(want).max()


def test_conv2d_transpose_program_equals_jax():
    def build_prog(pkg):
        main, startup = pkg["pt"].Program(), pkg["pt"].Program()
        with pkg["pt"].program_guard(main, startup), pkg["un"].guard():
            x = pkg["L"].data(name="x", shape=[3, 8, 8], dtype="float32")
            y = pkg["L"].conv2d_transpose(x, 4, 3, stride=2, padding=1,
                                          act="relu")
            pkg["pt"].optimizer.SGD(0.1).minimize(pkg["L"].mean(y))
        return main, startup

    (jm, js), (tm, ts) = build_prog(J), build_prog(T)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


# -- the minimize-time passes ------------------------------------------------


def _bn_relu_program(pkg):
    """conv-bn-relu plus a shortcut conv-bn, added and relu'd."""
    main, startup = pkg["pt"].Program(), pkg["pt"].Program()
    L = pkg["L"]
    with pkg["pt"].program_guard(main, startup), pkg["un"].guard():
        img = L.data(name="img", shape=[8, 6, 6], dtype="float32")
        y = L.conv2d(img, num_filters=8, filter_size=3, padding=1,
                     bias_attr=False, name="c1")
        y = L.batch_norm(y, act="relu", name="bn1")
        s = L.conv2d(img, num_filters=8, filter_size=1, bias_attr=False,
                     name="sc")
        s = L.batch_norm(s, name="bnsc")
        out = L.relu(L.elementwise_add(y, s))
        loss = L.reduce_mean(out)
        pkg["pt"].optimizer.Momentum(learning_rate=0.1, momentum=0.9
                                     ).minimize(loss)
    return main, startup, loss


def test_epilogue_pass_fuses_chains():
    """fuse_epilogue on: bn->relu folds to an act attr, the bn->add->relu
    residual block folds the add and relu into the norm op (attr act +
    input Residual), no standalone relu survives, and the program is the
    JAX package's under pallas_epilogue=on."""
    _set_fuse(True)
    main, _, _ = _bn_relu_program(T)
    types = [op.type for op in main.global_block.ops]
    assert "relu" not in types and "elementwise_add" not in types
    fused = [op for op in main.global_block.ops
             if op.type in ("batch_norm", "conv2d_bn")]
    assert sorted(op.attr("act", "") for op in fused) == ["relu", "relu"]
    assert sum(1 for op in fused if op.input("Residual")) == 1
    assert main.to_dict() == _bn_relu_program(J)[0].to_dict()


def test_epilogue_pass_off_leaves_the_chain_and_trains_the_same():
    """fuse_epilogue off keeps relu and elementwise_add as ops; the fused
    and the unfused programs train alike from the same weights (the
    rewrite is a pure change of structure)."""
    x = _rand((4, 8, 6, 6), 30)
    losses, params = {}, None
    for fuse in (False, True):
        _set_fuse(fuse)
        main, startup, loss = _bn_relu_program(T)
        types = [op.type for op in main.global_block.ops]
        assert ("relu" in types and "elementwise_add" in types) != fuse
        scope, exe = tpt.Scope(), tpt.Executor(place="cpu")
        startup.random_seed = 3
        exe.run(startup, scope=scope)
        names = [p.name for p in main.all_parameters()]
        if params is None:
            params = {n: scope.find_var(n).numpy().copy() for n in names}
        else:
            load_params(scope, main, params)
        losses[fuse] = [float(exe.run(main, feed={"img": x}, scope=scope,
                                      fetch_list=[loss])[0])
                        for _ in range(3)]
    np.testing.assert_allclose(losses[False], losses[True], rtol=1e-6,
                               atol=1e-6)
    assert losses[True][2] != losses[True][0]


def test_epilogue_pass_respects_multi_reader():
    """A norm output with a second reader must not fuse (the var would
    vanish while still being read)."""
    _set_fuse(True)
    main = tpt.Program()
    L = T["L"]
    with tpt.program_guard(main, tpt.Program()), tun.guard():
        img = L.data(name="img", shape=[4, 6, 6], dtype="float32")
        y = L.batch_norm(img, name="bn")
        a = L.relu(y)
        loss = L.elementwise_add(L.reduce_mean(a), L.reduce_mean(y))
        tpt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    assert "relu" in [op.type for op in main.global_block.ops]


def test_stats_pass_flag_off_keeps_conv_and_batch_norm():
    tflags.set_flags({"bn_fuse_stats": False})
    jflags.set_flags({"bn_fuse_stats": False})
    _set_fuse(False)
    main, _, _ = _bn_relu_program(T)
    types = [op.type for op in main.global_block.ops]
    assert "conv2d_bn" not in types and types.count("batch_norm") == 2
    assert main.to_dict() == _bn_relu_program(J)[0].to_dict()


# -- the ResNet programs -----------------------------------------------------


LR = 0.002


def _build_resnet(pkg, which, size=64):
    main, startup = pkg["pt"].Program(), pkg["pt"].Program()
    L, rn = pkg["L"], pkg["rn"]
    with pkg["pt"].program_guard(main, startup), pkg["un"].guard():
        if which == "cifar":
            loss, acc, _ = rn.resnet_cifar10()
        else:
            img = L.data(name="img", shape=[size, size, 3], dtype="float32")
            label = L.data(name="label", shape=[1], dtype="int64")
            if which == "r50":
                loss, acc, _ = rn.resnet50(img, label, s2d_stem=True,
                                           data_format="NHWC")
            else:
                logits = rn.resnet(img, depth=18, num_classes=10,
                                   s2d_stem=True, data_format="NHWC")
                loss = L.mean(L.softmax_with_cross_entropy(logits, label))
                acc = L.accuracy(logits, label)
        pkg["pt"].optimizer.Momentum(LR, 0.9).minimize(loss)
    return main, startup, loss, acc


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("which", ["cifar", "r50"])
def test_resnet_training_programs_equal_jax(which, fuse):
    _set_fuse(fuse)
    jm, js, _, _ = _build_resnet(J, which)
    tm, ts, _, _ = _build_resnet(T, which)
    assert tm.to_dict()["blocks"][0]["ops"] == jm.to_dict()["blocks"][0]["ops"]
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    types = [op.type for op in tm.global_block.ops]
    n_bn = types.count("batch_norm") + types.count("conv2d_bn")
    assert n_bn == (53 if which == "r50" else 21)
    assert types.count("batch_norm_grad") + types.count("conv2d_bn_grad") == n_bn
    assert ("relu" in types) != fuse


def _two_steps(which, fuse, feed):
    """Both packages from the JAX startup's weights: per package the two
    losses, step-1 grads, the parameters before step 1, and the parameters
    and the other persistable state (running statistics, velocities) after
    each step; and `flips`, the count of relu outputs of
    step 1 that are zero in one package and positive in the other."""
    _set_fuse(fuse)
    jm, js, jl, ja = _build_resnet(J, which)
    tm, ts, tl, ta = _build_resnet(T, which)
    assert tm.to_dict() == jm.to_dict()
    js.random_seed = 7
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    names = [p.name for p in jm.all_parameters()]
    tscope, texe = tpt.Scope(), tpt.Executor(place="cpu")
    texe.run(ts, scope=tscope)
    load_params(tscope, tm, {n: np.array(jscope.find_var(n)) for n in names})
    state = [v.name for v in tm.global_block.vars.values()
             if v.persistable and v.name not in names]
    assert any(n.endswith(".mean") for n in state)
    assert any("velocity" in n for n in state)
    gnames = [n + "@GRAD" for n in names]
    relus = [op.outputs["Out"][0] if op.type == "relu" else op.outputs["Y"][0]
             for op in tm.global_block.ops
             if op.type == "relu" or (op.type in ("batch_norm", "conv2d_bn")
                                      and op.attr("act", "") == "relu")]
    assert len(relus) == (19 if which == "cifar" else 17)
    out = {}
    for key, exe, prog, loss, acc, scope in (("jax", jexe, jm, jl, ja, jscope),
                                             ("torch", texe, tm, tl, ta, tscope)):
        losses, after = [], []
        init = {n: np.array(scope.find_var(n)) for n in names}
        for step in range(2):
            vals = exe.run(prog, feed=feed, scope=scope,
                           fetch_list=[loss.name, acc.name]
                           + (gnames + relus if step == 0 else []))
            losses.append(float(np.asarray(vals[0])))
            if step == 0:
                grads = {n: np.asarray(v) for n, v in zip(names, vals[2:])}
                masks = [np.asarray(v) > 0 for v in vals[2 + len(names):]]
            after.append({n: np.array(scope.find_var(n)) for n in names + state})
        out[key] = dict(losses=losses, grads=grads, masks=masks, init=init,
                        acc=float(np.asarray(vals[1])[0]), after=after)
    out["flips"] = sum(int((a != b).sum()) for a, b in
                       zip(out["jax"].pop("masks"), out["torch"].pop("masks")))
    return out


def _feed(shape, classes, seed):
    rng = np.random.default_rng(seed)
    return {"img": rng.standard_normal((4,) + shape).astype(np.float32),
            "label": rng.integers(0, classes, (4, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def cifar():
    jflags.set_flags({"conv_implicit_gemm": "off"})
    return _two_steps("cifar", True, _feed((3, 32, 32), 10, 42))


@pytest.fixture(scope="module")
def r18():
    jflags.set_flags({"conv_implicit_gemm": "off"})
    return _two_steps("r18", False, _feed((64, 64, 3), 10, 42))


NETS = ["cifar", "r18"]


def _rel_max(got, want, scale=None):
    scale = float(np.abs(want).max()) if scale is None else scale
    return float(np.abs(got - want).max()) / max(scale, 1e-12)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)),
                                                   1e-12)


def _step1_error(r, got, want):
    """An array that step 1's backward pass made: its error, and the limit
    it is held to. 1e-4 of its max-abs; but where the two packages' relu
    masks differ in step 1 (a pre-activation within rounding of zero: that
    element's gradient is then on in one package and off in the other, and
    every gradient upstream moves by about a hundredth), 0.1 in relative
    L2 norm."""
    if r["flips"]:
        return _rel_l2(got, want), 0.1
    return _rel_max(got, want), 1e-4


@pytest.mark.parametrize("net", NETS)
def test_resnet_losses_agree_over_two_momentum_steps(net, request):
    r = request.getfixturevalue(net)
    np.testing.assert_allclose(r["torch"]["losses"], r["jax"]["losses"],
                               rtol=1e-4)
    # the step moved the loss by far more than the tolerance
    assert abs(r["torch"]["losses"][1] - r["torch"]["losses"][0]) > 1e-2
    assert r["torch"]["acc"] == r["jax"]["acc"]


@pytest.mark.parametrize("net", NETS)
def test_resnet_step1_gradients_agree(net, request):
    r = request.getfixturevalue(net)
    jg, tg = r["jax"]["grads"], r["torch"]["grads"]
    assert sorted(tg) == sorted(jg) and len(jg) == (65 if net == "cifar" else 62)
    for n in jg:
        err, limit = _step1_error(r, tg[n], jg[n])
        assert err <= limit, (n, err, r["flips"])


@pytest.mark.parametrize("net", NETS)
def test_resnet_params_and_velocities_agree_after_each_step(net, request):
    """After step 1 the velocity is the gradient and the parameter moved by
    lr times it: both are held as step 1's gradients are. Step 2's relu
    masks are not compared, so after it each parameter's total update and
    each velocity are held to 0.1 in relative L2 norm."""
    r = request.getfixturevalue(net)
    j, t = r["jax"], r["torch"]
    for n, p0 in j["init"].items():
        vel = next(s for s in j["after"][0] if s.startswith(n + "_velocity"))
        err, limit = _step1_error(r, t["after"][0][vel], j["after"][0][vel])
        assert err <= limit, (vel, err, r["flips"])
        # the parameter's own fp32 spacing bounds how finely its update
        # can be read back
        got, want = t["after"][0][n] - p0, j["after"][0][n] - p0
        err, limit = _step1_error(r, got, want)
        assert (err <= limit or np.abs(got - want).max()
                <= 2.4e-7 * np.abs(p0).max()), (n, err, r["flips"])
        for name, base in ((n, p0), (vel, 0.0)):
            assert _rel_l2(t["after"][1][name] - base,
                           j["after"][1][name] - base) <= 0.1, name
        assert not np.array_equal(j["after"][1][n], j["after"][0][n])


@pytest.mark.parametrize("net", NETS)
def test_resnet_running_statistics_agree_after_each_step(net, request):
    r = request.getfixturevalue(net)
    stats = [n for n in r["jax"]["after"][0]
             if n.endswith(".mean") or n.endswith(".var")]
    assert len(stats) == 2 * (21 if net == "cifar" else 20)
    for step in range(2):
        for n in stats:
            got = r["torch"]["after"][step][n]
            np.testing.assert_allclose(got, r["jax"]["after"][step][n],
                                       rtol=1e-4, atol=1e-5, err_msg=n)
            # the op moved them off their initial 0 / 1
            assert not np.allclose(got, 0.0 if n.endswith(".mean") else 1.0)


def test_fold_stem_to_s2d_equals_jax():
    w7 = _rand((64, 3, 7, 7), 50)
    for fmt in ("NCHW", "NHWC"):
        np.testing.assert_array_equal(trn.fold_stem_to_s2d(w7, fmt),
                                      jrn.fold_stem_to_s2d(w7, fmt))
    assert trn.fold_stem_to_s2d(w7, "NHWC").shape == (4, 4, 12, 64)


def test_resnet_functions_cover_the_jax_depths():
    assert trn._DEPTH_CFG == jrn._DEPTH_CFG
    assert trn.__all__ == jrn.__all__
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()), tun.guard():
        loss, acc, logits = trn.resnet18()
    assert logits.shape == (-1, 1000) and loss.shape == ()
