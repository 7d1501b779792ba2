"""chip_smoke.py's two new models built through both packages and held
against the JAX package on the CPU, at tiny sizes: the book's semantic
role labeller (db_lstm at depth 2, hidden 32, on conll05's synthetic
reader and its embedding table) and CRNN-CTC (a 16 x 64 input, two conv
groups, GRUs of 16), plain and under QuantizationTransformPass.

* The programs (main, startup, the decode or eval clone) equal the JAX
  package's by to_dict().
* Five training steps from the JAX startup's weights (carried with
  weights.load_params) agree within 1e-5: the losses, then every parameter
  and running statistic.
* The decode clones' outputs (crf_decoding's paths, the greedy CTC decode)
  are equal and their evaluators' results agree.

The JAX warpctc's gradient is NaN at the early frames of labels of 3 or
more ids (tests/test_torch_crf_ctc.py shows it): for the CRNN trajectory
its log-sum-exp is replaced, in this test only, by one whose dropped
where() branch stays finite, the port's form (same forward values).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from torch_parity import close
from paddle_tpu_torch.weights import load_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

TINY_CRNN = dict(shape=(1, 16, 64), channels=(16, 32), hidden=16)


@pytest.fixture
def flags():
    """The epilogue pass on in both packages (the port's default: batch
    norm -> relu folds into the norm op) and the JAX baseline convolution
    arm, restored after."""
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags

    saved_j = {k: jflags.get_flag(k) for k in
               ("conv_implicit_gemm", "pallas_epilogue")}
    saved_t = tflags.get_flag("fuse_epilogue")
    jflags.set_flags({"conv_implicit_gemm": "off", "pallas_epilogue": "on"})
    tflags.set_flags({"fuse_epilogue": True})
    yield
    jflags.set_flags(saved_j)
    tflags.set_flags({"fuse_epilogue": saved_t})


@pytest.fixture
def finite_jax_ctc(monkeypatch):
    import jax.numpy as jnp
    from paddle_tpu.ops import ctc_ops

    neg = ctc_ops._NEG

    def logsumexp2(a, b):
        m = jnp.maximum(a, b)
        dead = m <= neg
        m_safe = jnp.where(dead, 0.0, m)
        s = jnp.where(dead, 1.0, jnp.exp(a - m_safe) + jnp.exp(b - m_safe))
        return jnp.where(dead, neg, m_safe + jnp.log(s))

    monkeypatch.setattr(ctc_ops, "_logsumexp2", logsumexp2)


def _same_programs(jp, tp):
    for j, t in zip(jp, tp):
        assert t.to_dict() == j.to_dict()


def _start(jm, js, tm, ts, arrays=None):
    """Both scopes from the JAX startup, the port's parameters loaded from
    the JAX arrays; `arrays` overrides some in both first."""
    jexe, jscope = jpt.Executor(), jpt.Scope()
    jexe.run(js, scope=jscope)
    for n, a in (arrays or {}).items():
        jscope.set_var(n, a)
    texe, tscope = tpt.Executor(place="cpu"), tpt.Scope()
    texe.run(ts, scope=tscope)
    load_params(tscope, tm, {p.name: np.asarray(jscope.find_var(p.name))
                             for p in jm.all_parameters()})
    return jexe, jscope, texe, tscope


def _train(jm, tm, loss, feeds, jexe, jscope, texe, tscope):
    for feed in feeds:
        (jl,) = jexe.run(jm, feed=feed, fetch_list=[loss], scope=jscope)
        (tl,) = texe.run(tm, feed=feed, fetch_list=[loss], scope=tscope)
        close([tl], [np.asarray(jl)], what="loss")
    for v in tm.list_vars():
        if v.persistable and tscope.find_var(v.name) is not None:
            close([tscope.find_var(v.name).numpy()],
                  [np.asarray(jscope.find_var(v.name))], what=v.name)


def test_srl_matches_jax():
    jp = chip_smoke._srl_program(jpt, depth=2, hidden=32)
    tp = chip_smoke._srl_program(tpt, depth=2, hidden=32)
    _same_programs(jp[:3], tp[:3])
    types = [o.type for o in tp[0].global_block.ops]
    for t in ("linear_chain_crf", "linear_chain_crf_grad", "lstm", "sum", "sgd"):
        assert t in types, t
    assert sum(t == "lookup_table" for t in types) == 8
    assert {o.type for o in tp[2].global_block.ops} >= {"crf_decoding",
                                                        "chunk_eval"}
    batches = chip_smoke._srl_batches(tpt, 7, B=4)
    assert len({b["word"].shape[1] for b in batches}) > 1
    emb = {"emb": tpt.dataset.conll05.get_embedding()}
    jexe, jscope, texe, tscope = _start(*jp[:2], *tp[:2], emb)
    np.testing.assert_array_equal(tscope.find_var("emb").numpy(), emb["emb"])
    _train(jp[0], tp[0], tp[3].name, batches[:5], jexe, jscope, texe, tscope)
    jev, tev = jp[5], tp[5]
    tev.reset(texe, scope=tscope)
    with jpt.scope_guard(jscope):
        jev.reset(jexe)
        for b in batches[5:]:
            (jd,) = jexe.run(jp[2], feed=b, fetch_list=[jp[4]] + jev.metrics)[:1]
            (td,) = texe.run(tp[2], feed=b, fetch_list=[tp[4]] + tev.metrics,
                             scope=tscope)[:1]
            np.testing.assert_array_equal(td, np.asarray(jd))
        jres = jev.eval(jexe)
    tres = tev.eval(texe, scope=tscope)
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t, j)


def test_crnn_ctc_matches_jax(flags, finite_jax_ctc):
    jp = chip_smoke._crnn_ctc_program(jpt, **TINY_CRNN)
    tp = chip_smoke._crnn_ctc_program(tpt, **TINY_CRNN)
    _same_programs(jp[:3], tp[:3])
    types = [o.type for o in tp[0].global_block.ops]
    for t in ("warpctc", "warpctc_grad", "gru", "gru_grad", "ctc_align",
              "edit_distance", "momentum"):
        assert t in types, t
    assert sum(t in ("batch_norm", "conv2d_bn") for t in types) == 4
    rng = np.random.default_rng(0)
    feeds = [chip_smoke._crnn_feed(rng, 3, shape=TINY_CRNN["shape"])
             for _ in range(7)]
    jexe, jscope, texe, tscope = _start(*jp[:2], *tp[:2])
    _train(jp[0], tp[0], tp[3].name, feeds[:5], jexe, jscope, texe, tscope)
    jev, tev = jp[5], tp[5]
    tev.reset(texe, scope=tscope)
    decoded = [o.outputs["Output"][0] for o in tp[2].global_block.ops
               if o.type == "ctc_align"]
    with jpt.scope_guard(jscope):
        jev.reset(jexe)
        for f in feeds[5:]:
            jd, jl = jexe.run(jp[2], feed=f, fetch_list=decoded + [jp[4].name])
            td, tl = texe.run(tp[2], feed=f, fetch_list=decoded + [tp[4].name],
                              scope=tscope)
            np.testing.assert_array_equal(td, np.asarray(jd))
            close([tl], [np.asarray(jl)], what="eval logits")
        jres = jev.eval(jexe)
    close(tev.eval(texe, scope=tscope), jres, what="edit distance")


@pytest.mark.parametrize("pkg", [jpt, tpt], ids=["jax", "torch"])
def test_crnn_sequence_is_im2sequence(pkg):
    """The CRNN program's transpose + reshape gives im2sequence's [H, 1] window
    (which has no grad in either package) value for value."""
    from torch_parity import J, T, build

    def net(p):
        L = p["L"]
        x = L.data(name="x", shape=[3, 4, 5], dtype="float32")
        return [L.im2sequence(x, filter_size=[4, 1], stride=[1, 1]),
                L.reshape(L.transpose(x, perm=[0, 3, 1, 2]), [-1, 5, 12])]

    p = J if pkg is jpt else T
    main, startup, outs = build(p, net)
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 5)).astype(np.float32)
    got = p["exe"]().run(main, feed={"x": x}, fetch_list=[o.name for o in outs],
                         scope=p["scope"]())
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(got[1]))


def test_crnn_qat_program_matches_jax(flags):
    jp = chip_smoke._crnn_ctc_program(jpt, qat=True, **TINY_CRNN)
    tp = chip_smoke._crnn_ctc_program(tpt, qat=True, **TINY_CRNN)
    _same_programs(jp[:3], tp[:3])
    types = [o.type for o in tp[0].global_block.ops]
    # a weight quantizer for each conv and fc product, an input quantizer
    # for each conv and each fc input (the two fcs of the sequence share one)
    assert types.count("fake_quantize_dequantize_abs_max") == 4 + 4
    assert types.count("fake_quantize_dequantize_moving_average_abs_max") == 4 + 3
