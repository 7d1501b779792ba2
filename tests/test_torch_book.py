"""The Fluid book's recognize_digits models and the composite nets of the
port (models/mlp.py, nets.py) held against the JAX package's on the CPU.

* mnist_mlp and mnist_conv (BASELINE.json's first configuration) under
  Adam: the main and startup programs equal through to_dict(), then 2
  steps from the JAX startup's weights whose losses and accuracies agree
  (losses rtol 1e-5; fp32 sums in another order) and whose parameters
  agree within 2 lr a step (Adam moves a weight by about lr whatever its
  gradient's size).
* simple_img_conv_pool, img_conv_group (with batch norm), glu and
  scaled_dot_product_attention (one and two heads): programs equal, one
  forward within 1e-5.
* word2vec (the book's 4-gram model, its shared table) and dense DeepFM
  (bench.py's CPU widths) over 3 SGD steps; the sparse DeepFM raises.
* cross_entropy (hard, soft, ignore_index), cross_entropy2 (MatchX) and
  sigmoid_cross_entropy_with_logits (ignore_index, normalize): outputs and
  grads against the JAX ops' jax.vjp.
"""
import numpy as np
import pytest

from torch_parity import J, T, build, close, op_outputs_and_grads, run_both

LR = 1e-3


def _mnist(which):
    def fn(pkg):
        from importlib import import_module

        mlp = import_module(pkg["pt"].__name__ + ".models.mlp")
        loss, acc, _ = getattr(mlp, which)()
        pkg["pt"].optimizer.Adam(LR).minimize(loss)
        return [loss, acc]
    return fn


@pytest.mark.parametrize("which", ["mnist_mlp", "mnist_conv"])
def test_mnist_matches_jax_over_two_adam_steps(which):
    jm, js, jf = build(J, _mnist(which))
    tm, ts, tf = build(T, _mnist(which))
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    rng = np.random.default_rng(0)
    shape = (16, 784) if which == "mnist_mlp" else (16, 1, 28, 28)
    feeds = [{"img": rng.random(shape).astype(np.float32),
              "label": rng.integers(0, 10, (16, 1)).astype(np.int64)}
             for _ in range(2)]
    jout, tout, jscope, tscope = run_both((jm, js), (tm, ts), feeds, jf, tf)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(float(t[0]), float(j[0]), rtol=1e-5)
        assert float(t[1]) == float(j[1])
    for p in jm.all_parameters():
        np.testing.assert_allclose(tscope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=1e-4, atol=2 * 2 * LR, err_msg=p.name)


NETS = {
    "simple_img_conv_pool": (
        lambda L, nets, x: nets.simple_img_conv_pool(
            x, num_filters=4, filter_size=3, pool_size=2, pool_stride=2,
            act="relu"), (2, 3, 8, 8)),
    "img_conv_group": (
        lambda L, nets, x: nets.img_conv_group(
            x, conv_num_filter=[4, 4], pool_size=2, conv_act="relu",
            conv_with_batchnorm=[True, False], pool_stride=2), (2, 3, 8, 8)),
    "glu": (lambda L, nets, x: nets.glu(x, dim=-1), (2, 3, 8)),
    "sdpa_1head": (lambda L, nets, x: nets.scaled_dot_product_attention(
        x, x, x), (2, 5, 8)),
    "sdpa_2heads": (lambda L, nets, x: nets.scaled_dot_product_attention(
        L.fc(x, size=8, num_flatten_dims=2), x, x, num_heads=2), (2, 5, 8)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_nets_match_jax(name):
    build_net, shape = NETS[name]

    def fn(pkg):
        from importlib import import_module

        nets = import_module(pkg["pt"].__name__ + ".nets")
        x = pkg["L"].data(name="x", shape=list(shape[1:]), dtype="float32")
        return [build_net(pkg["L"], nets, x)]

    jm, js, jf = build(J, fn)
    tm, ts, tf = build(T, fn)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    (jo,), (to,), _, _ = run_both((jm, js), (tm, ts), [{"x": x}], jf, tf)
    close(to, jo)


# -- word2vec, dense DeepFM and their losses ---------------------------------


def _w2v(pkg):
    from importlib import import_module

    w2v = import_module(pkg["pt"].__name__ + ".models.word2vec")
    loss, _, _ = w2v.word2vec()
    pkg["pt"].optimizer.SGD(0.1).minimize(loss)
    return [loss] + [p.name for p in
                     pkg["pt"].default_main_program().all_parameters()]


def _dfm(is_sparse=False):
    def fn(pkg):
        from importlib import import_module

        dfm = import_module(pkg["pt"].__name__ + ".models.deepfm")
        loss, _, _ = dfm.deepfm(vocab_size=1000, is_sparse=is_sparse)
        pkg["pt"].optimizer.SGD(1e-3).minimize(loss)
        return [loss] + [p.name for p in
                         pkg["pt"].default_main_program().all_parameters()]
    return fn


def _w2v_feeds(B=32):
    rng = np.random.default_rng(0)
    return [{**{f"w{i}": rng.integers(0, 2000, (B, 1)).astype(np.int64)
                for i in range(4)},
             "next_word": rng.integers(0, 2000, (B, 1)).astype(np.int64)}
            for _ in range(3)]


def _dfm_feeds(B=256):
    """bench.py's CPU arm of bench_deepfm: vocab 1000, B=256."""
    rng = np.random.default_rng(0)
    return [{"sparse_ids": rng.integers(0, 1000, (B, 26)).astype(np.int64),
             "dense_x": rng.random((B, 13)).astype(np.float32),
             "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}
            for _ in range(3)]


@pytest.mark.parametrize("model", ["word2vec", "deepfm"])
def test_book_model_matches_jax_over_three_sgd_steps(model):
    """word2vec at its defaults (SGD 0.1, B=32) and dense DeepFM at
    bench.py's CPU widths (vocab 1000, B=256, SGD 1e-3): programs equal
    through to_dict(), three steps from the JAX startup's weights whose
    losses agree within 1e-5 and whose parameters (fetched after each step)
    agree within 1e-5 of their max-abs."""
    fn, feeds = ((_w2v, _w2v_feeds()) if model == "word2vec"
                 else (_dfm(), _dfm_feeds()))
    jm, js, jf = build(J, fn)
    tm, ts, tf = build(T, fn)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    jout, tout, _, _ = run_both((jm, js), (tm, ts), feeds, jf, tf)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(float(t[0]), float(j[0]), rtol=1e-5)
        for a, b, n in zip(t[1:], j[1:], jf[1:]):
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), n
    assert float(tout[-1][0]) != float(tout[0][0])


def test_sparse_deepfm_names_what_is_missing():
    """With is_sparse=True (the model's default) the embedding grads raise,
    naming the roadmap item that ports SelectedRows gradients."""
    import paddle_tpu_torch as tpt

    main, startup, out = build(T, _dfm(is_sparse=True))
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(Exception, match="data pipeline and embeddings"):
        exe.run(main, feed=_dfm_feeds(8)[0], fetch_list=[out[0]], scope=scope)


def _ce_inputs(rng, soft, ignore):
    x = rng.random((6, 5)).astype(np.float32) + 0.05
    x /= x.sum(-1, keepdims=True)
    if soft:
        lbl = rng.random((6, 5)).astype(np.float32)
        lbl /= lbl.sum(-1, keepdims=True)
    else:
        lbl = rng.integers(0, 5, (6, 1)).astype(np.int64)
        if ignore >= 0:
            lbl[::3] = ignore
    return x, lbl


LOSSES = {
    "cross_entropy_hard": ("cross_entropy", False, -100, ("Y",)),
    "cross_entropy_soft": ("cross_entropy", True, -100, ("Y",)),
    "cross_entropy_ignore": ("cross_entropy", False, 2, ("Y",)),
    "cross_entropy2": ("cross_entropy2", False, -100, ("Y", "MatchX")),
    "cross_entropy2_ignore": ("cross_entropy2", False, 3, ("Y", "MatchX")),
    "sigmoid_xent": ("sigmoid_cross_entropy_with_logits", False, -100,
                     ("Out",)),
    "sigmoid_xent_ignore_normalize": ("sigmoid_cross_entropy_with_logits",
                                      True, -1, ("Out",)),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_op_and_its_grad_match_jax(case):
    """Each loss op's outputs and its input grads (by replay in the port,
    jax.vjp in the JAX package) on the same inputs and cotangents: 1e-5."""
    op_type, flag, ignore, out_slots = LOSSES[case]
    rng = np.random.default_rng(7)
    if op_type == "sigmoid_cross_entropy_with_logits":
        x = rng.standard_normal((6, 4)).astype(np.float32) * 3
        lbl = rng.integers(0, 2, (6, 4)).astype(np.float32)
        lbl[0, :2] = ignore
        attrs = {"ignore_index": ignore, "normalize": flag}
    else:
        x, lbl = _ce_inputs(rng, flag, ignore)
        attrs = {"ignore_index": ignore}
        if op_type == "cross_entropy":
            attrs["soft_label"] = flag
    outs = {s: [s.lower()] for s in out_slots}
    if op_type == "cross_entropy2":
        outs["XShape"] = ["xshape"]
    ins = {"X": {"x": x}, "Label": {"lbl": lbl}}
    ref, _, _ = op_outputs_and_grads(J, op_type, ins, outs, attrs, {})
    cots = {n: rng.standard_normal(ref[n].shape).astype(np.float32)
            for n in (s.lower() for s in out_slots)}
    jo, jg, jp = op_outputs_and_grads(J, op_type, ins, outs, attrs, cots)
    to, tg, tp = op_outputs_and_grads(T, op_type, ins, outs, attrs, cots)
    assert tp.to_dict() == jp.to_dict()
    for n in jo:
        assert to[n].shape == jo[n].shape, n
        np.testing.assert_allclose(to[n], jo[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    assert sorted(tg) == sorted(jg) and "x" in tg
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-5,
                                   atol=1e-6 * max(np.abs(jg[n]).max(), 1.0),
                                   err_msg=n)
