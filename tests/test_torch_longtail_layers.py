"""The long-tail layers of the port held against the JAX package on the
CPU: each of the 90 names builds the JAX package's program (to_dict(),
op for op, var for var, dtype for dtype) and, from the JAX startup's
weights, the same values within 1e-5 (the random layers: the same
program and the output's shape and dtype). Then the port's versions of
the JAX package's tests of these layers (tests/test_layers_longtail.py,
test_losses_and_quant.py's hsigmoid, nce and distributions, and
test_ops_longtail.py's print tests) with their own numpy oracles, and the
scope: the JAX layers the port lacks are exactly the crf, ctc and
ring-attention ones (the vision and detection layers are ported)."""
import numpy as np
import pytest

from torch_parity import J, T, build, close, run_both

B = 3


def _r(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


FEED = {
    "x": _r((B, 4), 1), "y": _r((B, 4), 2), "a": _r((B, 1), 3),
    "b": _r((B, 1), 4), "prob": np.random.default_rng(5).uniform(
        0.05, 0.95, (B, 1)).astype(np.float32),
    "sign": np.array([[1.0], [-1.0], [1.0]], np.float32),
    "pos": np.random.default_rng(6).uniform(0, 3, (B, 4)).astype(np.float32),
    "cvm": np.random.default_rng(7).uniform(0, 3, (B, 2)).astype(np.float32),
    "img": _r((B, 3, 4, 4), 8), "img2": _r((B, 2, 4, 4), 9),
    "seq": _r((B, 5, 4), 10), "h": _r((B, 4), 11), "c": _r((B, 4), 12),
    "ids": np.array([[1], [4], [0]], np.int64),
    "ia": np.array([[7, -7], [5, 9], [-3, 2]], np.int32),
    "ib": np.array([[2, 3], [-4, 2], [5, 7]], np.int32),
    "bits": np.array([[1, 0, 1, 1], [0, 0, 1, 0], [1, 1, 1, 0]], np.int64),
    "bits2": np.array([[1, 1, 1, 0], [0, 0, 1, 0], [0, 1, 1, 0]], np.int64),
    "nd": np.array([[0, 1], [2, 3], [0, 1]], np.int64),
    "upd": _r((B,), 13), "tags": np.array([[1, -1], [3, 2], [2, 2]], np.int64),
    "tlabel": np.array([[-2.0], [0.4], [1.3]], np.float32),
    "nodes": _r((B, 5, 4), 14),
    "edges": np.array([[[1, 2], [1, 3], [2, 4], [2, 5]]] * B, np.int64),
}
STATIC = {"w": _r((4, 2), 15), "wmat": _r((4, 3, 2), 16),
          "lab": np.array([1, 2, 1], np.int64),
          "ftag": np.array([2], np.int64), "sc": np.array([3, 1], np.int64),
          "flat": np.array([5, 3, 5, 9, 3], np.int64)}


def _vars(L):
    """Every input above as a data var (batch -1), STATIC's as fixed."""
    v = {}
    for n, a in FEED.items():
        v[n] = L.data(name=n, shape=list(a.shape[1:]), dtype=str(a.dtype))
    for n, a in STATIC.items():
        v[n] = L.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                      append_batch_size=False)
    return type("V", (), v)


def _py(pkg, v):
    L = pkg["L"]
    out = pkg["pt"].default_main_program().current_block().create_var(
        name="py_out", shape=[-1, 4], dtype="float32")
    return L.py_func(lambda a: np.tanh(a), v.x, out)


def _dist(pkg, v):
    L = pkg["L"]
    D = L.distributions
    n1 = D.Normal(v.a, v.prob)
    n2 = D.Normal(v.b, L.scale(v.prob, scale=2.0))
    return L.elementwise_add(n1.kl_divergence(n2), n2.log_prob(v.a))


# layer -> (build(pkg, vars) -> var, values compared (False: program,
# shape and dtype only: a random layer))
LAYERS = {
    "Print": (lambda p, v: p["L"].Print(v.x, message="lt"), True),
    "abs": (lambda p, v: p["L"].abs(v.x), True),
    "add_position_encoding": (lambda p, v: p["L"].add_position_encoding(
        v.seq, alpha=0.5, beta=2.0), True),
    "argmin": (lambda p, v: p["L"].argmin(v.x, axis=1), True),
    "argsort": (lambda p, v: p["L"].argsort(v.x)[1], True),
    "autoincreased_step_counter": (
        lambda p, v: p["L"].autoincreased_step_counter(begin=3), True),
    "bpr_loss": (lambda p, v: p["L"].bpr_loss(v.x, p["L"].elementwise_mod(
        v.ids, p["L"].fill_constant([1], "int64", 4))), True),
    "brelu": (lambda p, v: p["L"].brelu(v.x, t_min=-0.5, t_max=0.5), True),
    "center_loss": (lambda p, v: p["L"].center_loss(v.x, v.ids, 5, 0.2), True),
    "clip": (lambda p, v: p["L"].clip(v.x, -0.5, 0.5), True),
    "clip_by_norm": (lambda p, v: p["L"].clip_by_norm(v.x, 1.0), True),
    "continuous_value_model": (
        lambda p, v: p["L"].continuous_value_model(v.pos, v.cvm), True),
    "cos_sim": (lambda p, v: p["L"].cos_sim(v.x, v.y), True),
    "create_tensor": (lambda p, v: p["L"].create_tensor("float32"), None),
    "cumsum": (lambda p, v: p["L"].cumsum(v.x, axis=1, exclusive=True), True),
    "data_norm": (lambda p, v: p["L"].data_norm(v.x), True),
    "dice_loss": (lambda p, v: p["L"].dice_loss(p["L"].sigmoid(v.x), v.bits),
                  True),
    "distributions": (_dist, True),
    "dot": (lambda p, v: p["L"].dot(v.x, v.y), True),
    "elementwise_floordiv": (
        lambda p, v: p["L"].elementwise_floordiv(v.ia, v.ib), True),
    "elementwise_mod": (lambda p, v: p["L"].elementwise_mod(v.ia, v.ib), True),
    "elu": (lambda p, v: p["L"].elu(v.x, alpha=0.5), True),
    "expand": (lambda p, v: p["L"].expand(v.x, [1, 2]), True),
    "fill_constant_batch_size_like": (
        lambda p, v: p["L"].fill_constant_batch_size_like(
            v.x, [-1, 2], "float32", 1.5), True),
    "filter_by_instag": (
        lambda p, v: p["L"].filter_by_instag(v.x, v.tags, v.ftag)[0], True),
    "flatten": (lambda p, v: p["L"].flatten(v.img, axis=2), True),
    "fsp_matrix": (lambda p, v: p["L"].fsp_matrix(v.img, v.img2), True),
    "gather_nd": (lambda p, v: p["L"].gather_nd(v.x, v.nd), True),
    "gaussian_random": (lambda p, v: p["L"].gaussian_random([4, 3], std=0.5),
                        False),
    "gaussian_random_batch_size_like": (
        lambda p, v: p["L"].gaussian_random_batch_size_like(v.x, [-1, 6]),
        False),
    "gelu": (lambda p, v: p["L"].gelu(v.x), True),
    "group_norm": (lambda p, v: p["L"].group_norm(v.img, groups=3), True),
    "hard_sigmoid": (lambda p, v: p["L"].hard_sigmoid(v.x), True),
    "hard_swish": (lambda p, v: p["L"].hard_swish(v.x), True),
    "hash": (lambda p, v: p["L"].hash(v.ids, 1000, num_hash=2), True),
    "hsigmoid": (lambda p, v: p["L"].hsigmoid(v.x, v.ids, num_classes=5), True),
    "huber_loss": (lambda p, v: p["L"].huber_loss(v.x, v.y, 0.5), True),
    "kldiv_loss": (lambda p, v: p["L"].kldiv_loss(
        p["L"].log_softmax(v.x), p["L"].softmax(v.y), "batchmean"), True),
    "l2_normalize": (lambda p, v: p["L"].l2_normalize(v.x, axis=1), True),
    "leaky_relu": (lambda p, v: p["L"].leaky_relu(v.x, 0.1), True),
    "linspace": (lambda p, v: p["L"].linspace(-1, 1, 5), True),
    "lod_reset": (lambda p, v: p["L"].scale(p["L"].lod_reset(v.x)), True),
    "log_loss": (lambda p, v: p["L"].log_loss(p["L"].sigmoid(v.a), v.prob),
                 True),
    "log_softmax": (lambda p, v: p["L"].log_softmax(v.x), True),
    "lstm_unit": (lambda p, v: p["L"].lstm_unit(v.x, v.h, v.c)[0], True),
    "margin_rank_loss": (
        lambda p, v: p["L"].margin_rank_loss(v.sign, v.a, v.b), True),
    "mean_iou": (lambda p, v: p["L"].mean_iou(v.bits, v.bits2, 3)[0], True),
    "mul": (lambda p, v: p["L"].mul(v.x, v.w), True),
    "nce": (lambda p, v: p["L"].nce(v.x, v.ids, 7, num_neg_samples=3), False),
    "npair_loss": (lambda p, v: p["L"].npair_loss(
        p["L"].slice(v.x, [0], [0], [3]), p["L"].slice(v.y, [0], [0], [3]),
        v.lab), True),
    "ones": (lambda p, v: p["L"].ones([2, 3]), True),
    "ones_like": (lambda p, v: p["L"].ones_like(v.x), True),
    "pad": (lambda p, v: p["L"].pad(v.x, [0, 1, 1, 0], 0.5), True),
    "pad2d": (lambda p, v: p["L"].pad2d(v.img, [1, 0, 0, 1], mode="edge"),
              True),
    "prelu": (lambda p, v: p["L"].prelu(v.img, mode="channel"), True),
    "py_func": (_py, True),
    "range": (lambda p, v: p["L"].range(0, 6, 2, "int32"), True),
    "rank": (lambda p, v: p["L"].rank(v.img), True),
    "rank_loss": (lambda p, v: p["L"].rank_loss(v.prob, v.a, v.b), True),
    "reduce_all": (lambda p, v: p["L"].reduce_all(
        p["L"].greater_than(v.x, v.y), dim=1), True),
    "reduce_any": (lambda p, v: p["L"].reduce_any(
        p["L"].greater_than(v.x, v.y)), True),
    "reduce_max": (lambda p, v: p["L"].reduce_max(v.x, dim=1), True),
    "reduce_min": (lambda p, v: p["L"].reduce_min(v.x, dim=0, keep_dim=True),
                   True),
    "reduce_prod": (lambda p, v: p["L"].reduce_prod(v.pos, dim=[0, 1]), True),
    "relu6": (lambda p, v: p["L"].relu6(v.x, threshold=0.7), True),
    "sampled_softmax_with_cross_entropy": (
        lambda p, v: p["L"].sampled_softmax_with_cross_entropy(
            v.x, p["L"].elementwise_mod(
                v.ids, p["L"].fill_constant([1], "int64", 4)), 2), False),
    "scatter_nd": (lambda p, v: p["L"].scatter_nd(
        p["L"].reshape(v.sc, [2, 1]), p["L"].slice(v.w, [0], [0], [2]),
        [5, 2]), True),
    "scatter_nd_add": (lambda p, v: p["L"].scatter_nd_add(
        v.w, p["L"].reshape(v.sc, [2, 1]), p["L"].slice(v.w, [0], [2], [4])),
        True),
    "selu": (lambda p, v: p["L"].selu(v.x), True),
    "shape": (lambda p, v: p["L"].shape(v.img), True),
    "sign": (lambda p, v: p["L"].sign(v.x), True),
    "size": (lambda p, v: p["L"].size(v.img), True),
    "smooth_l1": (lambda p, v: p["L"].smooth_l1(v.x, v.y, sigma=2.0), True),
    "soft_relu": (lambda p, v: p["L"].soft_relu(v.x, threshold=1.0), True),
    "spectral_norm": (lambda p, v: p["L"].spectral_norm(v.wmat, dim=1), True),
    "square": (lambda p, v: p["L"].square(v.x), True),
    "stack": (lambda p, v: p["L"].stack([v.x, v.y], axis=1), True),
    "stanh": (lambda p, v: p["L"].stanh(v.x), True),
    "sum": (lambda p, v: p["L"].sum([v.x, v.y, v.h]), True),
    "sums": (lambda p, v: p["L"].sums([v.x, v.y]), True),
    "swish": (lambda p, v: p["L"].swish(v.x, beta=2.0), True),
    "teacher_student_sigmoid_loss": (
        lambda p, v: p["L"].teacher_student_sigmoid_loss(v.a, v.tlabel), True),
    "tree_conv": (lambda p, v: p["L"].tree_conv(v.nodes, v.edges, 3, 2), True),
    "uniform_random": (lambda p, v: p["L"].uniform_random([2, 5]), False),
    "uniform_random_batch_size_like": (
        lambda p, v: p["L"].uniform_random_batch_size_like(v.x, [-1, 3]),
        False),
    "unique": (lambda p, v: p["L"].unique(v.flat)[1], True),
    "unique_with_counts": (lambda p, v: p["L"].unique_with_counts(v.flat)[2],
                           True),
    "unstack": (lambda p, v: p["L"].unstack(v.x, axis=1)[2], True),
    "zeros": (lambda p, v: p["L"].zeros([2, 2], "int32"), True),
    "zeros_like": (lambda p, v: p["L"].zeros_like(v.x), True),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_jax_program_and_values(name):
    fn, values = LAYERS[name]

    def make(pkg):
        return fn(pkg, _vars(pkg["L"]))

    jp, tp = build(J, make), build(T, make)
    assert tp[0].to_dict() == jp[0].to_dict()
    assert tp[1].to_dict() == jp[1].to_dict()
    if values is None and name == "create_tensor":
        return
    feed = dict(FEED, **STATIC)
    jout, tout, _, _ = run_both(jp[:2], tp[:2], [feed], [jp[2]], [tp[2]])
    (j,), (t,) = jout[0], tout[0]
    t = np.asarray(t)
    assert t.shape == j.shape and t.dtype == j.dtype, (name, t.dtype, j.dtype)
    if values is False:
        return
    if j.dtype.kind in "iub":
        np.testing.assert_array_equal(t, j, err_msg=name)
    else:
        close([t], [j], what=name)


def test_layer_scope_is_the_listed_remainder():
    import paddle_tpu.layers as JL
    import paddle_tpu_torch.layers as TL

    names = lambda m: {n for n in dir(m) if not n.startswith("_")}  # noqa: E731
    vision = {"adaptive_pool2d", "adaptive_pool3d", "affine_channel",
              "affine_grid", "bilinear_tensor_product", "conv3d",
              "conv3d_transpose", "crop", "deformable_conv", "grid_sampler",
              "im2sequence", "image_resize", "image_resize_short", "lrn",
              "maxout", "multiplex", "pad_constant_like", "pixel_shuffle",
              "pool3d", "random_crop", "resize_bilinear", "resize_nearest",
              "resize_trilinear", "sampling_id", "shard_index",
              "shuffle_channel", "temporal_shift", "unfold"}
    detection = {"anchor_generator", "bipartite_match", "box_coder",
                 "density_prior_box", "detection", "detection_output",
                 "generate_proposals", "iou_similarity", "multiclass_nms",
                 "prior_box", "psroi_pool", "roi_align", "roi_pool",
                 "ssd_loss", "yolo_box", "yolov3_loss"}
    crf_ctc = {"linear_chain_crf", "crf_decoding", "chunk_eval",
               "ctc_greedy_decoder", "edit_distance", "warpctc"}
    assert (len(vision), len(detection), len(crf_ctc)) == (28, 16, 6)
    assert vision | detection | crf_ctc <= names(TL)
    assert names(JL) - names(TL) == set()
    assert set(LAYERS) <= set(TL.__all__)
    assert len(LAYERS) == 90


# -- the JAX package's own tests of these layers, on the port ------------------


def _run_port(fn, feed, fetch_n=1):
    """Build `fn(L)` through the port and run it once on the CPU."""
    main, startup, outs = build(T, lambda p: fn(p["L"]))
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    exe, scope = T["exe"](), T["scope"]()
    exe.run(startup, scope=scope)
    vals = exe.run(main, feed=feed, fetch_list=[o.name for o in outs[:fetch_n]],
                   scope=scope)
    return [np.asarray(v) for v in vals], main, scope


def test_activation_wrappers():
    """tests/test_layers_longtail.py:23 on the port."""
    x = np.linspace(-3, 3, 12).astype(np.float32).reshape(2, 6)

    def fn(L):
        v = L.data(name="x", shape=[6], dtype="float32")
        return [L.elu(v), L.relu6(v), L.hard_sigmoid(v), L.swish(v),
                L.selu(v), L.sign(v), L.brelu(v), L.soft_relu(v),
                L.stanh(v), L.hard_swish(v)]

    outs, _, _ = _run_port(fn, {"x": x}, 10)
    np.testing.assert_allclose(outs[0], np.where(x >= 0, x, np.exp(x) - 1),
                               rtol=1e-5)
    np.testing.assert_allclose(outs[1], np.clip(x, 0, 6), rtol=1e-6)
    np.testing.assert_allclose(outs[5], np.sign(x))
    s, a = 1.0507009873554805, 1.6732632423543772
    np.testing.assert_allclose(outs[4], s * np.where(x >= 0, x, a * (np.exp(x) - 1)),
                               rtol=1e-5)
    np.testing.assert_allclose(outs[9], x * np.clip(x + 3, 0, 6) / 6, rtol=1e-6)


def test_elementwise_and_reduce_wrappers():
    """tests/test_layers_longtail.py:40 on the port."""
    x = np.array([[7.0, -3.0], [5.0, 2.0]], np.float32)
    y = np.array([[2.0, 2.0], [3.0, 2.0]], np.float32)

    def fn(L):
        a = L.data(name="x", shape=[2], dtype="float32")
        b = L.data(name="y", shape=[2], dtype="float32")
        return [L.elementwise_mod(a, b), L.elementwise_floordiv(a, b),
                L.reduce_any(L.greater_than(a, b)),
                L.reduce_all(L.greater_than(a, b))]

    (m, f, anyv, allv), _, _ = _run_port(fn, {"x": x, "y": y}, 4)
    np.testing.assert_allclose(m, np.mod(x, y))
    np.testing.assert_allclose(f, np.floor_divide(x, y))
    assert bool(anyv) is True and bool(allv) is False


def test_loss_wrappers():
    """tests/test_layers_longtail.py:57 on the port."""
    rng = np.random.default_rng(0)
    logp = np.log(rng.dirichlet(np.ones(4), 6)).astype(np.float32)
    tgt = rng.dirichlet(np.ones(4), 6).astype(np.float32)
    pred = rng.random((6, 1)).astype(np.float32) * 0.8 + 0.1
    lbl = rng.integers(0, 2, (6, 1)).astype(np.float32)

    def fn(L):
        lp = L.data(name="lp", shape=[4], dtype="float32")
        t = L.data(name="t", shape=[4], dtype="float32")
        p = L.data(name="p", shape=[1], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        return [L.kldiv_loss(lp, t, reduction="mean"), L.log_loss(p, y),
                L.huber_loss(p, y, delta=0.5), L.rank_loss(y, p, p)]

    (kld, ll, hub, rl), _, _ = _run_port(
        fn, {"lp": logp, "t": tgt, "p": pred, "y": lbl}, 4)
    np.testing.assert_allclose(kld, (tgt * (np.log(tgt) - logp)).mean(), rtol=1e-4)
    np.testing.assert_allclose(
        ll, -lbl * np.log(pred + 1e-4) - (1 - lbl) * np.log(1 - pred + 1e-4),
        rtol=1e-3)
    np.testing.assert_allclose(rl, np.log1p(np.exp(0.0)) - lbl * 0.0, rtol=1e-5)
    assert np.isfinite(hub).all()


def test_tensor_wrappers():
    """tests/test_layers_longtail.py:107 on the port (crop and shard_index
    are vision layers, ported with the next slice)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    idx = np.array([[0, 1], [2, 3]], np.int64)
    upd = np.array([10.0, 20.0], np.float32)

    def fn(L):
        v = L.data(name="x", shape=[4], dtype="float32")
        i = L.data(name="i", shape=[2], dtype="int64")
        u = L.data(name="u", shape=[], dtype="float32")
        return [L.gather_nd(v, i), L.scatter_nd_add(v, i, u), L.rank(v),
                L.size(v), L.sum([v, v])]

    (g, sc, rk, sz, sm), _, _ = _run_port(fn, {"x": x, "i": idx, "u": upd}, 5)
    np.testing.assert_allclose(g, x[idx[:, 0], idx[:, 1]])
    ref = x.copy()
    ref[0, 1] += 10
    ref[2, 3] += 20
    np.testing.assert_allclose(sc, ref)
    assert int(rk.reshape(-1)[0]) == 2 and int(np.asarray(sz).reshape(-1)[0]) == 12
    np.testing.assert_allclose(sm, 2 * x)


def test_add_position_encoding_wrapper():
    """tests/test_layers_longtail.py:169's add_position_encoding on the
    port, against the sinusoid table itself."""
    s = np.random.default_rng(5).standard_normal((2, 4, 8)).astype(np.float32)

    def fn(L):
        return L.add_position_encoding(
            L.data(name="s", shape=[4, 8], dtype="float32"))

    (pe,), _, _ = _run_port(fn, {"s": s})
    pos, i = np.arange(4)[:, None], np.arange(4)[None, :]
    ang = pos / np.power(10000.0, 2.0 * i / 8)
    table = np.zeros((4, 8))
    table[:, 0::2], table[:, 1::2] = np.sin(ang), np.cos(ang)
    np.testing.assert_allclose(pe, s + table, rtol=1e-5, atol=1e-6)


def test_rank_loss_stable_at_large_margin():
    """tests/test_layers_longtail.py:252 on the port."""
    def fn(L):
        l_ = L.data(name="l", shape=[1], dtype="float32")
        r = L.data(name="r", shape=[1], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        return L.rank_loss(y, l_, r)

    (out,), _, _ = _run_port(fn, {"l": np.array([[200.0]], np.float32),
                                  "r": np.array([[0.0]], np.float32),
                                  "y": np.array([[1.0]], np.float32)})
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 0.0, atol=1e-4)


def test_hsigmoid_path_consistency():
    """tests/test_losses_and_quant.py:47 on the port: the loss is a numpy
    replay of the SimpleCode path."""
    rng = np.random.default_rng(1)
    D, C, Bn = 6, 10, 4
    xv = rng.standard_normal((Bn, D)).astype(np.float32)
    lbl = rng.integers(0, C, (Bn, 1)).astype(np.int64)

    def fn(L):
        x = L.data(name="x", shape=[D], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="int64")
        import paddle_tpu_torch as pt
        return L.hsigmoid(x, y, num_classes=C, param_attr=pt.ParamAttr(name="hs.w"),
                          bias_attr=pt.ParamAttr(name="hs.b"))

    (got,), _, scope = _run_port(fn, {"x": xv, "y": lbl})
    w, b = scope.find_var("hs.w").numpy(), scope.find_var("hs.b").numpy()

    def ref_loss(x_row, c):
        code, loss = c + C, 0.0
        for d in range(int(np.floor(np.log2(code)))):
            idx, bit = (code >> (d + 1)) - 1, (code >> d) & 1
            pre = x_row @ w[idx] + b[idx]
            loss += np.log1p(np.exp(pre)) - bit * pre
        return loss

    expect = np.array([ref_loss(xv[i], int(lbl[i, 0])) for i in range(Bn)])
    np.testing.assert_allclose(got.reshape(-1), expect, rtol=1e-4)


def test_nce_trains_and_uses_saved_samples():
    """tests/test_losses_and_quant.py:81 on the port."""
    import paddle_tpu_torch as pt

    rng = np.random.default_rng(2)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        L = pt.layers
        x = L.data(name="x", shape=[16], dtype="float32")
        lbl = L.data(name="lbl", shape=[1], dtype="int64")
        cost = L.mean(L.nce(x, lbl, num_total_classes=40, num_neg_samples=8,
                            sampler="log_uniform"))
        pt.optimizer.SGD(0.1).minimize(cost)
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    losses = []
    for _ in range(40):
        xb = rng.standard_normal((16, 16)).astype(np.float32)
        yb = np.abs(xb[:, :1]).round().astype(np.int64) % 40
        losses.append(float(exe.run(main, feed={"x": xb, "lbl": yb},
                                    fetch_list=[cost], scope=scope)[0]))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], losses


def test_distributions_math():
    """tests/test_losses_and_quant.py:102 on the port, and Uniform's
    log_prob, MultivariateNormalDiag and Categorical's KL."""
    def fn(L):
        D = L.distributions
        n1, n2, u = D.Normal(0.0, 1.0), D.Normal(1.0, 2.0), D.Uniform(0.0, 2.0)
        x = L.data(name="x", shape=[3], dtype="float32")
        cat = D.Categorical(x)
        mv = D.MultivariateNormalDiag(np.zeros(2, np.float32),
                                      np.diag([1.0, 4.0]).astype(np.float32))
        mv2 = D.MultivariateNormalDiag(np.ones(2, np.float32),
                                       np.eye(2, dtype=np.float32))
        return [n1.entropy(), n1.kl_divergence(n2), u.entropy(),
                n1.log_prob(L.fill_constant([1], "float32", 0.0)),
                cat.entropy(), cat.sample(seed=5),
                u.log_prob(L.fill_constant([1], "float32", 0.5)),
                mv.entropy(), mv.kl_divergence(mv2),
                cat.kl_divergence(D.Categorical(L.scale(x, scale=2.0)))]

    outs, _, _ = _run_port(
        fn, {"x": np.log(np.array([[0.5, 0.25, 0.25]], np.float32))}, 10)
    f = [float(np.asarray(o).reshape(-1)[0]) for o in outs]
    np.testing.assert_allclose(f[0], 0.5 + 0.5 * np.log(2 * np.pi), rtol=1e-5)
    np.testing.assert_allclose(f[1], np.log(2.0) + 2.0 / 8 - 0.5, rtol=1e-5)
    np.testing.assert_allclose(f[2], np.log(2.0), rtol=1e-5)
    np.testing.assert_allclose(f[3], -0.5 * np.log(2 * np.pi), rtol=1e-5)
    np.testing.assert_allclose(
        f[4], -(0.5 * np.log(0.5) + 2 * 0.25 * np.log(0.25)), rtol=1e-4)
    assert 0 <= int(f[5]) < 3
    np.testing.assert_allclose(f[6], -np.log(2.0), rtol=1e-5)
    np.testing.assert_allclose(f[7], 0.5 * np.log(4.0) + (1 + np.log(2 * np.pi)),
                               rtol=1e-5)
    # KL(N(0, diag(1, 4)) || N(1, I)) = 0.5 (tr + quad - k + log det ratio)
    np.testing.assert_allclose(f[8], 0.5 * (5.0 + 2.0 - 2.0 - np.log(4.0)),
                               rtol=1e-5)
    p = np.array([0.5, 0.25, 0.25])
    q = p ** 2 / (p ** 2).sum()
    np.testing.assert_allclose(f[9], (p * np.log(p / q)).sum(), rtol=1e-4)


def test_print_op_passthrough_and_first_n(capsys):
    """tests/test_ops_longtail.py:327 on the port."""
    def fn(L):
        x = L.data(name="x", shape=[3], dtype="float32")
        return L.scale(L.Print(x, first_n=2, message="dbg"), scale=2.0)

    main, startup, out = build(T, lambda p: fn(p["L"]))
    exe, scope = T["exe"](), T["scope"]()
    exe.run(startup, scope=scope)
    xb = np.arange(6, dtype=np.float32).reshape(2, 3)
    for _ in range(4):
        (o,) = exe.run(main, feed={"x": xb}, fetch_list=[out.name], scope=scope)
    np.testing.assert_allclose(np.asarray(o), xb * 2)
    assert capsys.readouterr().out.count("dbg") == 2


def test_print_on_gradient_path_trains():
    """tests/test_ops_longtail.py:432 on the port."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        L = pt.layers
        h = L.Print(L.fc(L.data(name="x", shape=[3], dtype="float32"), size=4),
                    message="dbg", first_n=0)
        loss = L.mean(h)
        pt.optimizer.SGD(0.1).minimize(loss)
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    w0 = scope.find_var("fc_0.w_0").clone()
    exe.run(main, feed={"x": np.ones((2, 3), np.float32)}, fetch_list=[loss],
            scope=scope)
    assert not np.allclose(w0.numpy(), scope.find_var("fc_0.w_0").numpy())


def test_print_preserves_shape_metadata():
    """tests/test_ops_longtail.py:452 on the port."""
    import paddle_tpu_torch as pt

    with pt.program_guard(pt.Program(), pt.Program()):
        L = pt.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        y = L.Print(x)
        assert tuple(y.shape) == tuple(x.shape)
        out = L.fc(y, size=4)
        assert out.block.program.all_parameters()[0].shape[0] == 3
