"""The last sequence and RNN ops of the port held against the JAX package
on the CPU: sequence_slice, sequence_erase, sequence_expand_as,
sequence_scatter, sequence_conv, sequence_enumerate, sequence_reshape,
sequence_topk_avg_pooling, match_matrix_tensor, lstmp, cudnn_lstm and
row_conv.

* Each op's outputs and its input grads (the port's by replay, the JAX
  op's through jax.vjp) on the same inputs and cotangents: within 1e-5
  (fp32 sums in another order); sequence_erase and sequence_enumerate have
  no grad and are held bit for bit.
* The port's versions of tests/test_layers_tail_r4.py:39-240 (through
  test_row_conv_lookahead) and tests/test_ops_longtail.py:276 and :463:
  the layers' programs equal the JAX package's through to_dict(), the
  forward from the JAX startup's weights within 1e-5 of the JAX package's,
  and each test's own numpy oracle.
* cudnn_lstm's inter-layer dropout: L - 1 masks, none after the last
  layer, keep rate within 5 binomial sigmas, and the replayed grad
  applying the forward's masks (a central difference at a fixed run
  counter).
"""
import numpy as np
import pytest
import torch

from torch_parity import J, T, build, close, op_outputs_and_grads, run_both

import paddle_tpu_torch as tpt


def _r(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _i(a):
    return np.asarray(a, np.int64)


def _cudnn_w(D, H, L, dirs, seed):
    n = 0
    for layer in range(L):
        ind = D if layer == 0 else H * dirs
        n += dirs * (ind * 4 * H + H * 4 * H + 4 * H)
    return _r((n,), seed, 0.3)


B, TT, D = 2, 5, 3
OPS = {
    "sequence_slice": (
        {"X": {"x": _r((B, TT, D), 1)}, "Offset": {"off": _i([1, 0])},
         "Length": {"ln": _i([2, 4])}},
        {"Out": ["o"], "OutLength": ["ol"]}, {}, {"o": _r((B, TT, D), 2)}),
    "sequence_erase": (
        {"X": {"x": _i([[2, 7, 2, 5, 0], [9, 2, 9, 0, 0]])},
         "Length": {"ln": _i([4, 3])}},
        {"Out": ["o"], "OutLength": ["ol"]}, {"tokens": [2, 0]}, {}),
    "sequence_expand_as": (
        {"X": {"x": _r((2, 3), 3)}, "Y": {"y": np.zeros((6, 3), np.float32)}},
        {"Out": ["o"]}, {}, {"o": _r((6, 3), 4)}),
    "sequence_scatter": (
        {"X": {"x": _r((2, 6), 5)}, "Ids": {"ids": _i([[1, 3, 1], [0, 5, 2]])},
         "Updates": {"upd": _r((2, 3), 6)}, "IdsLength": {"il": _i([3, 2])}},
        {"Out": ["o"]}, {}, {"o": _r((2, 6), 7)}),
    "sequence_conv": (
        {"X": {"x": _r((B, TT, D), 8)}, "Filter": {"f": _r((3 * D, 4), 9)},
         "Length": {"ln": _i([3, 5])}},
        {"Out": ["o"]}, {"contextStart": -1, "contextLength": 3},
        {"o": _r((B, TT, 4), 10)}),
    "sequence_enumerate": (
        {"X": {"x": _i([[1, 2, 3, 4], [5, 6, 7, 0]])},
         "Length": {"ln": _i([4, 3])}},
        {"Out": ["o"]}, {"win_size": 3, "pad_value": 9}, {}),
    "sequence_reshape": (
        {"X": {"x": _r((2, 2, 6), 11)}}, {"Out": ["o"]}, {"new_dim": 4},
        {"o": _r((2, 3, 4), 12)}),
    "sequence_topk_avg_pooling": (
        {"X": {"x": _r((2, 2, 3, 5), 13)}, "ColLength": {"cl": _i([5, 3])},
         "RowLength": {"rl": _i([3, 2])}},
        {"Out": ["o"]}, {"topks": [1, 3, 4], "channel_num": 2},
        {"o": _r((2, 3, 6), 14)}),
    "match_matrix_tensor": (
        {"X": {"x": _r((2, 3, 5), 15)}, "Y": {"y": _r((2, 4, 5), 16)},
         "W": {"w": _r((5, 2, 5), 17)}, "XLength": {"xl": _i([3, 2])},
         "YLength": {"yl": _i([4, 1])}},
        {"Out": ["o"]}, {}, {"o": _r((2, 2, 3, 4), 18)}),
    "lstmp": (
        {"Input": {"x": _r((B, TT, 16), 19)}, "Weight": {"w": _r((2, 16), 20, 0.3)},
         "ProjWeight": {"pw": _r((4, 2), 21, 0.3)},
         "Bias": {"b": _r((1, 16), 22, 0.1)}},
        {"Projection": ["p"], "Cell": ["c"]},
        {"proj_activation": "tanh", "is_reverse": True},
        {"p": _r((B, TT, 2), 23), "c": _r((B, TT, 4), 24)}),
    "cudnn_lstm": (
        {"Input": {"x": _r((B, TT, D), 25)}, "W": {"w": _cudnn_w(D, 3, 2, 2, 26)},
         "InitH": {"h0": _r((4, B, 3), 27)}, "InitC": {"c0": _r((4, B, 3), 28)}},
        {"Out": ["o"], "LastH": ["lh"], "LastC": ["lc"]},
        {"num_layers": 2, "hidden_size": 3, "is_bidirec": True},
        {"o": _r((B, TT, 6), 29), "lh": _r((4, B, 3), 30),
         "lc": _r((4, B, 3), 31)}),
    "row_conv": (
        {"X": {"x": _r((B, TT, D), 32)}, "Filter": {"f": _r((3, D), 33)}},
        {"Out": ["o"]}, {}, {"o": _r((B, TT, D), 34)}),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_and_its_grads_match_jax(op):
    ins, outs, attrs, cots = OPS[op]
    jo, jg, _ = op_outputs_and_grads(J, op, ins, outs, attrs, cots)
    to, tg, _ = op_outputs_and_grads(T, op, ins, outs, attrs, cots)
    assert to.keys() == jo.keys()
    for k in jo:
        if jo[k].dtype.kind in "iu":
            np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
        else:
            close([to[k]], [jo[k]], what=f"{op} {k}")
    assert tg.keys() == jg.keys()
    assert bool(cots) == bool(tg)       # a grad for every differentiable op
    for k in jg:
        close([tg[k]], [jg[k]], what=f"{op} d{k}")


# -- the layers (tests/test_layers_tail_r4.py) ---------------------------------


def _layer(pkg_fn, feeds):
    """Build pkg_fn in both packages; equal programs; run both from the JAX
    startup's weights; the port's fetches, each within 1e-5 of the JAX
    package's, and the port's scope."""
    jm, js, jf = build(J, pkg_fn)
    tm, ts, tf = build(T, pkg_fn)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    jout, tout, _, tscope = run_both((jm, js), (tm, ts), [feeds], jf, tf)
    for t, j in zip(tout[0], jout[0]):
        close([t], [j])
    return tout[0], tscope


def test_sequence_conv_matches_manual_window():
    Bs, Ts, Ds, F, K = 2, 5, 3, 4, 3
    x = _r((Bs, Ts, Ds), 0)

    def fn(pkg):
        v = pkg["L"].data(name="x", shape=[Ts, Ds], dtype="float32")
        return [pkg["L"].sequence_conv(
            v, num_filters=F, filter_size=K, bias_attr=False,
            param_attr=pkg["pt"].ParamAttr(name="seqconv_w"))]

    (out,), scope = _layer(fn, {"x": x})
    w = scope.find_var("seqconv_w").numpy()
    expect = np.zeros((Bs, Ts, F), np.float32)
    for b in range(Bs):
        for t in range(Ts):
            ctx = [x[b, t - K // 2 + j] if 0 <= t - K // 2 + j < Ts
                   else np.zeros(Ds, np.float32) for j in range(K)]
            expect[b, t] = np.concatenate(ctx) @ w
    np.testing.assert_allclose(out, expect, rtol=2e-5, atol=1e-5)


def test_sequence_enumerate_and_reshape():
    def fn(pkg):
        L = pkg["L"]
        v = L.data(name="x", shape=[4], dtype="int64")
        lv = L.data(name="ln", shape=[], dtype="int64")
        en = L.sequence_enumerate(v, win_size=2, pad_value=0, length=lv)
        r = L.data(name="r", shape=[2, 6], dtype="float32")
        return [en, L.sequence_reshape(r, new_dim=4)]

    (en, rs), _ = _layer(fn, {
        "x": _i([[1, 2, 3, 4], [5, 6, 7, 0]]), "ln": _i([4, 3]),
        "r": np.arange(24, dtype=np.float32).reshape(2, 2, 6)})
    np.testing.assert_array_equal(en[0], [[1, 2], [2, 3], [3, 4], [4, 0]])
    np.testing.assert_array_equal(en[1], [[5, 6], [6, 7], [7, 0], [0, 0]])
    assert rs.shape == (2, 3, 4)
    np.testing.assert_array_equal(rs[0, 0], [0, 1, 2, 3])


def test_sequence_slice_scatter_expand_as():
    x = np.arange(24, dtype=np.float32).reshape(2, 4, 3)

    def fn(pkg):
        L = pkg["L"]
        v = L.data(name="x", shape=[4, 3], dtype="float32")
        off = L.data(name="off", shape=[], dtype="int64")
        ln = L.data(name="ln", shape=[], dtype="int64")
        base = L.data(name="base", shape=[5], dtype="float32")
        ids = L.data(name="ids", shape=[2], dtype="int64")
        upd = L.data(name="upd", shape=[2], dtype="float32")
        small = L.data(name="small", shape=[3], dtype="float32")
        return [L.sequence_slice(v, off, ln),
                L.sequence_scatter(base, ids, upd),
                L.sequence_expand_as(small, v)]

    (sl, sc, ex), _ = _layer(fn, {
        "x": x, "off": _i([1, 0]), "ln": _i([2, 3]),
        "base": np.zeros((2, 5), np.float32), "ids": _i([[0, 2], [1, 1]]),
        "upd": np.array([[1.0, 2.0], [3.0, 4.0]], np.float32),
        "small": np.array([[1, 2, 3]], np.float32)})
    np.testing.assert_array_equal(sl[0, :2], x[0, 1:3])
    np.testing.assert_array_equal(sl[0, 2:], 0.0)
    np.testing.assert_array_equal(sc[0], [1, 0, 2, 0, 0])
    np.testing.assert_array_equal(sc[1], [0, 7, 0, 0, 0])  # 3+4 at idx 1
    np.testing.assert_array_equal(ex, [[1, 2, 3], [1, 2, 3]])


def test_sequence_topk_avg_pooling():
    x = np.array([[[[4.0, 1.0, 3.0, 2.0], [1.0, 1.0, 1.0, 1.0]],
                   [[0.0, 10.0, 5.0, 1.0], [2.0, 4.0, 6.0, 8.0]]]],
                 np.float32)

    def fn(pkg):
        v = pkg["L"].data(name="x", shape=[2, 2, 4], dtype="float32")
        return [pkg["L"].sequence_topk_avg_pooling(v, topks=[1, 3],
                                                   channel_num=2)]

    (out,), _ = _layer(fn, {"x": x})
    assert out.shape == (1, 2, 4)
    np.testing.assert_allclose(out[0, 0], [4.0, 3.0, 10.0, 16.0 / 3],
                               rtol=1e-6)
    np.testing.assert_allclose(out[0, 1], [1.0, 1.0, 8.0, 6.0], rtol=1e-6)


def test_match_matrix_tensor():
    Bm, Tx, Ty, H, C = 2, 3, 4, 5, 2
    x, y = _r((Bm, Tx, H), 1), _r((Bm, Ty, H), 2)

    def fn(pkg):
        L = pkg["L"]
        xv = L.data(name="x", shape=[Tx, H], dtype="float32")
        yv = L.data(name="y", shape=[Ty, H], dtype="float32")
        out, _ = L.match_matrix_tensor(
            xv, yv, channel_num=C, param_attr=pkg["pt"].ParamAttr(name="mmt_w"))
        return [out]

    (out,), scope = _layer(fn, {"x": x, "y": y})
    w = scope.find_var("mmt_w").numpy()
    np.testing.assert_allclose(out, np.einsum("bih,hcg,bjg->bcij", x, w, y),
                               rtol=2e-5, atol=1e-5)


def test_lstm_cudnn_shapes_and_determinism():
    Bl, Tl, Dl, H, NL = 2, 5, 4, 3, 2

    def fn(pkg):
        L = pkg["L"]
        v = L.data(name="x", shape=[Tl, Dl], dtype="float32")
        h0 = L.data(name="h0", shape=[NL, Bl, H], dtype="float32",
                    append_batch_size=False)
        c0 = L.data(name="c0", shape=[NL, Bl, H], dtype="float32",
                    append_batch_size=False)
        return list(L.lstm(v, h0, c0, max_len=Tl, hidden_size=H,
                           num_layers=NL))

    (out, lh, lc), _ = _layer(fn, {
        "x": _r((Bl, Tl, Dl), 2), "h0": np.zeros((NL, Bl, H), np.float32),
        "c0": np.zeros((NL, Bl, H), np.float32)})
    assert out.shape == (Bl, Tl, H)
    assert lh.shape == (NL, Bl, H) and lc.shape == (NL, Bl, H)
    np.testing.assert_allclose(out[:, -1, :], lh[-1], rtol=1e-5)
    assert np.abs(out).max() > 0


def test_dynamic_lstmp_projection_path():
    Bl, Tl, H, P = 2, 4, 3, 2

    def fn(pkg):
        v = pkg["L"].data(name="x", shape=[Tl, 4 * H], dtype="float32")
        return list(pkg["L"].dynamic_lstmp(v, size=4 * H, proj_size=P,
                                           use_peepholes=False))

    (proj, cell), _ = _layer(fn, {"x": _r((Bl, Tl, 4 * H), 3)})
    assert proj.shape == (Bl, Tl, P)
    assert cell.shape == (Bl, Tl, H)
    assert np.isfinite(proj).all()
    with pytest.raises(NotImplementedError, match="peephole"):
        build(T, lambda pkg: pkg["L"].dynamic_lstmp(
            pkg["L"].data(name="x", shape=[Tl, 4 * H], dtype="float32"),
            size=4 * H, proj_size=P, use_peepholes=True))


def test_row_conv_lookahead():
    x = np.arange(8, dtype=np.float32).reshape(1, 4, 2)

    def fn(pkg):
        v = pkg["L"].data(name="x", shape=[4, 2], dtype="float32")
        return [pkg["L"].row_conv(v, future_context_size=1,
                                  param_attr=pkg["pt"].ParamAttr(
                                      name="rowconv_w"))]

    (out,), scope = _layer(fn, {"x": x})
    w = scope.find_var("rowconv_w").numpy()
    expect = np.zeros_like(x)
    for t in range(4):
        for i in range(2):
            if t + i < 4:
                expect[0, t] += x[0, t + i] * w[i]
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-6)


# -- sequence_erase (tests/test_ops_longtail.py:276, :463) ---------------------


def _erase(pkg, x, ln, tokens):
    main, startup = pkg["pt"].Program(), pkg["pt"].Program()
    with pkg["pt"].program_guard(main, startup):
        blk = main.global_block
        blk.create_var(name="x", shape=x.shape, dtype="int64", is_data=True)
        blk.create_var(name="l", shape=ln.shape, dtype="int64", is_data=True)
        blk.create_var(name="o", shape=(), dtype="int64")
        blk.create_var(name="ol", shape=(), dtype="int64")
        blk.append_op("sequence_erase", {"X": ["x"], "Length": ["l"]},
                      {"Out": ["o"], "OutLength": ["ol"]}, {"tokens": tokens})
    return main, startup


@pytest.mark.parametrize("x,ln,tokens,want,want_len", [
    ([[2, 7, 2, 5, 0], [9, 2, 9, 0, 0]], [4, 3], [2, 0],
     [[7, 5, 0, 0, 0], [9, 9, 0, 0, 0]], [2, 2]),
    ([[-5, 2, -7, 0, 0]], [3], [2], [[-5, -7, 0, 0, 0]], [2]),
], ids=["tokens", "negative_values"])
def test_sequence_erase(x, ln, tokens, want, want_len):
    x, ln = _i(x), _i(ln)
    jprog, tprog = _erase(J, x, ln, tokens), _erase(T, x, ln, tokens)
    assert tprog[0].to_dict() == jprog[0].to_dict()
    jout, tout, _, _ = run_both(jprog, tprog, [{"x": x, "l": ln}],
                                ["o", "ol"])
    np.testing.assert_array_equal(tout[0][0], want)
    np.testing.assert_array_equal(tout[0][1], want_len)
    for t, j in zip(tout[0], jout[0]):
        np.testing.assert_array_equal(t, j)


# -- cudnn_lstm's dropout ------------------------------------------------------


def _lstm_ctx(L, p, H=16, dirs=1, seed=0, stash=None):
    from paddle_tpu_torch.executor import _run_generator
    from paddle_tpu_torch.ops.registry import ExecContext

    class Op:
        type = "cudnn_lstm"
        inputs = {"Input": ["x"], "W": ["w"], "InitH": ["h0"],
                  "InitC": ["c0"]}
        outputs = {"Out": ["o"], "LastH": ["lh"], "LastC": ["lc"]}
        attrs = {"num_layers": L, "hidden_size": H, "is_bidirec": dirs == 2,
                 "dropout_prob": p}

    env = {"x": torch.from_numpy(_r((8, 12, 10), 40)),
           "w": torch.from_numpy(_cudnn_w(10, H, L, dirs, 41)),
           "h0": torch.zeros(L * dirs, 8, H), "c0": torch.zeros(L * dirs, 8, H)}
    gen = _run_generator(torch.device("cpu"), seed, 1)
    return ExecContext(Op, env, torch.device("cpu"), gen, stash)


def test_cudnn_lstm_dropout_masks_between_layers_only():
    """3 layers at p = 0.3: two masks (none after the last layer), each
    0 or 1 / 0.7, keeping a share within 5 binomial sigmas of 0.7; one
    layer with dropout computes what it computes without."""
    from paddle_tpu_torch.ops.registry import get_op_def

    op = get_op_def("cudnn_lstm")
    stash = {}
    op.compute(_lstm_ctx(3, 0.3, dirs=2, stash=stash))
    (masks,) = stash.values()
    assert len(masks) == 2
    for m in masks:
        assert m.shape == (8, 12, 32)
        vals = set(np.unique(m.numpy()).tolist())
        assert vals <= {0.0, np.float32(1 / 0.7).item()}
        keep = float((m > 0).float().mean())
        n = m.numel()
        assert abs(keep - 0.7) <= 5 * np.sqrt(0.7 * 0.3 / n), keep
    one = op.compute(_lstm_ctx(1, 0.3, stash={}))
    plain = op.compute(_lstm_ctx(1, 0.0))
    for k in plain:
        torch.testing.assert_close(one[k], plain[k], rtol=0, atol=0)


def test_cudnn_lstm_dropout_grad_replays_the_forward_masks():
    """A 2-layer lstm at dropout 0.5 under SGD: the replayed grad of W,
    read in the direction of a random unit vector, equals a central
    difference of the loss at the same run counter (same masks) within
    2e-2 relative; with masks redrawn it would not."""
    def fn(pkg):
        L = pkg["L"]
        v = L.data(name="x", shape=[6, 4], dtype="float32")
        h0 = L.data(name="h0", shape=[2, 3, 5], dtype="float32",
                    append_batch_size=False)
        c0 = L.data(name="c0", shape=[2, 3, 5], dtype="float32",
                    append_batch_size=False)
        out, _, _ = L.lstm(v, h0, c0, max_len=6, hidden_size=5, num_layers=2,
                           dropout_prob=0.5,
                           default_initializer=None)
        return L.reduce_sum(L.elementwise_mul(out, out))

    main, startup, loss = build(T, fn)
    wname = main.all_parameters()[0].name
    (g,) = tpt.gradients([loss], [main.global_block.var(wname)])
    feed = {"x": _r((3, 6, 4), 50), "h0": np.zeros((2, 3, 5), np.float32),
            "c0": np.zeros((2, 3, 5), np.float32)}
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    w0 = scope.find_var(wname).double().clone()

    def run(w, fetch):
        scope.set_var(wname, w.float())
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       rng_counter=7)

    l0, grad = run(w0, [loss, g])
    d = torch.from_numpy(np.random.default_rng(51).standard_normal(w0.shape))
    d /= d.norm()
    eps = 1e-2
    lp = float(run(w0 + eps * d, [loss])[0])
    lm = float(run(w0 - eps * d, [loss])[0])
    fd = (lp - lm) / (2 * eps)
    an = float(torch.from_numpy(grad).double() @ d)
    assert abs(fd - an) <= 2e-2 * abs(an), (fd, an)
    (l_other,) = run(w0, [loss])
    assert float(l_other) == float(l0)
