"""The port's control flow (framework sub-blocks, ExecContext.run_block,
ops/control_flow_ops.py, layers/control_flow.py) held against the JAX
package's: each case of tests/test_control_flow.py (and its DynamicRNN
case from tests/test_seq2seq.py) built through both packages' layers, the
programs equal through to_dict(), then run through both executors on the
CPU from the JAX startup's weights. Values agree within 1e-5 (fp32 on both
sides, sums in another order); the BPTT case compares the step-1
gradients of every parameter and three Adam steps' losses.
"""
import numpy as np
import pytest
import torch

from torch_parity import J, T, build, close, run_both

import paddle_tpu_torch as tpt
from paddle_tpu_torch.ops import control_flow_ops


def _both(fn, feeds, fetch_idx=None, seed=0):
    """Build fn through both packages, hold the programs equal, run both
    over feeds; fn returns the vars to fetch."""
    jm, js, jf = build(J, fn, seed)
    tm, ts, tf = build(T, fn, seed)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    jf = jf if isinstance(jf, (list, tuple)) else [jf]
    tf = tf if isinstance(tf, (list, tuple)) else [tf]
    jout, tout, _, _ = run_both((jm, js), (tm, ts), feeds, jf, tf)
    for j, t in zip(jout, tout):
        close(t, j)
    return tout, tm


def test_while_accumulates():
    """sum 0..9 with a While loop; the loop reads its condition on the
    host once an iteration and once more to leave."""
    def fn(pkg):
        L = pkg["L"]
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=10)
        acc = L.fill_constant(shape=[1], dtype="int64", value=0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_add(acc, i), acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond)
        return [acc, i]

    syncs, iters = control_flow_ops.while_op.host_syncs, \
        control_flow_ops.while_op.iterations
    tout, _ = _both(fn, [{}])
    assert int(np.asarray(tout[0][0]).reshape(-1)[0]) == 45
    assert int(np.asarray(tout[0][1]).reshape(-1)[0]) == 10
    assert control_flow_ops.while_op.iterations - iters == 10
    assert control_flow_ops.while_op.host_syncs - syncs == 11


def test_while_reads_outer_var():
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[4], dtype="float32")
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=3)
        acc = L.fill_constant(shape=[1, 4], dtype="float32", value=0.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            s = L.reduce_sum(x, dim=0, keep_dim=True)  # an outer read
            L.assign(L.elementwise_add(acc, s), acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond)
        return acc

    xv = np.arange(8, dtype=np.float32).reshape(2, 4)
    tout, _ = _both(fn, [{"x": xv}])
    np.testing.assert_allclose(tout[0][0], 3 * xv.sum(0, keepdims=True))


def test_while_nests_a_cond():
    """A cond inside a While body: the runner nests blocks."""
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[4], dtype="float32")
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=4)
        two = L.fill_constant(shape=[1], dtype="int64", value=2)
        acc = L.fill_constant(shape=[1, 4], dtype="float32", value=0.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            early = L.reshape(L.less_than(i, two), [])
            step = L.cond(early, lambda: L.scale(x, scale=2.0),
                          lambda: L.scale(x, scale=-1.0))
            L.assign(L.elementwise_add(acc, L.reduce_sum(step, dim=0,
                                                         keep_dim=True)), acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond)
        return acc

    xv = np.arange(8, dtype=np.float32).reshape(2, 4)
    tout, _ = _both(fn, [{"x": xv}])
    np.testing.assert_allclose(tout[0][0], 2 * xv.sum(0, keepdims=True))


def test_cond_selects_branch():
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[4], dtype="float32")
        p = L.data(name="p", shape=[], dtype="bool")
        return L.cond(p, lambda: L.scale(x, scale=2.0),
                      lambda: L.scale(x, scale=-1.0))

    xv = np.ones((2, 4), np.float32)
    tout, _ = _both(fn, [{"x": xv, "p": np.asarray(True)},
                         {"x": xv, "p": np.asarray(False)}])
    np.testing.assert_allclose(tout[0][0], 2 * xv)
    np.testing.assert_allclose(tout[1][0], -xv)


def test_cond_branch_may_return_outer_var_directly():
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[1], dtype="float32")
        yv = L.fc(x, size=1)
        p = L.fill_constant([1], "bool", False)
        return [L.cond(p, lambda: L.scale(x, 2.0), lambda: yv), yv]

    tout, _ = _both(fn, [{"x": np.ones((2, 1), np.float32)}])
    np.testing.assert_allclose(tout[0][0], tout[0][1])


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_cond_outer_scope_write_raises(pkg):
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[1], dtype="float32")
        a = L.scale(x, 1.0)
        p = L.fill_constant([1], "bool", True)
        with pytest.raises(ValueError, match="outer-scope"):
            L.cond(p, lambda: L.assign(L.scale(x, 2.0), a), lambda: a)

    build(pkg, fn)


def test_conditional_block_without_prior_value_raises():
    """A conditional_block with no false block whose output has no value
    before the block: the op's error, attributed to the op."""
    main, startup = tpt.Program(), tpt.Program()
    L = T["L"]
    with tpt.program_guard(main, startup), T["un"].guard():
        x = L.data(name="x", shape=[1], dtype="float32")
        p = L.fill_constant([1], "bool", False)
        blk = main._create_block()
        out = main.global_block.create_var(name="cb_out", shape=[-1, 1],
                                           dtype="float32")
        blk.append_op("scale", {"X": [x.name]}, {"Out": [out.name]},
                      {"scale": 2.0})
        main._rollback()
        main.global_block.append_op(
            "conditional_block", {"Cond": [p.name], "Deps": [x.name]},
            {"Out": [out.name]}, {"sub_block": blk.idx,
                                  "dep_names": [x.name]})
    with pytest.raises(RuntimeError, match="no prior value"):
        tpt.Executor(place="cpu").run(
            main, feed={"x": np.ones((2, 1), np.float32)},
            fetch_list=[out], scope=tpt.Scope())


def _static_rnn(pkg, T_, B, D, H):
    L = pkg["L"]
    x = L.data(name="x", shape=[B, D], dtype="float32")   # [T, B, D]
    h0 = L.data(name="h0", shape=[H], dtype="float32")
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        prev = rnn.memory(init=h0)
        h = L.tanh(L.elementwise_add(
            L.matmul(x_t, L.fill_constant([D, H], "float32", 0.1)), prev))
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    return rnn()


def test_static_rnn_forward_matches_numpy():
    T_, B, D, H = 5, 2, 3, 4
    rng = np.random.default_rng(0)
    xv = rng.standard_normal((T_, B, D)).astype(np.float32)
    h0v = np.zeros((B, H), np.float32)
    tout, _ = _both(lambda pkg: _static_rnn(pkg, T_, B, D, H),
                    [{"x": xv, "h0": h0v}])
    want, h = [], h0v
    for t in range(T_):
        h = np.tanh(xv[t] @ np.full((D, H), 0.1, np.float32) + h)
        want.append(h)
    np.testing.assert_allclose(tout[0][0], np.stack(want), rtol=1e-5)


def _bptt(pkg):
    T_, B, D, H = 4, 8, 3, 5
    L = pkg["L"]
    x = L.data(name="x", shape=[B, D], dtype="float32")
    y = L.data(name="y", shape=[H], dtype="float32")
    h0 = L.fill_constant([B, H], "float32", 0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        prev = rnn.memory(init=h0)
        h = L.fc([x_t, prev], size=H, act="tanh")
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    outs = rnn()
    last = L.squeeze(L.slice(outs, axes=[0], starts=[T_ - 1], ends=[T_]),
                     axes=[0])
    loss = L.mean(L.square_error_cost(last, y))
    pkg["pt"].optimizer.Adam(0.01).minimize(loss)
    main = pkg["pt"].default_main_program()
    return [loss] + [p.name + "@GRAD" for p in main.all_parameters()]


def test_static_rnn_trains_bptt():
    """Backprop through time: the static_rnn grad replays the loop under
    autograd. Step-1 gradients of every parameter and three Adam steps'
    losses against the JAX package's scan + vjp, from the same weights."""
    rng = np.random.default_rng(1)
    xv = rng.standard_normal((4, 8, 3)).astype(np.float32)
    yv = (rng.standard_normal((8, 5)) * 0.5).astype(np.float32)
    tout, tm = _both(_bptt, [{"x": xv, "y": yv}] * 3)
    assert any(op.type == "static_rnn_grad" for op in tm.global_block.ops)
    assert tout[2][0] < tout[0][0]


def test_while_requires_bool_cond():
    for pkg in (J, T):
        def fn(pkg):
            i = pkg["L"].fill_constant(shape=[1], dtype="int64", value=0)
            with pytest.raises(TypeError):
                pkg["L"].While(i)
        build(pkg, fn)


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_while_on_grad_path_raises(pkg):
    """A While between the parameters and the loss raises at minimize."""
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="xg", shape=[4], dtype="float32")
        h = L.fc(x, size=4)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=2)
        acc = L.fill_constant(shape=[1, 4], dtype="float32", value=0.0)
        cnd = L.less_than(i, n)
        w = L.While(cnd)
        with w.block():
            L.assign(L.elementwise_add(acc, h), acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cnd)
        with pytest.raises(RuntimeError, match="gradient path"):
            pkg["pt"].optimizer.SGD(0.1).minimize(L.mean(acc))

    build(pkg, fn)


def test_static_rnn_dropout_varies_per_step():
    """Random ops in a static_rnn body draw anew each step (the streams
    differ between the packages, so the port is held to the JAX test's
    own property: adjacent steps' masks differ)."""
    T_, B, D = 6, 2, 64

    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="xr", shape=[B, D], dtype="float32")
        m0 = L.fill_constant([B, D], "float32", 0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            d = L.dropout(x_t, dropout_prob=0.5,
                          dropout_implementation="upscale_in_train")
            mem = rnn.memory(init=m0)
            rnn.update_memory(mem, d)
            rnn.step_output(d)
        return rnn()

    jm, _, _ = build(J, fn)
    tm, ts, out = build(T, fn)
    assert tm.to_dict() == jm.to_dict()
    (got,) = tpt.Executor(place="cpu").run(
        tm, feed={"xr": np.ones((T_, B, D), np.float32)}, fetch_list=[out],
        scope=tpt.Scope())
    masks = (got != 0).reshape(T_, -1)
    assert not all((masks[t] == masks[0]).all() for t in range(1, T_))
    assert set(np.unique(got)) <= {0.0, 2.0}


def test_switch_first_true_case_wins():
    def fn(pkg):
        L = pkg["L"]
        step = L.data(name="step", shape=[], dtype="float32")
        lr = L.create_global_var([1], 0.0, "float32", name="sw_lr")
        c1 = L.less_than(step, L.fill_constant([], "float32", 10.0))
        c2 = L.less_than(step, L.fill_constant([], "float32", 100.0))
        with L.Switch() as sw:
            with sw.case(c1):
                L.assign(L.fill_constant([1], "float32", 0.001), lr)
            with sw.case(c2):
                L.assign(L.fill_constant([1], "float32", 0.01), lr)
            with sw.default():
                L.assign(L.fill_constant([1], "float32", 0.1), lr)
        return lr

    tout, _ = _both(fn, [{"step": np.float32(s)} for s in (5.0, 50.0, 500.0)])
    np.testing.assert_allclose([float(t[0][0]) for t in tout],
                               [0.001, 0.01, 0.1], rtol=1e-6)


def test_ifelse_rowwise_merge():
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[3], dtype="float32")
        c = L.data(name="c", shape=[1], dtype="bool")
        ie = L.IfElse(c)
        with ie.true_block():
            ie.output(L.scale(ie.input(x), scale=10.0))
        with ie.false_block():
            ie.output(L.scale(ie.input(x), scale=0.0, bias=-1.0))
        return ie()

    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    tout, _ = _both(fn, [{"x": xv, "c": np.array([[True], [False]])}])
    np.testing.assert_allclose(tout[0][0][0], xv[0] * 10.0)
    np.testing.assert_allclose(tout[0][0][1], [-1.0, -1.0, -1.0])


def test_dynamic_rnn_masks_by_length():
    """DynamicRNN freezes each row's state past its length and zeroes its
    outputs there; garbage in a padded tail changes nothing valid."""
    B, Tn, D, H = 3, 5, 4, 6

    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[Tn, D], dtype="float32")
        x.shape = (B, Tn, D)
        lens = L.data(name="lens", shape=[], dtype="int64")
        h0 = L.fill_constant([B, H], "float32", 0.0)
        drnn = L.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(x, length=lens)
            h = drnn.memory(init=h0)
            h2 = L.fc(L.concat([w, h], axis=1), size=H, act="tanh")
            drnn.update_memory(h, h2)
            drnn.output(h2)
        return drnn()

    xv = np.random.default_rng(0).standard_normal((B, Tn, D)).astype(np.float32)
    xv2 = xv.copy()
    xv2[0, 2:] = 1e6
    lv = np.array([2, 5, 3])
    tout, _ = _both(fn, [{"x": xv, "lens": lv}, {"x": xv2, "lens": lv}])
    o, o2 = tout[0][0], tout[1][0]
    assert o.shape == (B, Tn, H)
    assert np.abs(o[0, 2:]).max() == 0.0 and np.abs(o[0, :2]).max() > 0
    np.testing.assert_allclose(o[0, :2], o2[0, :2], rtol=1e-6)
    assert np.abs(o2[0, 2:]).max() == 0.0


def test_sub_block_stash_is_dropped():
    """A sub-block's ops get a stash of their own, dropped when the block
    ends: what a forward op leaves there (K10's (O, lse), a batch norm's
    statistics) does not outlive its segment. A probe op in a While body
    stashes a tensor; a probe after the loop finds it freed, while the
    loop's own outputs are alive."""
    import weakref

    from paddle_tpu_torch.ops.registry import register_op

    refs = []

    @register_op("_stash_probe_in", grad="none", infer=False)
    def _probe_in(ctx):
        t = torch.ones(1024)
        ctx.stash["probe"] = t
        refs.append(weakref.ref(t))
        return {"Out": ctx.input("X")}

    @register_op("_stash_probe_after", grad="none", infer=False)
    def _probe_after(ctx):
        refs.append([r() is None for r in refs])
        return {"Out": ctx.input("X")}

    main, startup = tpt.Program(), tpt.Program()
    L = T["L"]
    with tpt.program_guard(main, startup), T["un"].guard():
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=3)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            main.current_block().append_op("_stash_probe_in", {"X": [i.name]},
                                           {"Out": [i.name]})
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond)
        main.global_block.append_op("_stash_probe_after", {"X": [i.name]},
                                    {"Out": [i.name]})
    (got,) = tpt.Executor(place="cpu").run(main, fetch_list=[i],
                                           scope=tpt.Scope())
    assert int(got.reshape(-1)[0]) == 3
    assert refs[-1] == [True, True, True]
