"""The port's sparse (SelectedRows) gradient path held against the JAX
package on the CPU: core/selected_rows.py, lookup_table's grad with
is_sparse, lookup_table_grad_rows, `sum` over SelectedRows,
merge_selected_rows / get_tensor_from_selected_rows, the row-wise sgd and
the lazy adam, and the refusal of every other update op.

Tolerances: the ops' outputs within 1e-6 (the same fp32 adds, in another
order where duplicates merge); trajectories of 3 steps within rtol 1e-5;
rows no id touched bit for bit their startup values.
"""
import numpy as np
import pytest
import torch

from torch_parity import J, T, build, run_both

import paddle_tpu_torch as tpt
from paddle_tpu.core.selected_rows import SelectedRows as JSelectedRows
from paddle_tpu_torch.core.selected_rows import SelectedRows


# -- the three cases of tests/test_sparse.py ----------------------------------


def test_selected_rows_to_dense_merges_duplicates():
    rows = np.array([1, 3, 1], np.int32)
    vals = np.array([[1.0, 2.0], [3.0, 4.0], [10.0, 20.0]], np.float32)
    sr = SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), 5)
    jsr = JSelectedRows(rows, vals, 5)
    np.testing.assert_array_equal(sr.to_dense().numpy(),
                                  np.asarray(jsr.to_dense()))
    expect = np.zeros((5, 2), np.float32)
    expect[1] = [11.0, 22.0]
    expect[3] = [3.0, 4.0]
    np.testing.assert_array_equal(sr.to_dense().numpy(), expect)
    uniq, merged = sr.merged()
    juniq, jmerged = jsr.merged()
    np.testing.assert_array_equal(uniq, juniq)
    np.testing.assert_array_equal(merged, jmerged)
    np.testing.assert_array_equal(uniq, [1, 3])


def _embedding_model(is_sparse, optimizer="sgd"):
    def fn(pkg):
        L, pt = pkg["L"], pkg["pt"]
        ids = L.data(name="ids", shape=[4], dtype="int64")
        y = L.data(name="y", shape=[1], dtype="float32")
        emb = L.embedding(ids, size=[50, 8], is_sparse=is_sparse,
                          param_attr=pt.ParamAttr(name="emb_w"))
        pred = L.fc(L.reduce_sum(emb, dim=1), size=1)
        loss = L.mean(L.square_error_cost(pred, y))
        opt = (pt.optimizer.SGD(0.1) if optimizer == "sgd"
               else pt.optimizer.Adam(0.01))
        opt.minimize(loss)
        return [loss, "emb_w"]
    return fn


def _embedding_feeds(steps=5):
    rng = np.random.default_rng(0)
    feed = {"ids": rng.integers(0, 50, (16, 4)).astype(np.int64),
            "y": rng.standard_normal((16, 1)).astype(np.float32)}
    return [feed] * steps


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_sparse_embedding_grad_matches_dense(optimizer):
    """is_sparse=True walks the dense trajectory (rtol 1e-5) in the port,
    and the JAX package's sparse trajectory; rows no id touched keep their
    startup bits under both optimizers."""
    feeds = _embedding_feeds()
    hist = {}
    for sparse in (False, True):
        jm, js, jf = build(J, _embedding_model(sparse, optimizer), seed=7)
        tm, ts, tf = build(T, _embedding_model(sparse, optimizer), seed=7)
        assert tm.to_dict() == jm.to_dict()
        jout, tout, jscope, tscope = run_both((jm, js), (tm, ts), feeds, jf, tf)
        hist[sparse] = ([float(t[0]) for t in tout], tout[-1][1])
        np.testing.assert_allclose([float(t[0]) for t in tout],
                                   [float(j[0]) for j in jout], rtol=1e-5)
        np.testing.assert_allclose(tout[-1][1], jout[-1][1], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(hist[True][0], hist[False][0], rtol=1e-5)
    np.testing.assert_allclose(hist[True][1], hist[False][1], rtol=1e-5,
                               atol=1e-6)
    assert hist[True][0][-1] < hist[True][0][0]
    untouched = np.setdiff1d(np.arange(50), feeds[0]["ids"])
    assert len(untouched)
    # run_both starts the port from the JAX startup's weights
    import paddle_tpu as jpt
    jm, js, _ = build(J, _embedding_model(True, optimizer), seed=7)
    jscope = jpt.Scope()
    jpt.Executor().run(js, scope=jscope)
    w0 = np.asarray(jscope.find_var("emb_w"))
    np.testing.assert_array_equal(hist[True][1][untouched], w0[untouched])


def test_sparse_grad_with_momentum_raises():
    """Momentum refuses a SelectedRows grad, as the JAX op does (the port's
    OpError names the op and carries the NotImplementedError)."""
    main, startup = tpt.Program(), tpt.Program()
    L = T["L"]
    with tpt.program_guard(main, startup):
        ids = L.data(name="ids", shape=[4], dtype="int64")
        emb = L.embedding(ids, size=[20, 4], is_sparse=True)
        loss = L.mean(L.reduce_sum(emb, dim=1))
        tpt.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    from paddle_tpu_torch.framework import OpError
    with pytest.raises(OpError, match="SelectedRows") as info:
        exe.run(main, feed={"ids": np.zeros((8, 4), np.int64)},
                fetch_list=[loss.name], scope=scope)
    assert isinstance(info.value.cause, NotImplementedError)


# -- the ops against the JAX ops -----------------------------------------------


def _ids(B=6, W=4, V=20, seed=1):
    return np.random.default_rng(seed).integers(0, V, (B, W)).astype(np.int64)


def _grad_program(padding_idx=None, mixed=False):
    """Two lookups of one table (the second dense where `mixed`), the grad
    of a weighted sum, and its row set through the SelectedRows layers:
    the raw values, the merged values and rows."""
    def fn(pkg):
        L, pt = pkg["L"], pkg["pt"]
        ids = L.data(name="ids", shape=[4], dtype="int64")
        ids2 = L.data(name="ids2", shape=[4], dtype="int64")
        c = L.data(name="c", shape=[4, 3], dtype="float32")
        attr = pt.ParamAttr(name="w")
        e1 = L.embedding(ids, size=[20, 3], is_sparse=True, param_attr=attr,
                         padding_idx=padding_idx)
        e2 = L.embedding(ids2, size=[20, 3], is_sparse=not mixed,
                         param_attr=attr)
        loss = L.mean(L.reduce_sum(L.elementwise_mul(e1, c) + e2 * e2,
                                   dim=1))
        pkg["bw"].append_backward(loss)
        g = pt.default_main_program().global_block.var("w@GRAD")
        if mixed:
            return [g]
        merged = L.merge_selected_rows(g)
        return [L.get_tensor_from_selected_rows(g),
                L.get_tensor_from_selected_rows(merged)]
    return fn


def _grad_feed():
    rng = np.random.default_rng(3)
    return {"ids": _ids(), "ids2": _ids(seed=2),
            "c": rng.standard_normal((6, 4, 3)).astype(np.float32)}


@pytest.mark.parametrize("padding_idx", [None, 5])
def test_sparse_lookup_grad_sum_and_merge_match_jax(padding_idx):
    """lookup_table's sparse grad (padding rows zeroed, kept), the `sum` of
    two lookups' SelectedRows (concatenated), merge_selected_rows and
    get_tensor_from_selected_rows: equal programs, values within 1e-6."""
    feed = _grad_feed()
    feed["ids"][0, :2] = 5
    jm, js, jf = build(J, _grad_program(padding_idx))
    tm, ts, tf = build(T, _grad_program(padding_idx))
    assert tm.to_dict() == jm.to_dict()
    jout, tout, _, _ = run_both((jm, js), (tm, ts), [feed], jf, tf)
    raw, merged = tout[0]
    assert raw.shape == (2 * 6 * 4, 3)     # K fixed: every lookup's row
    if padding_idx is not None:
        # backward sums the second lookup's rows first, then the first's,
        # whose first two ids are the padding index
        np.testing.assert_array_equal(raw[24:26], 0.0)
    for t, j in zip(tout[0], jout[0]):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    assert merged.shape[0] == len(np.unique(np.concatenate(
        [feed["ids"].ravel(), feed["ids2"].ravel()])))


def test_sparse_and_dense_lookups_of_one_table_sum_dense():
    """A SelectedRows summed with a dense grad densifies, as in the JAX
    op: the port's [V, W] grad within 1e-6 of the JAX package's."""
    feed = _grad_feed()
    jm, js, jf = build(J, _grad_program(mixed=True))
    tm, ts, tf = build(T, _grad_program(mixed=True))
    jout, tout, _, _ = run_both((jm, js), (tm, ts), [feed], jf, tf)
    assert tout[0][0].shape == (20, 3)
    np.testing.assert_allclose(tout[0][0], jout[0][0], rtol=1e-6, atol=1e-7)


def test_lookup_table_grad_rows_matches_jax():
    """The distributed table's row grad from Ids and Out@GRAD alone (the
    ops' computes called directly: the JAX package appends this op only
    through its transpiler): rows, values with the padding rows zeroed,
    and an empty row set where Out@GRAD never materialized."""
    import jax.numpy as jnp
    from paddle_tpu.ops.registry import ExecContext as JCtx
    from paddle_tpu.ops.registry import get_op_def as jdef
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    rng = np.random.default_rng(4)
    ids = _ids()[..., None]
    og = rng.standard_normal((6, 4, 3)).astype(np.float32)

    class Op:
        type = "lookup_table_grad_rows"
        inputs = {"Ids": ["ids"], "Out@GRAD": ["og"]}
        outputs = {"W@GRAD": ["g"]}
        attrs = {"height": 20, "padding_idx": 2}

    for with_grad in (True, False):
        tenv = {"ids": torch.from_numpy(ids)}
        jenv = {"ids": jnp.asarray(ids)}
        if with_grad:
            tenv["og"], jenv["og"] = torch.from_numpy(og), jnp.asarray(og)
        got = get_op_def(Op.type).compute(
            ExecContext(Op, tenv, torch.device("cpu")))["W@GRAD"]
        want = jdef(Op.type).compute(JCtx(Op, jenv))["W@GRAD"]
        assert got.height == want.height == 20
        np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
        assert got.rows.dtype == torch.int32
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))


def _update_op(pkg, op_type, sparse, state, rows, vals, lr, attrs):
    """Run `op_type` 3 times from `state` with the SelectedRows (rows,
    vals) as its Grad, through the package's op compute directly (the
    registry's ExecContext), and return the state after each step."""
    out = []
    for step in range(3):
        g_rows, g_vals = rows[step], vals[step]
        if pkg is T:
            from paddle_tpu_torch.ops.registry import ExecContext, get_op_def
            env = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
            env["grad"] = SelectedRows(torch.from_numpy(g_rows),
                                       torch.from_numpy(g_vals), 30)
            env["lr"] = torch.tensor([lr], dtype=torch.float32)
            ctx_dev = torch.device("cpu")
        else:
            from paddle_tpu.ops.registry import ExecContext, get_op_def
            import jax.numpy as jnp
            env = {k: jnp.asarray(v) for k, v in state.items()}
            env["grad"] = JSelectedRows(jnp.asarray(g_rows),
                                        jnp.asarray(g_vals), 30)
            env["lr"] = jnp.asarray([lr], jnp.float32)

        class Op:
            type = op_type
            inputs = {"Param": ["param"], "Grad": ["grad"],
                      "LearningRate": ["lr"],
                      **({"Moment1": ["m1"], "Moment2": ["m2"],
                          "Beta1Pow": ["b1p"], "Beta2Pow": ["b2p"]}
                         if op_type == "adam" else {})}
            outputs = {}
        Op.attrs = attrs
        if pkg is T:
            res = get_op_def(op_type).compute(ExecContext(Op, env, ctx_dev))
        else:
            res = get_op_def(op_type).compute(ExecContext(Op, env))
        names = {"ParamOut": "param", "Moment1Out": "m1", "Moment2Out": "m2",
                 "Beta1PowOut": "b1p", "Beta2PowOut": "b2p"}
        state = dict(state)
        for slot, v in res.items():
            state[names[slot]] = np.asarray(v)
        out.append(state)
    return out


@pytest.mark.parametrize("op_type", ["sgd", "adam"])
def test_sparse_update_ops_match_jax_over_three_steps(op_type):
    """sgd's row update and adam's lazy update on SelectedRows grads with
    duplicate rows, 3 steps against the JAX ops (rtol 1e-6); rows no step
    touched keep their bits in the parameter and in both moments, and the
    beta powers advance every step."""
    rng = np.random.default_rng(5)
    V, W = 30, 4
    state = {"param": rng.standard_normal((V, W)).astype(np.float32)}
    if op_type == "adam":
        state.update(m1=rng.standard_normal((V, W)).astype(np.float32) * 0.1,
                     m2=rng.random((V, W)).astype(np.float32) * 0.1,
                     b1p=np.array([0.9], np.float32),
                     b2p=np.array([0.999], np.float32))
    rows = [rng.integers(0, 20, 12).astype(np.int32) for _ in range(3)]
    vals = [rng.standard_normal((12, W)).astype(np.float32) for _ in range(3)]
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    got = _update_op(T, op_type, True, state, rows, vals, 0.05, attrs)
    want = _update_op(J, op_type, True, state, rows, vals, 0.05, attrs)
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    untouched = np.setdiff1d(np.arange(V), np.concatenate(rows))
    assert len(untouched) >= 10
    for k in ("param", "m1", "m2"):
        if k in state:
            np.testing.assert_array_equal(got[-1][k][untouched],
                                          state[k][untouched], err_msg=k)
    if op_type == "adam":
        np.testing.assert_allclose(got[-1]["b1p"], [0.9 ** 4], rtol=1e-6)


@pytest.mark.parametrize("op_type", [
    "momentum", "adamax", "adagrad", "decayed_adagrad", "adadelta",
    "rmsprop", "ftrl", "lamb", "lars_momentum", "dgc"])
def test_other_update_ops_refuse_a_selected_rows_grad(op_type):
    """Every update op but sgd and adam raises NotImplementedError on a
    SelectedRows, with the JAX `_reject_sparse` message's sense."""
    from paddle_tpu_torch.ops.registry import ExecContext, get_op_def

    class Op:
        type, outputs, attrs = op_type, {}, {}
        inputs = {"Grad": ["g"], "Param": ["p"]}

    env = {"g": SelectedRows(torch.zeros(2, dtype=torch.int32),
                             torch.ones(2, 3), 5), "p": torch.ones(5, 3)}
    with pytest.raises(NotImplementedError,
                       match="use SGD for is_sparse embeddings"):
        get_op_def(op_type).compute(ExecContext(Op, env, torch.device("cpu")))


# -- the models --------------------------------------------------------------


def _w2v(optimizer):
    def fn(pkg):
        from importlib import import_module

        w2v = import_module(pkg["pt"].__name__ + ".models.word2vec")
        loss, _, _ = w2v.word2vec(is_sparse=True)
        opt = (pkg["pt"].optimizer.SGD(0.1) if optimizer == "sgd"
               else pkg["pt"].optimizer.Adam(1e-3))
        opt.minimize(loss)
        return [loss] + [p.name for p in
                         pkg["pt"].default_main_program().all_parameters()]
    return fn


def _w2v_feeds(B=32):
    rng = np.random.default_rng(0)
    return [{**{f"w{i}": rng.integers(0, 2000, (B, 1)).astype(np.int64)
                for i in range(4)},
             "next_word": rng.integers(0, 2000, (B, 1)).astype(np.int64)}
            for _ in range(3)]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_sparse_word2vec_matches_jax_over_three_steps(optimizer):
    """word2vec with is_sparse=True: the shared table's grad is the four
    lookups' SelectedRows concatenated by backward's `sum`s (4 x 32 rows,
    height 2000); programs equal, 3 steps
    whose losses agree within 1e-5 and whose parameters agree within 1e-5
    of their max-abs (sgd) or 2 lr (adam: a step moves a weight by about
    lr whatever its gradient's size)."""
    fn, feeds = _w2v(optimizer), _w2v_feeds()
    jm, js, jf = build(J, fn)
    tm, ts, tf = build(T, fn)
    assert tm.to_dict() == jm.to_dict()
    sums = [op for op in tm.global_block.ops if op.type == "sum"
            and op.outputs["Out"] == ["shared_w@GRAD"]]
    assert len(sums) == 3        # the four lookups' grads, summed in turn
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(ts, scope=scope)
    (g,) = exe.run(tm, feed=feeds[0], fetch_list=["shared_w@GRAD"],
                   scope=scope)
    assert isinstance(g, SelectedRows) and g.height == 2000
    assert g.values.shape == (4 * 32, 32)
    np.testing.assert_array_equal(np.sort(g.rows), np.sort(np.concatenate(
        [feeds[0][f"w{i}"].ravel() for i in range(4)])))
    jout, tout, _, _ = run_both((jm, js), (tm, ts), feeds, jf, tf)
    tol = 1e-5 if optimizer == "sgd" else None
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(float(t[0]), float(j[0]), rtol=1e-5)
        for a, b, n in zip(t[1:], j[1:], jf[1:]):
            lim = tol * np.abs(b).max() if tol else 2e-3
            assert np.abs(a - b).max() <= lim, n
    assert float(tout[-1][0]) != float(tout[0][0])
