"""The port's RecomputeOptimizer (optimizer.py, the `recompute` op and its
replayed grad) held against the JAX package's and against plain training:
the four cases of tests/test_recompute.py on the port, each rewritten
program equal to the JAX package's through to_dict(), bert_tiny's too,
fp32 and under bf16 AMP (decorate inside RecomputeOptimizer, as
tools/_sweep.py's SWEEP_RECOMPUTE arm builds it).

A recompute step runs the same forward ops as the plain step, so its loss
is the plain step's bit for bit; its gradients come from autograd through
the replayed segment instead of the registered grad ops, so they agree
within fp32 rounding (1e-5 of each gradient's max-abs), or under AMP within
the bf16 band of tests/test_torch_amp.py (3e-2 relative L2).
"""
import numpy as np
import pytest

from torch_parity import J, T, build, run_both

import paddle_tpu_torch as tpt
from paddle_tpu_torch.contrib import mixed_precision as tamp
from paddle_tpu.contrib import mixed_precision as jamp

from __graft_entry__ import _example_feed


def _mlp(use_rc, dropout=0.0):
    def fn(pkg):
        L, pt = pkg["L"], pkg["pt"]
        x = L.data(name="x", shape=[16], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h1 = L.fc(x, size=32, act="relu", name="h1")
        if dropout:
            h1 = L.dropout(h1, dropout_prob=dropout)
        h2 = L.fc(h1, size=32, act="relu", name="h2")
        h3 = L.fc(h2, size=32, act="relu", name="h3")
        loss = L.mean(L.square_error_cost(L.fc(h3, size=1, name="p"), y))
        if use_rc:
            opt = pt.optimizer.RecomputeOptimizer(pt.optimizer.Adam(0.01))
            opt._set_checkpoints([h1, h2, h3])
        else:
            opt = pt.optimizer.Adam(0.01)
        opt.minimize(loss)
        return [loss]
    return fn


def _mlp_feeds():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((6, 32, 16)).astype(np.float32)
    w = rng.standard_normal((16, 1)).astype(np.float32)
    return [{"x": x, "y": x @ w} for x in xs]


def test_recompute_matches_plain_training():
    """Six Adam steps: the recompute program's losses equal the JAX
    package's recompute program's and the port's plain program's."""
    feeds = _mlp_feeds()
    jm, js, jf = build(J, _mlp(True), seed=11)
    tm, ts, tf = build(T, _mlp(True), seed=11)
    assert tm.to_dict() == jm.to_dict()
    jout, tout, _, _ = run_both((jm, js), (tm, ts), feeds, jf, tf)
    pm, ps, pf = build(T, _mlp(False), seed=11)
    _, plain, _, _ = run_both((jm, js), (pm, ps), feeds, jf, pf)
    rc = [float(o[0]) for o in tout]
    np.testing.assert_allclose(rc, [float(o[0]) for o in jout], rtol=1e-5)
    np.testing.assert_allclose(rc, [float(o[0]) for o in plain], rtol=1e-5)
    assert rc[0] == float(plain[0][0])


def test_recompute_program_structure():
    main, _, _ = build(T, _mlp(True), seed=11)
    blk = main.global_block
    assert sum(op.type == "recompute" for op in blk.ops) >= 2
    rec = next(op for op in blk.ops if op.type == "recompute")
    sub = main.blocks[rec.attrs["sub_block"]]
    assert any(op.type == "mul" for op in sub.ops)
    assert any(op.type == "recompute_grad" for op in blk.ops)


def test_recompute_rejects_rng_ops_in_segment():
    with pytest.raises(ValueError, match="RNG"):
        build(T, _mlp(True, dropout=0.5), seed=11)


def _bert(amp, use_rc):
    def fn(pkg):
        from importlib import import_module

        tr = import_module(pkg["pt"].__name__ + ".models.transformer")
        cfg = tr.bert_tiny(use_tp=False)
        avg_loss, _ = tr.bert_pretrain(cfg, seq_len=16)
        opt = pkg["pt"].optimizer.Adam(1e-3)
        if amp:
            opt = (jamp if pkg is J else tamp).decorate(opt)
        if use_rc:
            opt = pkg["pt"].optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(list(tr.last_layer_outputs))
        opt.minimize(avg_loss)
        main = pkg["pt"].default_main_program()
        return [avg_loss] + [p.name + "@GRAD" for p in main.all_parameters()]
    return fn


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_recompute_transformer_layer_checkpoints(amp):
    """bert_tiny with each layer's output a checkpoint: one recompute op a
    layer, the program equal to the JAX package's; step 1 from the JAX
    startup's weights: the loss bit for bit the port's plain step's and
    within 1e-5 of the JAX recompute step's, every gradient against the
    plain step's; the loss falls over 8 steps."""
    from paddle_tpu_torch.models import transformer

    jm, js, jf = build(J, _bert(amp, True), seed=3)
    tm, ts, tf = build(T, _bert(amp, True), seed=3)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert sum(op.type == "recompute" for op in tm.global_block.ops) == \
        transformer.bert_tiny(use_tp=False).num_layers
    pm, ps, pf = build(T, _bert(amp, False), seed=3)
    feed = _example_feed(transformer.bert_tiny(use_tp=False), 4, 16)
    jout, tout, _, tscope = run_both((jm, js), (tm, ts), [feed] * 8, jf, tf)
    _, plain, _, _ = run_both((jm, js), (pm, ps), [feed], jf, pf)
    assert np.asarray(tout[0][0]).tobytes() == np.asarray(plain[0][0]).tobytes()
    np.testing.assert_allclose(float(tout[0][0]), float(jout[0][0]),
                               rtol=1e-5 if not amp else 5e-3)
    for g, p, n in zip(tout[0][1:], plain[0][1:], tf[1:]):
        if amp:
            d = np.linalg.norm(g - p) / max(np.linalg.norm(p), 1e-30)
            assert d <= 3e-2, (n, d)
        else:
            np.testing.assert_allclose(
                g, p, rtol=1e-5, atol=1e-5 * max(np.abs(p).max(), 1e-30),
                err_msg=n)
    losses = [float(o[0]) for o in tout]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_recompute_refuses_a_segment_without_autograd_function():
    """A segment holding the cross entropy (K6/K7 have no
    torch.autograd.Function yet) is refused at the rewrite, naming the
    roadmap item."""
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="int64")
        h = L.fc(x, size=8, act="relu")
        ce = L.softmax_with_cross_entropy(L.fc(h, size=4), y)
        loss = L.mean(L.scale(ce, scale=2.0))
        opt = pkg["pt"].optimizer.RecomputeOptimizer(
            pkg["pt"].optimizer.SGD(0.1))
        opt._set_checkpoints([ce])
        with pytest.raises(NotImplementedError, match="control flow"):
            opt.minimize(loss)

    build(T, fn)
