"""The port's RecomputeOptimizer (optimizer.py, the `recompute` op and its
replayed grad) held against the JAX package's and against plain training:
the four cases of tests/test_recompute.py on the port, each rewritten
program equal to the JAX package's through to_dict(), bert_tiny's too,
fp32 and under bf16 AMP (decorate inside RecomputeOptimizer, as
tools/_sweep.py's SWEEP_RECOMPUTE arm builds it); segments holding the
cross entropy (a small net and bert_tiny's head) and resnet_cifar10's batch
norms, whose replays run `_XentFn` and `_BatchNormFn`, and those Functions
against plain torch autograd; an op autograd cannot see through is refused
in its replay.

A recompute step runs the same forward ops as the plain step, so its loss
is the plain step's bit for bit; its gradients come from autograd through
the replayed segment instead of the registered grad ops, so they agree
within fp32 rounding (1e-5 of each gradient's max-abs), or under AMP within
the bf16 band of tests/test_torch_amp.py (3e-2 relative L2).
"""
import numpy as np
import pytest
import torch

from torch_parity import J, T, build, run_both

import paddle_tpu_torch as tpt
from paddle_tpu import flags as jflags
from paddle_tpu_torch.contrib import mixed_precision as tamp
from paddle_tpu_torch.ops.registry import register_op
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


@register_op("opaque_double_for_test")
def _opaque_double(ctx):
    """2 X through a path autograd cannot see, as a kernel called through
    ctypes without a torch.autograd.Function would be."""
    return {"Out": ctx.input("X").detach() * 2.0}


def test_recompute_refuses_a_segment_without_autograd_function():
    """A segment holding an op whose compute autograd cannot see through
    (and that registers no grad of its own) is refused when the segment's
    replay runs: the gradient of the segment's inputs would otherwise come
    out zero silently."""
    main, startup, (loss,) = build(T, lambda pkg: _opaque_net(pkg))
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((4, 8)).astype(np.float32),
            "y": rng.integers(0, 4, (4, 1)).astype(np.int64)}
    with pytest.raises(RuntimeError, match="has no autograd path"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def _opaque_net(pkg):
    L = pkg["L"]
    x = L.data(name="x", shape=[8], dtype="float32")
    h = L.fc(x, size=8, act="relu")
    block = pkg["pt"].default_main_program().global_block
    d = block.create_var(name="doubled", shape=[-1, 8], dtype="float32")
    block.append_op("opaque_double_for_test", {"X": [h.name]}, {"Out": [d.name]})
    h2 = L.fc(d, size=8, act="relu")
    loss = L.mean(L.fc(h2, size=1))
    opt = pkg["pt"].optimizer.RecomputeOptimizer(pkg["pt"].optimizer.SGD(0.1))
    opt._set_checkpoints([h2])
    opt.minimize(loss)
    return [loss]


def _xent_net(use_rc):
    """fc-relu-fc, the hard-label cross entropy (K6/K7) and its scaled
    mean; under recompute the cross entropy's output is a checkpoint, so
    the segment before it holds the cross entropy."""
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="int64")
        h = L.fc(x, size=8, act="relu")
        ce = L.softmax_with_cross_entropy(L.fc(h, size=4), y)
        loss = L.mean(L.scale(ce, scale=2.0))
        opt = pkg["pt"].optimizer.SGD(0.1)
        if use_rc:
            opt = pkg["pt"].optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([ce])
        opt.minimize(loss)
        main = pkg["pt"].default_main_program()
        return [loss] + [p.name + "@GRAD" for p in main.all_parameters()]
    return fn


def test_recompute_segment_holding_the_cross_entropy_matches_jax():
    """The segment is replayed through `_XentFn` (K6 forward, K7 backward
    from K6's saved statistics): 3 SGD steps whose losses and gradients
    agree with the JAX package's recompute program (1e-5) and equal the
    port's plain step's losses bit for bit at step 1."""
    jm, js, jf = build(J, _xent_net(True))
    tm, ts, tf = build(T, _xent_net(True))
    assert tm.to_dict() == jm.to_dict()
    sub = tm.blocks[next(op for op in tm.global_block.ops
                         if op.type == "recompute").attrs["sub_block"]]
    assert "softmax_with_cross_entropy" in [op.type for op in sub.ops]
    rng = np.random.default_rng(0)
    feeds = [{"x": rng.standard_normal((6, 8)).astype(np.float32),
              "y": rng.integers(0, 4, (6, 1)).astype(np.int64)}
             for _ in range(3)]
    jout, tout, _, _ = run_both((jm, js), (tm, ts), feeds, jf, tf)
    pm, ps, pf = build(T, _xent_net(False))
    _, plain, _, _ = run_both((jm, js), (pm, ps), feeds[:1], jf, pf)
    assert np.asarray(tout[0][0]).tobytes() == np.asarray(plain[0][0]).tobytes()
    for j, t in zip(jout, tout):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(tout[0], plain[0]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _bert_xent_segment(use_rc):
    """bert_tiny with each layer's output and the masked-LM cross entropy's
    per-token loss as checkpoints: the head (lm_head fc, cross entropy) is
    a segment of its own."""
    def fn(pkg):
        from importlib import import_module

        tr = import_module(pkg["pt"].__name__ + ".models.transformer")
        avg_loss, _ = tr.bert_pretrain(tr.bert_tiny(use_tp=False), seq_len=16)
        main = pkg["pt"].default_main_program()
        opt = pkg["pt"].optimizer.Adam(1e-3)
        if use_rc:
            ce = [op.outputs["Loss"][0] for op in main.global_block.ops
                  if op.type == "softmax_with_cross_entropy"]
            opt = pkg["pt"].optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(list(tr.last_layer_outputs) + ce)
        opt.minimize(avg_loss)
        return [avg_loss] + [p.name + "@GRAD" for p in main.all_parameters()]
    return fn


def test_recompute_bert_segment_holding_the_cross_entropy():
    """Step 1 from the JAX startup's weights: the loss bit for bit the
    port's plain step's and within 1e-5 of the JAX recompute step's, every
    gradient within 1e-5 of its max-abs of the plain step's; the program
    equal to the JAX package's."""
    from paddle_tpu_torch.models import transformer

    jm, js, jf = build(J, _bert_xent_segment(True))
    tm, ts, tf = build(T, _bert_xent_segment(True))
    assert tm.to_dict() == jm.to_dict()
    segs = [tm.blocks[op.attrs["sub_block"]] for op in tm.global_block.ops
            if op.type == "recompute"]
    assert any(op.type == "softmax_with_cross_entropy"
               for b in segs for op in b.ops)
    pm, ps, pf = build(T, _bert_xent_segment(False))
    feed = _example_feed(transformer.bert_tiny(use_tp=False), 4, 16)
    jout, tout, _, _ = run_both((jm, js), (tm, ts), [feed], jf, tf)
    _, plain, _, _ = run_both((jm, js), (pm, ps), [feed], jf, pf)
    assert np.asarray(tout[0][0]).tobytes() == np.asarray(plain[0][0]).tobytes()
    np.testing.assert_allclose(float(tout[0][0]), float(jout[0][0]), rtol=1e-5)
    for g, p, n in zip(tout[0][1:], plain[0][1:], tf[1:]):
        np.testing.assert_allclose(
            g, p, rtol=1e-5, atol=1e-5 * max(np.abs(p).max(), 1e-30),
            err_msg=n)


def _cifar_rc(use_rc):
    """resnet_cifar10 under Momentum(0.01, 0.9); under recompute with each
    basic block's output (its relu after the residual add) a checkpoint,
    so every batch norm lies in a segment."""
    def fn(pkg):
        from importlib import import_module

        rn = import_module(pkg["pt"].__name__ + ".models.resnet")
        loss, _, _ = rn.resnet_cifar10()
        main = pkg["pt"].default_main_program()
        ops = main.global_block.ops
        writer = {n: op for op in ops for n in op.output_names}
        checkpoints = [op.outputs["Out"][0] for op in ops if op.type == "relu"
                       and writer[op.inputs["X"][0]].type == "elementwise_add"]
        opt = pkg["pt"].optimizer.Momentum(0.01, 0.9)
        if use_rc:
            opt = pkg["pt"].optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(checkpoints)
        opt.minimize(loss)
        stats = sorted(n for n in main.global_block.vars
                       if n.endswith(".mean") or n.endswith(".var"))
        return [loss] + stats
    return fn


@pytest.fixture
def _resnet_flags():
    saved_j = {k: jflags.get_flag(k) for k in ("conv_implicit_gemm",
                                               "pallas_epilogue")}
    jflags.set_flags({"conv_implicit_gemm": "off", "pallas_epilogue": "on"})
    yield
    jflags.set_flags(saved_j)


def test_recompute_resnet_cifar10_matches_jax(_resnet_flags):
    """Two Momentum steps of resnet_cifar10 under recompute (every
    conv2d_bn inside a segment, replayed through `_BatchNormFn`: K8, K9 in
    its chain mode): the program equal to the JAX package's; losses (rtol
    1e-5), parameters (1e-4 of their max-abs) and running statistics (1e-4
    relative, 1e-5 absolute) against the JAX recompute run, as
    tests/test_torch_resnet.py holds the plain step; against the port's
    plain run the losses and running statistics bit for bit (the replays'
    statistics are discarded: they move once a step)."""
    jm, js, jf = build(J, _cifar_rc(True))
    tm, ts, tf = build(T, _cifar_rc(True))
    assert tm.to_dict() == jm.to_dict()
    segs = [tm.blocks[op.attrs["sub_block"]] for op in tm.global_block.ops
            if op.type == "recompute"]
    assert sum(op.type == "conv2d_bn" for b in segs for op in b.ops) == 21
    rng = np.random.default_rng(0)
    feeds = [{"img": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
              "label": rng.integers(0, 10, (4, 1)).astype(np.int64)}
             for _ in range(2)]
    jout, tout, jscope, tscope = run_both((jm, js), (tm, ts), feeds, jf, tf)
    pm, ps, pf = build(T, _cifar_rc(False))
    _, plain, _, _ = run_both((jm, js), (pm, ps), feeds, jf, pf)
    for j, t, p in zip(jout, tout, plain):
        np.testing.assert_allclose(float(t[0]), float(j[0]), rtol=1e-5)
        for a, b in zip(t[1:], j[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        for a, b in zip(t, p):
            np.testing.assert_array_equal(a, b)
    for prm in jm.all_parameters():
        want = np.asarray(jscope.find_var(prm.name))
        got = tscope.find_var(prm.name).numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), prm.name


# -- the replay Functions against plain torch autograd -----------------------


@pytest.mark.parametrize("mode", ["cl", "cr"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_batch_norm_function_matches_autograd(mode, training):
    """`_BatchNormFn` (K8 with K9 as its backward) against autograd through
    the apply's plain version with the statistics computed in torch: in
    training (K9's chain mode) the statistics come in detached and the
    chain is K9's; in test mode mean and inv take their gradients from K9's
    sums. fp32, 1e-5 of each gradient's max-abs."""
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_act_plain
    from paddle_tpu_torch.ops.nn_ops import _BatchNormFn, _batch_stats

    rng = np.random.default_rng(3)
    R, row, C = (24, 6, 6) if mode == "cl" else (12, 10, 4)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(  # noqa: E731
        np.float32)).requires_grad_()
    x2, res2, dy = t(R, row), t(R, row), t(R, row)
    scale, bias = t(C), t(C)
    rmean = t(C)
    rvar = torch.from_numpy(rng.random(C).astype(np.float32) + 0.5
                            ).requires_grad_()

    def stats(x, detach):
        if not training:
            return rmean, 1.0 / torch.sqrt(rvar + 1e-5)
        m, v = _batch_stats(x.detach() if detach else x, mode, C)
        return m, 1.0 / torch.sqrt(v + 1e-5)

    m, inv = stats(x2, True)
    got = _BatchNormFn.apply(x2, scale, bias, m, inv, res2, "relu", mode,
                             R * row // C if training else None)
    m, inv = stats(x2, False)
    want = bn_apply_act_plain(x2, scale, bias, m, inv, "relu", res2, mode)
    leaves = [x2, scale, bias, res2] + ([] if training else [rmean, rvar])
    g_got = torch.autograd.grad((got * dy).sum(), leaves)
    g_want = torch.autograd.grad((want * dy).sum(), leaves)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for a, b in zip(g_got, g_want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_xent_function_matches_autograd():
    """`_XentFn` (K6 forward, K7 backward from the saved statistics) with
    cotangents on the loss and on the logsumexp (the Softmax output's
    path) against autograd through log_softmax. fp32, 1e-5."""
    from paddle_tpu_torch.ops.nn_ops import _XentFn

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)
                         ).requires_grad_()
    lbl = torch.from_numpy(rng.integers(0, 7, 5).astype(np.int32))
    gl, gm = (torch.from_numpy(rng.standard_normal(5).astype(np.float32))
              for _ in range(2))
    loss, mlse = _XentFn.apply(x, lbl)
    lse = torch.logsumexp(x, dim=-1)
    want = lse - x.gather(1, lbl.long()[:, None])[:, 0]
    torch.testing.assert_close(loss, want)
    torch.testing.assert_close(mlse, lse)
    (g,) = torch.autograd.grad((loss * gl).sum() + (mlse * gm).sum(), [x])
    (w,) = torch.autograd.grad((want * gl).sum() + (lse * gm).sum(), [x])
    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
