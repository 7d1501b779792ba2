"""Batch statistics, random draws and ZeRO-1 resharding under the port's
with_data_parallel, on gloo CPU ranks (tests/torch_rank_pool.py), against
the JAX package's GSPMD run on its virtual CPU mesh and the port's own
one-process run; and K9's split mode and the batch norm's statistics
cotangents, plainly, against the JAX functions.

Every data-parallel hold runs on shards that differ in distribution (rank
1's rows scaled by 3 and shifted by 1), where a batch norm's local and
global statistics are far apart: the planted local-statistics variant and
the planted per-rank draw must fail the holds that the port passes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu import flags as jflags
from paddle_tpu.ops.pallas_kernels import epilogue as ep
from paddle_tpu.parallel import make_mesh as jmesh
import paddle_tpu_torch as tpt
from paddle_tpu_torch.ops import cuda_kernels as ck

import torch_dp_cases as cases
from torch_rank_pool import RankPool
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _uneven(a, n=2):
    """Rank n-1's share of the global batch `a` scaled by 3 and shifted by
    1: the shards differ in distribution."""
    a = a.copy()
    k = a.shape[0] // n
    a[(n - 1) * k:] = a[(n - 1) * k:] * 3.0 + 1.0
    return a


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-12)


# -- synced batch statistics -------------------------------------------------

SYNC_FEEDS = {
    "resnet": lambda rng, B: {
        "img": _uneven(rng.standard_normal((B, 3, 16, 16)).astype(np.float32)),
        "label": rng.integers(0, 10, (B, 1)).astype(np.int64)},
    "conv_bn": lambda rng, B: {
        "img": _uneven(rng.standard_normal((B, 2, 6, 6)).astype(np.float32)),
        "y": rng.standard_normal((B, 1)).astype(np.float32)},
}


def _jax_sync_bn(model, feeds):
    """The JAX package's with_data_parallel run over 2 virtual devices:
    (losses, params, running statistics, the startup's persistables)."""
    saved = jflags.get_flag("conv_implicit_gemm")
    jflags.set_flags({"conv_implicit_gemm": "off"})
    try:
        main, startup, loss = cases.sync_bn_programs(jpt, model)
        scope, exe = jpt.Scope(), jpt.Executor()
        exe.run(startup, scope=scope)
        init = {v.name: np.asarray(scope.find_var(v.name))
                for v in startup.list_vars()
                if scope.find_var(v.name) is not None}
        target = jpt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=jmesh({"dp": 2}))
        losses = [float(np.asarray(exe.run(target, feed=f, scope=scope,
                                           fetch_list=[loss.name])[0])
                       .reshape(-1)[0]) for f in feeds]
        params = {p.name: np.asarray(scope.find_var(p.name))
                  for p in main.all_parameters()}
        stats = {s: np.asarray(scope.find_var(s))
                 for s in cases.bn_stat_names(main)}
    finally:
        jflags.set_flags({"conv_implicit_gemm": saved})
    return losses, params, stats, init


def _sync_bn_misses(got, want, init):
    """What of the port's run falls outside test_torch_resnet.py's bounds
    against the JAX run: losses and running statistics at rtol 1e-4 (atol
    1e-5), each parameter's update over the steps within 0.1 in relative
    L2 (the bound that file takes where a relu decision within rounding
    of zero flips between packages) or within 1e-6 of it (the bias of a
    layer that feeds a batch norm has a zero gradient: its update is
    rounding in both packages)."""
    jl, jp, js = want
    misses = []
    if not np.allclose(got["losses"], jl, rtol=1e-4, atol=1e-5):
        misses.append(("losses", got["losses"], jl))
    for n, w in js.items():
        if not np.allclose(got["stats"][n], w, rtol=1e-4, atol=1e-5):
            misses.append((n, float(np.abs(got["stats"][n] - w).max())))
    for n, w in jp.items():
        upd, want_upd = got["params"][n] - init[n], w - init[n]
        d = _rel_l2(upd, want_upd)
        if not (d <= 0.1 or float(np.abs(upd - want_upd).max()) <= 1e-6):
            misses.append((n, d))
    return misses


@pytest.mark.parametrize("model", ["resnet", "conv_bn"])
def test_sync_batch_norm_follows_jax_gspmd_at_two_ranks(pool, model):
    """resnet_cifar10 (every batch norm a conv2d_bn) and a conv +
    batch_norm + data_norm network, 2 Momentum steps under
    with_data_parallel on 2 ranks: losses, parameters and running
    statistics follow the JAX GSPMD run, whose statistics are the global
    batch's; the ranks agree bit for bit. With the allreduces of the sync
    skipped (each rank's own statistics) the same holds fail."""
    rng = np.random.default_rng(3)
    feeds = [SYNC_FEEDS[model](rng, 8)] * 2
    jl, jp, js, init = _jax_sync_bn(model, feeds)
    outs = pool.run(2, cases.sync_bn_rank, model, init, feeds)
    want = (jl, jp, js)
    for o in outs:
        assert not _sync_bn_misses(o, want, init)
        assert o["synced"] and set(o["synced"]) <= {
            "batch_norm", "conv2d_bn", "batch_norm_grad", "conv2d_bn_grad"}
    for n in outs[0]["params"]:
        assert np.array_equal(outs[0]["params"][n], outs[1]["params"][n]), n
    local = pool.run(2, cases.sync_bn_rank, model, init, feeds,
                     "local_stats")[0]
    misses = {m[0] for m in _sync_bn_misses(local, want, init)}
    assert "losses" in misses and set(js) <= misses, sorted(misses)


def test_sync_batch_norm_at_two_ranks_is_the_one_process_step(pool):
    """The port against itself: 2 ranks under with_data_parallel against
    one process on the global batch, conv_bn network, 2 steps; losses,
    parameters and statistics within fp32 reordering (rtol 1e-5)."""
    rng = np.random.default_rng(4)
    feeds = [SYNC_FEEDS["conv_bn"](rng, 8)] * 2
    _, _, _, init = _jax_sync_bn("conv_bn", feeds[:0])
    one = pool.run(1, cases.sync_bn_rank, "conv_bn", init, feeds)[0]
    two = pool.run(2, cases.sync_bn_rank, "conv_bn", init, feeds)[0]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    for key in ("params", "stats"):
        for n, w in one[key].items():
            np.testing.assert_allclose(two[key][n], w, rtol=1e-5, atol=1e-6,
                                       err_msg=n)


# -- random draws ------------------------------------------------------------

def _draws_feed(B=8, seed=5):
    rng = np.random.default_rng(seed)
    return {"x": _uneven(rng.standard_normal((B, 8)).astype(np.float32)),
            "img": rng.standard_normal((B, 3, 6, 6)).astype(np.float32),
            "seq": rng.standard_normal((B, 5, 4)).astype(np.float32),
            "label": rng.integers(0, 20, (B, 1)).astype(np.int64)}


def test_random_draws_at_two_ranks_are_the_one_process_rows(pool):
    """dropout, both *_batch_size_like draws, sampling_id, random_crop,
    nce, sampled softmax and cudnn_lstm's inter-layer dropout under
    with_data_parallel on 2 ranks: every output, gathered over the ranks,
    is the one-process run's bit for bit (each rank draws the global
    batch's numbers and keeps its rows). Drawing each rank's own rows
    instead changes them."""
    feed = _draws_feed()
    main, startup, out = cases.draws_program(tpt)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    want = dict(zip(out, (np.asarray(v) for v in exe.run(
        main, feed=feed, fetch_list=list(out.values()), scope=scope))))
    for got in pool.run(2, cases.draws_rank, feed):
        for k, w in want.items():
            assert got[k].shape == w.shape and np.array_equal(got[k], w), k
    per_rank = pool.run(2, cases.draws_rank, feed, "per_rank_draw")[0]
    differ = {k for k, w in want.items() if not np.array_equal(per_rank[k], w)}
    assert differ == set(want) - {"nce"} or differ == set(want), differ


def test_dropout_keep_rate_follows_the_jax_op_law():
    """The port's dropout mask and the JAX op's keep 1 - p of the elements,
    each within 5 sigma of the binomial law (the two streams differ)."""
    p, shape = 0.3, (64, 256)
    x = np.ones(shape, np.float32)
    rates = {}
    for name, pkg, exe in (("port", tpt, tpt.Executor(place="cpu")),
                           ("jax", jpt, jpt.Executor())):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = 9
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            from importlib import import_module

            L = import_module(pkg.__name__ + ".layers")
            xv = L.data(name="x", shape=[shape[1]], dtype="float32")
            d = L.dropout(xv, dropout_prob=p)
        (dv,) = exe.run(main, feed={"x": x}, fetch_list=[d],
                        scope=pkg.Scope())
        rates[name] = float((np.asarray(dv) != 0).mean())
    sigma = (p * (1 - p) / x.size) ** 0.5
    for name, r in rates.items():
        assert abs(r - (1 - p)) <= 5 * sigma, (name, r)


# -- ZeRO-1 resharding on load -----------------------------------------------

def test_zero1_checkpoint_of_two_ranks_loads_at_one_and_four(pool, tmp_path):
    """Adam under with_data_parallel and sharded_optimizer_states at 2
    ranks, saved; loaded at 1 rank each moment is the two shards joined,
    bit for bit, and at 4 ranks the four ranks' rows joined are the same
    bits; one more step from the load at 1 rank follows the step the
    2-rank run took within the allreduce's rounding."""
    rng = np.random.default_rng(1)
    x = _uneven(rng.standard_normal((16, 16)).astype(np.float32))
    feeds = [{"x": x, "y": (x @ rng.standard_normal((16, 1))).astype(
        np.float32)}] * 3
    spec = dict(model="mlp", mode="dp_zero1", opt="adam", lr=1e-2,
                sizes=(8,))
    main, startup, _, _ = cases.programs(tpt, spec, 1)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    params = {p.name: np.asarray(scope.find_var(p.name))
              for p in main.all_parameters()}
    d = str(tmp_path / "ck")
    saved = pool.run(2, cases.reshard_rank, spec, params, feeds, d, "save")
    rows = {v.name: v.shape[0] for v in main.list_vars() if v.shape}
    sharded = {n for n, a in saved[0][0].items()
               if a.shape and a.shape[0] * 2 == rows[n]}
    assert sharded, "no optimizer state was held as ZeRO-1 shards"
    joined = {n: np.concatenate([saved[0][0][n], saved[1][0][n]])
              if n in sharded else saved[0][0][n] for n in saved[0][0]}
    one = pool.run(1, cases.reshard_rank, spec, params, feeds, d, "load")[0]
    for n, w in joined.items():
        assert np.array_equal(one[0][n], w), n
    for n, w in saved[0][1].items():
        np.testing.assert_allclose(one[1][n], w, rtol=1e-6, atol=1e-7,
                                   err_msg=n)
    four = pool.run(4, cases.reshard_rank, spec, params, feeds, d, "load")
    for n in sharded:
        parts = [f[0][n] for f in four]
        got = (np.concatenate(parts) if parts[0].shape[0] * 4 == rows[n]
               else parts[0])
        assert np.array_equal(got, joined[n]), n


# -- K9's split mode, and the statistics' cotangents --------------------------

K9_CASES = [((4, 5, 3, 6), True, "identity", False),
            ((4, 5, 3, 6), True, "relu", True),
            ((4, 6, 3, 5), False, "identity", False),
            ((4, 6, 3, 5), False, "relu", True)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,channel_last,act,residual", K9_CASES,
                         ids=["cl", "cl_relu_res", "cr", "cr_relu_res"])
def test_split_k9_plain_is_the_one_launch_and_the_jax_vjp(
        monkeypatch, shape, channel_last, act, residual):
    """Sums then chain (plain versions): on all rows, the one launch's
    chain bit for bit; on two halves of the batch with their sums added
    and the global M, the same dx within fp32 reordering; and against
    jax.vjp of the training batch norm (statistics of x, then the JAX
    bn_apply_act kernel in interpret mode) within 1e-4."""
    monkeypatch.setattr(ep, "INTERPRET", True)
    rng = np.random.default_rng(21)
    C = shape[-1] if channel_last else shape[1]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(C)).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32) if residual else None
    axes = tuple(i for i in range(4) if i != (3 if channel_last else 1))
    mean = x.mean(axis=axes)
    inv = (1.0 / np.sqrt((x * x).mean(axis=axes) - mean * mean + 1e-5)
           ).astype(np.float32)
    mode = "cl" if channel_last else "cr"

    def rows(a):
        return None if a is None else (_t(a).reshape(-1, C) if channel_last
                                       else _t(a).reshape(-1, a.shape[2]
                                                          * a.shape[3]))

    p = (_t(scale), _t(bias), _t(mean), _t(inv))
    M = x.size // C
    one = ck.bn_apply_act_backward(rows(x), *p, rows(dy), act, rows(res),
                                   mode, M)
    sums = ck.bn_apply_act_backward_sums(rows(x), *p, rows(dy), act,
                                         rows(res), mode)
    assert sums.shape == (6, C)
    split = ck.bn_apply_act_backward_chain(rows(x), *p, rows(dy),
                                           sums[:2].contiguous(), M, act,
                                           rows(res), mode)
    for a, b in zip(one, split):
        assert (a is None and b is None) or torch.equal(a, b)
    half = shape[0] // 2
    parts = [(rows(x[i:i + half]), rows(dy[i:i + half]),
              rows(None if res is None else res[i:i + half]))
             for i in (0, half)]
    total = sum(ck.bn_apply_act_backward_sums(px, *p, pd, act, pr, mode)[:2]
                for px, pd, pr in parts)
    dxs = [ck.bn_apply_act_backward_chain(px, *p, pd, total, M, act, pr,
                                          mode)
           for px, pd, pr in parts]
    np.testing.assert_allclose(torch.cat([d[0] for d in dxs]).numpy(),
                               one[0].numpy(), rtol=1e-5, atol=1e-5)
    for k in (4, 5):   # dscale, dbias: global on each half
        np.testing.assert_allclose(dxs[0][k].numpy(), one[k].numpy(),
                                   rtol=1e-5, atol=1e-5)

    def loss(xj, s, b, *r):
        m = jnp.mean(xj, axis=axes)
        v = jnp.mean(xj * xj, axis=axes) - m * m
        y = ep.bn_apply_act(xj, s, b, m, 1.0 / jnp.sqrt(v + 1e-5), act=act,
                            residual=r[0] if r else None,
                            channel_last=channel_last)
        return jnp.sum(y * jnp.asarray(dy))

    args = [jnp.asarray(a) for a in (x, scale, bias)] + (
        [jnp.asarray(res)] if residual else [])
    want = jax.grad(loss, argnums=(0, 1, 2))(*args)
    got = (one[0].numpy().reshape(shape), one[4].numpy(), one[5].numpy())
    for name, g, w in zip(("x", "scale", "bias"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_split_k9_wrappers_refuse_what_they_cannot_take():
    x = torch.ones(4, 3)
    p = torch.ones(3)
    with pytest.raises(ValueError, match="count"):
        ck.bn_apply_act_backward_chain(x, p, p, p, p, x, torch.ones(2, 3), 0)
    meta = torch.empty(4, 3, device="meta")
    assert ck.bn_apply_act_backward_sums(meta, p, p, p, p, meta).shape == (6, 3)


STAT_COTS = [("batch_norm", "NCHW", ["y", "saved_mean"]),
             ("batch_norm", "NHWC", ["y", "saved_var", "var"]),
             ("batch_norm", "NCHW", ["saved_mean", "saved_var", "mean",
                                     "var"]),
             ("conv2d_bn", "NHWC", ["y", "mean", "saved_var"])]


@pytest.mark.parametrize("op_type,layout,cots", STAT_COTS,
                         ids=["bn_saved_mean", "bn_saved_var_var",
                              "bn_stats_only", "conv2d_bn"])
def test_batch_norm_statistics_cotangents_match_jax_vjp(op_type, layout, cots):
    """A program that differentiates through SavedMean, SavedVariance,
    MeanOut or VarianceOut of a training batch norm: the port folds their
    cotangents into the statistics' chain (K9's dmean and dvar); X, Scale,
    Bias (and the conv's Input and Filter) grads against the JAX op's
    jax.vjp, as test_torch_resnet.py holds the Y-only case."""
    from test_torch_resnet import _bn_ins, _check_op, _rand, BN_OUTS

    if op_type == "batch_norm":
        xs = (4, 5, 6, 7) if layout == "NCHW" else (4, 6, 7, 5)
        _check_op("batch_norm", _bn_ins(xs, 5, False), BN_OUTS,
                  dict(momentum=0.9, epsilon=1e-5, is_test=False,
                       data_layout=layout), cots, no_grad=("mean", "var"))
        return
    ins = _bn_ins((4, 8, 8, 3), 6, False)
    ins["Input"] = {"x": ins.pop("X")["x"]}
    ins["Filter"] = {"w": _rand((3, 3, 3, 6), 16, 0.3)}
    _check_op("conv2d_bn", ins, BN_OUTS,
              dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1],
                   groups=1, data_format=layout, epsilon=1e-5, momentum=0.9),
              cots, no_grad=("mean", "var"))
