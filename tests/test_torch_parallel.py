"""Data parallelism of the port on gloo CPU ranks against the JAX package
on its virtual CPU mesh (tests/conftest.py's 8 devices).

The port side runs in one pool of spawned ranks (tests/torch_rank_pool.py:
gloo, one torch thread a rank, every wait bounded), each rank feeding its
rows of the same numpy batch; the JAX side runs the same programs under
`make_mesh({"dp": n})` on the global batch. Programs are compared by
`to_dict()`, trajectories at the JAX tests' own rtol=1e-4, atol=1e-5.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.parallel import make_mesh as jmesh

import torch_dp_cases as cases
from torch_rank_pool import RankPool

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _mlp_feeds(steps=5, bs=32, seed=0, same_halves=False):
    """`steps` copies of one batch; same_halves: both ranks' rows equal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bs, 16)).astype(np.float32)
    if same_halves:
        x = np.concatenate([x[: bs // 2]] * 2)
    w = rng.standard_normal((16, 1)).astype(np.float32)
    return [{"x": x, "y": (x @ w).astype(np.float32)}] * steps


def jax_run(spec, feeds, nranks):
    """The JAX package's run of `spec` on the global feeds: (losses,
    params, main's to_dict, the startup's persistables)."""
    main, startup, loss, t = cases.programs(jpt, spec, nranks)
    scope, exe = jpt.Scope(), jpt.Executor()
    exe.run(startup, scope=scope)
    init = {v.name: np.asarray(scope.find_var(v.name))
            for v in startup.list_vars()
            if scope.find_var(v.name) is not None}
    mode = spec["mode"]
    if mode in ("dp", "dp_zero1"):
        bs = jpt.BuildStrategy()
        bs.sharded_optimizer_states = mode == "dp_zero1"
        target = jpt.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel(loss_name=loss.name, mesh=jmesh({"dp": nranks}))
    elif mode == "plain":
        target = main
    else:
        target = jpt.CompiledProgram(main).with_collective(
            mesh=jmesh({"dp": nranks}))
    losses = []
    for feed in feeds:
        (lv,) = exe.run(target, feed=feed, fetch_list=[loss.name],
                        scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    params = {p.name: np.asarray(scope.find_var(p.name))
              for p in main.all_parameters()}
    return losses, params, main.to_dict(), init, t


def port_run(pool, spec, feeds, nranks, init, main):
    params = {p.name: init[p.name] for p in main.all_parameters()}
    state = {k: v for k, v in init.items() if "@SNAPSHOT" in k}
    return pool.run(nranks, cases.train_rank, spec, params, feeds, state)


def _close_params(got, want):
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


PARITY = {
    "allreduce_flag": dict(mode="grad_allreduce"),
    "allreduce_pergrad": dict(mode="grad_allreduce", bucket_mb=0.0),
    "allreduce_split": dict(mode="grad_allreduce", bucket_mb=0.0001),
    "grad_allreduce_zero1": dict(mode="grad_allreduce", zero1=True,
                                 opt="adam"),
    "apply_zero1": dict(mode="zero1", opt="adam"),
    "local_sgd": dict(mode="local_sgd", k_steps=2),
    "fleet": dict(mode="fleet"),
    "fleet_zero1": dict(mode="fleet", zero1=True, opt="adam"),
    "fleet_local_sgd": dict(mode="fleet", local_sgd=2),
    "fleet_amp": dict(mode="fleet", opt="momentum", amp=True),
    "lamb_stays_on_allreduce": dict(mode="grad_allreduce", zero1=True,
                                    opt="lamb"),
}


@pytest.mark.parametrize("model", ["mlp", "bert"])
@pytest.mark.parametrize("name", sorted(PARITY))
def test_transpiled_programs_equal_jax(name, model):
    """GradAllReduce (bucketed and per gradient), LocalSGD, apply_zero1
    and the fleet's minimize give the JAX package's programs, main and
    startup, by to_dict()."""
    spec = dict(PARITY[name], model=model)
    jm, js, _, jt = cases.programs(jpt, spec, 2)
    tm, ts, _, tt = cases.programs(tpt, spec, 2)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    if jt is not None and hasattr(jt, "last_buckets"):
        assert tt.last_buckets == jt.last_buckets
        assert tt.resolved_bucket_mb == jt.resolved_bucket_mb
    types = [op.type for op in tm.global_block.ops]
    if name == "lamb_stays_on_allreduce":
        assert "zero1_shard" not in types   # LAMB is not elementwise
    if name in ("grad_allreduce_zero1", "apply_zero1", "fleet_zero1"):
        assert "c_reducescatter" in types and "c_allgather" in types


@pytest.mark.parametrize("spec", [
    dict(model="mlp", mode="fleet", opt="sgd"),
    dict(model="mlp", mode="dp", opt="sgd"),
    dict(model="mlp", mode="local_sgd", opt="sgd", k_steps=2),
    dict(model="mlp", mode="fleet", opt="adam", zero1=True, lr=1e-2),
    dict(model="mlp", mode="dp_zero1", opt="adam", lr=1e-2),
], ids=["fleet", "dp", "local_sgd", "fleet_zero1", "dp_zero1"])
def test_mlp_trajectories_match_the_jax_mesh(pool, spec):
    """LocalSGD runs on equal halves: the JAX shard_map run returns one
    device's parameters after every step (replicated out_specs), so its
    ranks cannot drift apart between syncs; the port's do (the next
    test)."""
    feeds = _mlp_feeds(same_halves=spec["mode"] == "local_sgd")
    jl, jp, jd, init, _ = jax_run(spec, feeds, 2)
    main = cases.programs(tpt, spec, 1)[0]
    outs = port_run(pool, spec, feeds, 2, init, main)
    for o in outs:
        assert o["program"] == jd
        _close_params(o["params"], jp)
    _hold_losses(spec, outs, jl)


def _hold_losses(spec, outs, jl):
    """A with_data_parallel loss is the global batch's on every rank, as
    the JAX GSPMD run's; a collective run's is each rank's own, and the
    JAX shard_map run returns one device's: the ranks' mean must then be
    the one-device loss of step 1 on the whole batch (equal shards of a
    mean), and some rank's losses the JAX run's."""
    if spec["mode"].startswith("dp"):
        for o in outs:
            np.testing.assert_allclose(o["losses"], jl, rtol=RTOL, atol=ATOL)
        return
    assert any(np.allclose(o["losses"], jl, rtol=RTOL, atol=ATOL)
               for o in outs), ([o["losses"] for o in outs], jl)


# -- the 16 collective ops at 4 ranks ------------------------------------

OP_CASES = [
    dict(op="c_allreduce_sum"), dict(op="c_allreduce_sum", attrs={"avg": True}),
    dict(op="c_allreduce_max"), dict(op="c_allreduce_min"),
    dict(op="c_allreduce_prod"), dict(op="allreduce"),
    dict(op="c_allreduce_coalesced", attrs={"avg": True}),
    dict(op="zero1_shard"), dict(op="c_allgather"),
    dict(op="c_reducescatter"), dict(op="c_reducescatter", attrs={"avg": True}),
    dict(op="c_broadcast", attrs={"root": 2}),
    dict(op="c_collective_permute", attrs={"shift": 1}),
    dict(op="c_collective_permute", attrs={"shift": -1}),
    dict(op="local_sgd_sync", attrs={"k_steps": 2}, step=2),
    dict(op="local_sgd_sync", attrs={"k_steps": 2}, step=1),
    dict(op="c_sync_calc_stream"), dict(op="c_sync_comm_stream"),
    dict(op="c_comm_init_all"), dict(op="c_gen_nccl_id"),
]


def _op_id(case):
    extra = "-".join(f"{k}{v}" for k, v in case.get("attrs", {}).items())
    if "step" in case:
        extra += f"-step{case['step']}"
    return case["op"] + ("-" + extra if extra else "")


def _op_feed():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 3)).astype(np.float32)
    x[::5, 1] = 0.0          # prod over zeros and negative values
    return {"x": x, "x2": rng.standard_normal((16, 5)).astype(np.float32)}


@pytest.mark.parametrize("case", OP_CASES, ids=[_op_id(c) for c in OP_CASES])
def test_collective_op_matches_jax_shard_map_at_4_ranks(pool, case):
    feed = _op_feed()
    main, fetch = cases.op_program(jpt, case)
    want = jpt.Executor().run(
        jpt.CompiledProgram(main).with_collective(mesh=jmesh({"dp": 4})),
        feed=feed, fetch_list=fetch, scope=jpt.Scope())
    tmain, tfetch = cases.op_program(tpt, case)
    assert tmain.to_dict() == main.to_dict()
    outs = pool.run(4, cases.ops_rank, case, feed)
    for got in outs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_the_port_registers_every_collective_op():
    import paddle_tpu.ops  # noqa: F401
    import paddle_tpu_torch.ops  # noqa: F401
    from paddle_tpu.ops.registry import _REGISTRY as JR
    from paddle_tpu_torch.ops.registry import _REGISTRY as TR

    ops = {c["op"] for c in OP_CASES}
    assert len(ops) == 16 and ops <= set(TR)
    for op in ops:
        assert TR[op].no_grad == JR[op].no_grad, op


def test_local_sgd_ranks_drift_between_syncs_and_agree_at_them(pool):
    """k_steps=2 on different halves: the ranks' parameters differ after
    step 1 and are equal after step 2."""
    feeds = _mlp_feeds(steps=1)
    spec = dict(model="mlp", mode="local_sgd", opt="sgd", k_steps=2)
    _, _, _, init, _ = jax_run(spec, feeds, 2)
    main = cases.programs(tpt, spec, 1)[0]
    one = port_run(pool, spec, feeds, 2, init, main)
    two = port_run(pool, spec, feeds * 2, 2, init, main)
    names = list(one[0]["params"])
    assert any(not np.array_equal(one[0]["params"][n], one[1]["params"][n])
               for n in names)
    for n in names:
        assert np.array_equal(two[0]["params"][n], two[1]["params"][n]), n


def test_bucketed_and_per_gradient_allreduce_agree_bit_for_bit(pool):
    """Per gradient, one bucket, and a bucket boundary that splits a
    layer's (w, b): the same bits at 2 ranks, fp32 and under AMP, and the
    JAX mesh's trajectory."""
    feeds = _mlp_feeds()
    for amp in (False, True):
        runs = {}
        for mb in (0.0, 4.0, 0.0001):
            spec = dict(model="mlp", mode="grad_allreduce", opt="momentum",
                        sizes=(8, 8), bucket_mb=mb, amp=amp)
            jl, jp, jd, init, _ = jax_run(spec, feeds, 2)
            main = cases.programs(tpt, spec, 1)[0]
            runs[mb] = port_run(pool, spec, feeds, 2, init, main)
            for o in runs[mb]:
                assert o["program"] == jd
                if amp:   # bf16 rounds apart in the two packages: the
                    # AMP tests' band (tests/test_torch_amp.py)
                    for n, w in jp.items():
                        np.testing.assert_allclose(o["params"][n], w,
                                                   rtol=1e-2, atol=1e-3)
                else:
                    _close_params(o["params"], jp)
        assert len(runs[0.0001][0]["buckets"]) > 1
        for mb in (4.0, 0.0001):
            for a, b in zip(runs[0.0][0]["params"].values(),
                            runs[mb][0]["params"].values()):
                assert np.array_equal(a, b), (amp, mb)


def _bert_feeds(steps=5, B=4, S=8, seed=0):
    rng = np.random.default_rng(seed)
    w = np.ones((B, S), np.float32)
    w[: B // 2, : S // 2] = 0.0      # the first half keeps fewer positions
    w[B // 2:, -1] = 0.0
    feed = {"src_ids": rng.integers(0, 1024, (B, S)).astype(np.int64),
            "pos_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
            "lm_label": rng.integers(0, 1024, (B, S)).astype(np.int64),
            "lm_weight": w}
    return [feed] * steps


def test_with_data_parallel_is_the_global_batch_on_bert_tiny(pool):
    """BERT's loss is sum(loss * w) / sum(w): with the halves masking
    different counts, with_data_parallel over 2 ranks follows the JAX
    GSPMD run (the one-device step on the whole batch); averaging per-rank
    gradients (the fleet's semantics) does not."""
    feeds = _bert_feeds()
    spec = dict(model="bert", mode="dp", opt="adam")
    jl, jp, _, init, _ = jax_run(spec, feeds, 2)
    main = cases.programs(tpt, spec, 1)[0]
    outs = port_run(pool, spec, feeds, 2, init, main)
    for o in outs:
        np.testing.assert_allclose(o["losses"], jl, rtol=RTOL, atol=ATOL)
        _close_params(o["params"], jp)
    fleet = port_run(pool, dict(spec, mode="fleet"), feeds[:1], 2, init,
                     main)[0]["params"]
    one = port_run(pool, dict(spec, mode="dp"), feeds[:1], 2, init,
                   main)[0]["params"]
    worst = max(float(np.abs(fleet[n] - one[n]).max()) for n in one)
    assert worst > 1e-5, worst


def test_allreduce_inside_a_static_rnn_body(pool):
    """A c_allreduce_sum in a sub-block reaches its group: each step sums
    its column over both ranks, as in the JAX shard_map run; in a plain
    run on the same ranks it is the identity."""
    xv = np.arange(32, dtype=np.float32).reshape(8, 4)
    main, out = cases.rnn_program(jpt)
    (want,) = jpt.Executor().run(
        jpt.CompiledProgram(main).with_collective(mesh=jmesh({"dp": 2})),
        feed={"x": xv}, fetch_list=[out], scope=jpt.Scope())
    want = np.asarray(want)
    np.testing.assert_allclose(want[-1].reshape(()), xv.sum(), rtol=1e-6)
    for got in pool.run(2, cases.rnn_rank, {"x": xv}, "collective"):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    plain = pool.run(2, cases.rnn_rank, {"x": xv}, "plain")
    np.testing.assert_allclose(plain[0][-1].reshape(()), xv[:4].sum(),
                               rtol=1e-6)


@pytest.mark.parametrize("which", ["sub_block"])
def test_ops_without_a_data_parallel_rule_raise(pool, which):
    """A sub-block over batch-sharded values has no data-parallel rule."""
    for msg in pool.run(2, cases.refusal_rank, which):
        assert msg is not None and "parallel and distributed" in msg, msg
        assert "sub-block" in msg, msg


@pytest.mark.parametrize("which",
                         ["reduce_max", "reduce_min", "reduce_prod"])
def test_reduction_over_the_batch_matches_jax(pool, which):
    """reduce_max / _min / _prod over the batch dim under {"dp": 2} (the
    reduction over both ranks' rows inside the op; the gradient of a max
    or min only at the global extremum, of a product times the other
    ranks' factors): two SGD steps equal the JAX GSPMD run's loss, fetched
    reduction and weights."""
    x = np.random.default_rng(6).standard_normal((8, 4)).astype(np.float32)
    main, startup, loss, red = cases.reduce_program(jpt, which)
    scope, exe = jpt.Scope(), jpt.Executor()
    exe.run(startup, scope=scope)
    params = {p.name: np.asarray(scope.find_var(p.name)).copy()
              for p in main.all_parameters()}
    target = jpt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=jmesh({"dp": 2}))
    want = [[np.asarray(v) for v in exe.run(target, feed={"x": x},
                                            fetch_list=[loss, red],
                                            scope=scope)]
            for _ in range(2)]
    wp = {n: np.asarray(scope.find_var(n)) for n in params}
    for got, gp in pool.run(2, cases.reduce_rank, which, params, x):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[0], w[0], rtol=1e-6)
            np.testing.assert_allclose(g[1], w[1], rtol=1e-6)
        for n in wp:
            np.testing.assert_allclose(gp[n], wp[n], rtol=1e-6, atol=1e-7)


def test_collective_ops_are_the_identity_outside_with_collective(pool):
    """A plain run is the identity with a process group live; under
    with_data_parallel the user's op is the identity too, and the fetch of
    the sharded value is the global batch (both ranks' rows)."""
    outs = pool.run(2, cases.identity_rank)
    for plain, under_dp, xv in outs:
        np.testing.assert_array_equal(plain, xv)
        np.testing.assert_array_equal(
            under_dp, np.concatenate([o[2] for o in outs]))


def test_sharded_checkpoint_with_zero1_state_at_two_ranks(pool, tmp_path):
    """save_sharded / load_sharded over 2 ranks: rank 0 writes the
    replicated vars, each rank its ZeRO-1 shards, and every var loads back
    bit for bit; each rank holds half of the eligible Adam moments."""
    feeds = _mlp_feeds(steps=2)
    spec = dict(model="mlp", mode="fleet", opt="adam", zero1=True, lr=1e-2,
                sizes=(8, 8))
    _, _, _, init, _ = jax_run(spec, feeds[:1], 2)
    main = cases.programs(tpt, spec, 1)[0]
    params = {p.name: init[p.name] for p in main.all_parameters()}
    d = str(tmp_path / "ck")
    outs = pool.run(2, cases.checkpoint_rank, spec, params, feeds, d)
    (b0, files0), (b1, files1) = outs
    assert b0 == b1
    assert files0 == files1 and any(".zero1-1-of-2" in f for f in files0)
    full = pool.run(1, cases.train_rank, dict(spec, mode="plain"), params,
                    feeds[:1])[0]
    # the divisible moments halve; the head's [1]-row bias stays whole
    assert b0 < full["state_bytes"]


def test_sharded_checkpoint_of_with_data_parallel_zero1(pool, tmp_path):
    """with_data_parallel + sharded_optimizer_states at 2 ranks: ZeRO-1
    lives on the executor's clone, so save_sharded resolves that clone
    from the CompiledProgram; every rank writes its half of each eligible
    moment, and the checkpoint loads back into a fresh executor bit for
    bit and trains on to the same bits. Given the user's program instead,
    save_sharded refuses the moments' shard shapes rather than writing
    rank 0's half as the whole var."""
    feeds = _mlp_feeds(steps=3)
    spec = dict(model="mlp", mode="dp_zero1", opt="adam", lr=1e-2,
                sizes=(8, 8))
    _, _, _, init, _ = jax_run(spec, feeds[:1], 2)
    main = cases.programs(tpt, spec, 1)[0]
    params = {p.name: init[p.name] for p in main.all_parameters()}
    outs = pool.run(2, cases.dp_checkpoint_rank, spec, params, feeds,
                    str(tmp_path / "ck"))
    (msg0, files0, held0), (msg1, files1, held1) = outs
    for msg in (msg0, msg1):
        assert msg is not None and "moment" in msg and \
            "CompiledProgram" in msg, msg
    assert files0 == files1 and held0 == held1 and held0
    assert {f.split(".zero1-")[1] for f in files0} == {"0-of-2.npy",
                                                      "1-of-2.npy"}
    assert len(files0) == 2 * len(held0)


def test_with_data_parallel_follows_edits_and_invalidate_cache(pool):
    """An op appended to the program after its first data-parallel run
    runs in the next (the clone is made again: the executor keys it by
    the program's ops), and invalidate_cache(program) drops the clone and
    its prepared record."""
    for l1, l2, d2, first, second, third in pool.run(2, cases.dp_clone_rank):
        assert l1 == l2 and d2 == 2 * l2
        assert first == (1, 1) and second == (1, 1) and third == (0, 0)


def test_install_check_over_two_ranks(pool):
    for out in pool.run(2, cases.install_check_rank):
        assert "works well on MUTIPLE 2 ranks" in out, out


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)),
                                                   1e-12)


# the AMP tests' gradient cap (tests/test_torch_amp.py GRAD_CAP)
AMP_CAP = 0.75


def _updates_beyond(got, want, fp32, p0):
    """The parameters whose update (p - p0) lies beyond twice the JAX
    package's own bf16-to-fp32 distance (plus 1e-3) from the JAX AMP run's
    update in relative L2, capped at AMP_CAP (tests/test_torch_amp.py's
    rule), with their distance and limit."""
    out = []
    for n, w in want.items():
        u = w - p0[n]
        limit = min(2 * _rel_l2(fp32[n] - p0[n], u) + 1e-3, AMP_CAP)
        d = _rel_l2(got[n] - p0[n], u)
        if not d <= limit:
            out.append((n, d, limit))
    return out


def test_with_data_parallel_under_amp_on_bert_tiny(pool):
    """The same under bf16 AMP (the gradients' partial sums are summed in
    fp32, after the cast back to the master weights' dtype): every
    parameter's update over 3 steps follows the JAX GSPMD AMP run's within
    the bf16 band that the JAX package's own fp32 run measures (measured:
    0.65-1.13 times that distance), and the losses within 2e-3 (measured
    9.6e-4). SGD, so that an update is the gradient's own scale: Adam's
    first steps move each element by about lr * sign(g) and cannot tell a
    global normaliser from per-rank ones. The fleet's per-rank mean on the
    same uneven feed fails the same check on every parameter (measured
    12-36 times beyond)."""
    feeds = _bert_feeds(steps=3)
    spec = dict(model="bert", mode="dp", opt="sgd", lr=0.5, amp=True)
    jl, jp, _, init, _ = jax_run(spec, feeds, 2)
    _, fp32, _, init32, _ = jax_run(dict(spec, amp=False), feeds, 2)
    p0 = {n: init[n] for n in jp}
    assert all(np.array_equal(init32[n], p0[n]) for n in p0)
    main = cases.programs(tpt, spec, 1)[0]
    outs = port_run(pool, spec, feeds, 2, init, main)
    for o in outs:
        np.testing.assert_allclose(o["losses"], jl, rtol=2e-3)
        assert not _updates_beyond(o["params"], jp, fp32, p0)
    fleet = port_run(pool, dict(spec, mode="fleet"), feeds, 2, init, main)[0]
    assert not np.allclose(fleet["losses"], jl, rtol=2e-3), fleet["losses"]
    beyond = {n for n, _, _ in _updates_beyond(fleet["params"], jp, fp32, p0)}
    assert beyond == set(jp), sorted(set(jp) - beyond)


GRAD_CASES = [dict(op="c_allreduce_sum"), dict(op="c_allreduce_sum",
                                                attrs={"avg": True}),
              dict(op="allreduce"), dict(op="c_allgather"),
              dict(op="c_reducescatter", attrs={"avg": True}),
              dict(op="c_broadcast", attrs={"root": 2}),
              dict(op="c_collective_permute", attrs={"shift": 1})]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[_op_id(c) for c in GRAD_CASES])
def test_collective_op_gradient_matches_jax_at_4_ranks(pool, case):
    """The grad registrations: sum(square(op(x)))'s gradient on each of 4
    ranks, against the JAX package's vjp under shard_map."""
    feed = {"x": _op_feed()["x"]}
    main, fetch = cases.op_grad_program(jpt, case)
    want = jpt.Executor().run(
        jpt.CompiledProgram(main).with_collective(mesh=jmesh({"dp": 4})),
        feed=feed, fetch_list=fetch, scope=jpt.Scope())
    tmain, _ = cases.op_grad_program(tpt, case)
    assert tmain.to_dict() == main.to_dict()
    for got in pool.run(4, cases.op_grad_rank, case, feed):
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("fault", [None, "lost_reduce"])
def test_chip_smoke_dp_worker_rehearses_on_two_cpu_ranks(pool, tmp_path,
                                                         fault):
    """chip_smoke's dp_gloo2 arms at bert_tiny widths on two gloo ranks,
    (f) and (g) at tiny widths, the tensor-parallel arms (h)-(j) at
    bert_tiny, decoder_tiny and ring widths, and the sp arms (k) at
    bert_tiny widths and (l) on (f)'s network: every hold passes (with
    (f)'s local-statistics variant, (g)'s per-rank draw, (h)'s two planted
    faults, (i)'s swapped head shards, (j)'s causal offset from the wrong
    rank, and (k)'s and (l)'s two planted faults each refused inside the
    arms), and a bucket allreduce that
    returns its inputs unreduced is refused (the ranks' step-1 gradients
    differ)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    if fault is None:
        assert pool.run(2, cases.smoke_dp_rank, str(tmp_path)) == [True] * 2
        res = json.loads((tmp_path / "rank0.json").read_text())
        assert len(res["checks"]) == 11 and res["arms"].keys() == {
            "bucketed", "pergrad", "zero1", "local_sgd", "global", "sync_bn",
            "wmt_dropout", "tp_bert", "sp_bert", "sp_resnet"}
        assert min(res["sync_bn_margins"]) > 1
        assert min(res["tp_fault_margins"].values()) > 1
        assert min(res["sp_bert_margins"].values()) > 1
        assert min(res["sp_rn_margins"].values()) > 1
        assert res["tp_serve"]["swapped_off"] > 0
        assert res["ring"]["fault_l2"] > 1e-4
        return
    with pytest.raises(AssertionError, match="ranks reduced to different "
                                             "gradients"):
        pool.run(2, cases.smoke_dp_rank, str(tmp_path), fault)
