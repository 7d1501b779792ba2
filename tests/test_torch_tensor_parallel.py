"""Tensor parallelism of the port (the Megatron rewrite under
with_data_parallel over a `tp` axis, vocab-parallel cross entropy,
tensor-parallel serving) on gloo CPU ranks against the JAX package's GSPMD
runs on its virtual CPU mesh (tests/conftest.py's 8 devices).

The port side runs in one pool of spawned ranks (tests/torch_rank_pool.py,
one torch thread a rank, every wait bounded), the per-rank code in
tests/torch_tp_cases.py; the JAX side runs the same programs on the global
batch in this process.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu import layers as JL
from paddle_tpu.parallel import make_mesh as jmesh

import torch_tp_cases as cases
from torch_rank_pool import RankPool

LR, STEPS, B, S = 1e-3, 2, 4, 8


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, timeout=120.0)
    yield p
    p.close()


# -- the rewrite against test_parallel.py:258 ----------------------------------

@pytest.fixture(scope="module")
def two_fc_jax():
    """test_tp_sharding_annotation_compiles on the JAX package: the
    startup's weights, a batch, and the output on {"dp": 2, "tp": 4}."""
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup), jpt.unique_name.guard():
        out = cases.two_fc(jpt, "tp")
    scope, exe = jpt.Scope(), jpt.Executor()
    exe.run(startup, scope=scope)
    params = {p.name: np.asarray(scope.find_var(p.name))
              for p in main.all_parameters()}
    x = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    (ref,) = exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    compiled = jpt.CompiledProgram(main).with_data_parallel(
        mesh=jmesh({"dp": 2, "tp": 4}))
    (sharded,) = exe.run(compiled, feed={"x": x}, fetch_list=[out],
                         scope=scope)
    np.testing.assert_allclose(ref, sharded, rtol=1e-4, atol=1e-5)
    return params, x, np.asarray(sharded)


@pytest.mark.parametrize("mesh", [{"tp": 2}, {"dp": 2, "tp": 2}, {"tp": 4}],
                         ids=["tp2", "dp2tp2", "tp4"])
def test_two_fc_megatron_split_matches_jax_gspmd(pool, two_fc_jax, mesh):
    """Column- then row-parallel fc: each rank's clone slices the
    unannotated first bias, sums the second product over tp before its
    bias, gathers nothing, and the output is the JAX GSPMD run's."""
    params, x, want = two_fc_jax
    n = int(np.prod(list(mesh.values())))
    for got, types in pool.run(n, cases.fc_rank, mesh, params, x):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert types.count("c_allreduce_sum") == 1
        assert types.index("c_allreduce_sum") < len(types) - 1
        assert types[-1] == "elementwise_add"
        assert "tp_slice" in types and "tp_gather" not in types


# -- bert_tiny(use_tp=True) ------------------------------------------------------

@pytest.fixture(scope="module")
def bert_jax():
    """The JAX startup's weights with random biases (zero at init, they
    would hide a bias added once a rank), two seeded batches, and the JAX
    runs of bert_tiny(use_tp=True) + Adam: one-process and GSPMD over
    {"tp": 2} and {"dp": 2, "tp": 2}."""
    main, startup, _ = cases.bert_programs(jpt, seq=S, lr=LR)
    scope, exe = jpt.Scope(), jpt.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(3)
    params = {}
    for p in main.all_parameters():
        a = np.asarray(scope.find_var(p.name))
        if p.name.endswith(".b"):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        params[p.name] = a
    feeds = [cases.example_bert_feed(B, S, seed=s) for s in range(STEPS)]
    runs = {}
    for key, mesh in (("plain", None), ("tp2", {"tp": 2}),
                      ("dp2tp2", {"dp": 2, "tp": 2})):
        m, st, ls = cases.bert_programs(jpt, seq=S, lr=LR)
        sc, ex = jpt.Scope(), jpt.Executor()
        ex.run(st, scope=sc)
        for n, a in params.items():
            sc.set_var(n, a)
        target = m if mesh is None else jpt.CompiledProgram(m) \
            .with_data_parallel(loss_name=ls.name, mesh=jmesh(mesh))
        losses = [float(np.asarray(ex.run(target, feed=f, fetch_list=[ls],
                                          scope=sc)[0]).reshape(-1)[0])
                  for f in feeds]
        runs[key] = (losses, {n: np.asarray(sc.find_var(n))
                              for n in params})
    return params, feeds, runs


def _holds(losses, params, want):
    """test_torch_training.py's bert_tiny holds: losses rtol 1e-4, the
    parameters after k Adam steps within 2 k lr."""
    wl, wp = want
    np.testing.assert_allclose(losses, wl, rtol=1e-4)
    for n in wp:
        np.testing.assert_allclose(params[n], wp[n], rtol=0,
                                   atol=2 * STEPS * LR, err_msg=n)


@pytest.mark.parametrize("mesh", [{"tp": 2}, {"dp": 2, "tp": 2}],
                         ids=["tp2", "dp2tp2"])
def test_bert_tiny_under_tp_matches_jax_gspmd(pool, bert_jax, mesh,
                                              tmp_path):
    """Two Adam steps of bert_tiny(use_tp=True) equal the JAX GSPMD run
    on the same mesh shape; rank r's qkv shard is the columns of its heads
    in q, k and v; the tp save is the one-process save of the same values,
    byte for byte."""
    params, feeds, runs = bert_jax
    key = "tp2" if len(mesh) == 1 else "dp2tp2"
    n = int(np.prod(list(mesh.values())))
    save = str(tmp_path / "tp")
    outs = pool.run(n, cases.bert_rank, mesh, params, feeds, None, S,
                    "adam", None, save)
    nh, tp = 4, 2
    for rank, (losses, glob, shards, types) in enumerate(outs):
        _holds(losses, glob, runs[key])
        _holds(losses, glob, runs["plain"])
        assert "tp_gather" not in types
        r = rank % tp
        for name, shard in shards.items():
            H = glob[name].shape[0]
            heads = glob[name].reshape(H, 3, nh, -1)[:, :, r * nh // tp:
                                                      (r + 1) * nh // tp]
            np.testing.assert_array_equal(shard, heads.reshape(H, -1))
            jw = runs[key][1][name].reshape(H, 3, nh, -1)
            np.testing.assert_allclose(
                shard, jw[:, :, r * nh // tp:(r + 1) * nh // tp]
                .reshape(H, -1), rtol=0, atol=2 * STEPS * LR)
    # the one-process save of the same values
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.weights import load_params

    main, startup, _ = cases.bert_programs(tpt, seq=S, lr=LR)
    scope, exe = tpt.Scope(), tpt.Executor(place="cpu")
    exe.run(startup, scope=scope)
    load_params(scope, main, outs[0][1])
    one = str(tmp_path / "one")
    tpt.io.save_params(exe, one, main, scope=scope)
    files = sorted(os.listdir(one))
    for rank in range(n):
        mine = os.path.join(save, f"rank{rank}")
        assert files == sorted(os.listdir(mine))
        for f in files:
            with open(os.path.join(one, f), "rb") as a, \
                    open(os.path.join(mine, f), "rb") as b:
                assert a.read() == b.read(), (rank, f)


@pytest.mark.parametrize("fault", cases.FAULTS)
def test_planted_faults_fail_the_bert_holds(pool, bert_jax, fault):
    """The row-parallel sums skipped, or the replicated bias added on
    every rank before the sum: each fails the holds the rewrite passes."""
    params, feeds, runs = bert_jax
    losses, glob, _, _ = pool.run(2, cases.bert_rank, {"tp": 2}, params,
                                  feeds, fault)[0]
    with pytest.raises(AssertionError):
        _holds(losses, glob, runs["tp2"])


def test_global_norm_clip_under_tp_matches_jax(pool, bert_jax):
    """GradientClipByGlobalNorm(0.05) over tp-sharded gradients under SGD
    at lr 1 (the update is the clipped gradient): the squared norms of the
    shards are partial sums, summed over tp before the global norm, so two
    clipped steps at tp 2 are the JAX one-process run's, parameters within
    1e-5 (the clipped update's elements reach 0.05)."""
    params, feeds, _ = bert_jax
    main, startup, loss = cases.bert_programs(jpt, seq=S, lr=1.0,
                                              opt="sgd_clip")
    scope, exe = jpt.Scope(), jpt.Executor()
    exe.run(startup, scope=scope)
    for n, a in params.items():
        scope.set_var(n, a)
    for f in feeds:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    for _, glob, _, types in pool.run(2, cases.bert_rank, {"tp": 2}, params,
                                      feeds, None, S, "sgd_clip", None, None,
                                      1.0):
        for n in params:
            np.testing.assert_allclose(glob[n], np.asarray(scope.find_var(n)),
                                       rtol=0, atol=1e-5, err_msg=n)
        assert "squared_l2_norm" in types and "tp_gather" not in types


def test_heads_tp_does_not_divide_stay_replicated(pool, bert_jax):
    """3 ranks on bert_tiny's 4 heads: no weight is sharded (the qkv
    heads, the FFN's 128 and the vocabulary's 1024 do not divide by 3),
    and the run is the one-process run."""
    params, feeds, runs = bert_jax
    for losses, glob, shards, types in pool.run(3, cases.bert_rank,
                                                {"tp": 3}, params, feeds):
        _holds(losses, glob, runs["plain"])
        assert all(shards[n].shape == glob[n].shape for n in shards)
        assert "c_allreduce_sum" not in types and "tp_slice" not in types


def test_found_inf_in_one_ranks_shard_skips_the_step_on_every_rank(pool):
    """AMP's dynamic loss scaling under tp: an inf in the gradient columns
    of rank 1 alone makes both ranks skip the step (the flag OR-reduced
    over tp before the unscale zeroes anything), as the one-process run
    skips it: the weight is unchanged and the bad-step counter is 1."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    c = rng.standard_normal((4, 8)).astype(np.float32)
    c[1, 6] = np.inf                       # column 6: rank 1's half
    w = rng.standard_normal((6, 8)).astype(np.float32)
    for got, scale, bad, marked in pool.run(2, cases.found_inf_rank, x, c, w):
        assert marked == [True]
        np.testing.assert_array_equal(got, w)
        assert (scale, bad) == (8.0, 1)


# -- the vocab-parallel cross entropy ------------------------------------------

def test_vocab_parallel_xent_matches_the_jax_op(pool):
    """softmax_with_cross_entropy over logits split on their class dim
    (2 ranks, the plain K6/K7 versions): the loss and the logits gradient
    are the JAX op's on the full logits, labels in each slice and on the
    slice's edge."""
    N, V = 8, 64
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((N, V))).astype(np.float32)
    labels = np.array([0, 31, 32, 63, 5, 40, 31, 33], np.int64)
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup), jpt.unique_name.guard():
        x = JL.data(name="x", shape=[V], dtype="float32")
        x.stop_gradient = False
        lab = JL.data(name="lab", shape=[1], dtype="int64")
        loss = JL.reduce_sum(JL.softmax_with_cross_entropy(x, lab))
        jpt.backward.append_backward(loss)
    want = jpt.Executor().run(main, feed={"x": logits, "lab": labels[:, None]},
                              fetch_list=[loss, "x@GRAD"], scope=jpt.Scope())
    for got_loss, got_grad, marked in pool.run(2, cases.xent_rank, logits,
                                               labels):
        assert marked == [True, True]
        np.testing.assert_allclose(got_loss, want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_grad, want[1], rtol=1e-5, atol=1e-6)


# -- refusals --------------------------------------------------------------------

@pytest.mark.parametrize("what", ["sub_block"])
def test_what_the_rewrite_refuses_raises(pool, what):
    for msg in pool.run(2, cases.bert_refusal_rank, what):
        assert msg is not None and "parallel and distributed" in msg, msg


@pytest.mark.parametrize("opt", ["lamb", "lars_momentum"])
def test_whole_parameter_norms_under_tp_match_jax(pool, bert_jax, opt):
    """LAMB and LARS on tp-sharded bert_tiny: each rank updates its shard,
    the norms of the parameter and of its update (LAMB's trust ratio,
    LARS's local learning rate) summed over tp before the root. Two steps
    at lr 1e-2 equal the JAX GSPMD run on {"tp": 2}: losses rtol 1e-5,
    parameters within 2e-6 + 1e-5 of themselves (a norm over one shard
    moves the updates of the sharded weights, ~1e-4 an element, by tens
    of percent; a layer norm's weights near 1 move ~1e-2 a step)."""
    params, feeds, _ = bert_jax
    lr = 1e-2
    main, startup, loss = cases.bert_programs(jpt, seq=S, lr=lr, opt=opt)
    scope, exe = jpt.Scope(), jpt.Executor()
    exe.run(startup, scope=scope)
    for n, a in params.items():
        scope.set_var(n, a)
    target = jpt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=jmesh({"tp": 2}))
    jl = [float(np.asarray(exe.run(target, feed=f, fetch_list=[loss],
                                   scope=scope)[0]).reshape(-1)[0])
          for f in feeds]
    for losses, glob, _, types in pool.run(2, cases.bert_rank, {"tp": 2},
                                           params, feeds, None, S, opt,
                                           None, None, lr):
        np.testing.assert_allclose(losses, jl, rtol=1e-5)
        for n in params:
            np.testing.assert_allclose(glob[n], np.asarray(scope.find_var(n)),
                                       rtol=1e-5, atol=2e-6, err_msg=n)
        assert opt in types and "tp_gather" not in types


# -- tensor-parallel serving -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_serving():
    """The JAX engine's decoder_tiny() weights, prompts and tp = 1 tokens,
    prefix cache off and on (test_serving_multitenant.py:331)."""
    from paddle_tpu.serving import ServingEngine
    from paddle_tpu.serving.model import decoder_tiny

    cfg = decoder_tiny()
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (5, 11)]
    prompts += [prompts[1][:8] + [3, 4, 5]]
    want, params = {}, None
    for pc in (False, True):
        eng = ServingEngine(cfg, page_size=4, pool_pages=64, max_inflight=4,
                            prefix_cache=pc)
        if params is None:
            params = {p.name: np.asarray(eng._scope.find_var(p.name))
                      for p in eng._prefill_prog.all_parameters()}
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_drained()
        want[pc] = [eng.result(r) for r in rids]
    return params, prompts, want


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["cold", "prefix"])
def test_tp_engine_emits_the_jax_tokens(pool, jax_serving, prefix_cache):
    """ServingEngine(tp=2) on 2 ranks: rank 0 emits exactly the JAX
    engine's tp = 1 tokens, its follower ran every program with it, and
    the pools are annotated on their heads and held [pages, ps, nh/2, dh]
    a rank."""
    params, prompts, want = jax_serving
    lead, follow = pool.run(2, cases.serve_rank, params, prompts,
                            prefix_cache)
    assert lead[0] == want[prefix_cache]
    assert follow[0] > 0
    assert lead[1] == (None, None, "tp", None)
    assert lead[2] == follow[2] == (64, 4, 1, 16)


def test_tp_follower_raises_when_its_leader_falls_out_of_step(pool):
    """A follower waits on rank 0's broadcasts with the channel's timeout:
    a leader that never runs anything makes it raise, not hang."""
    _, follow = pool.run(2, cases.stalled_leader_rank, 6.0)
    assert follow[1] is not None and follow[2] < 6.0, follow


def test_tp_serving_refuses_heads_tp_does_not_divide():
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.model import decoder_tiny

    with pytest.raises(ValueError, match="must divide num_heads"):
        ServingEngine(decoder_tiny(), device="cpu", tp=3)


def test_tp_decode_consults_per_shard_tuner_key(tmp_path):
    """test_serving_multitenant.py:344 on the port: under tp the decode
    attention's tuner key is the shard's, nh / tp heads."""
    import torch

    from paddle_tpu_torch import flags, tuning
    from paddle_tpu_torch.ops import attention_ops as ao

    saved = {k: flags.get_flag(k) for k in ("tuning_mode", "tuning_db")}
    db_path = str(tmp_path / "db.json")
    try:
        flags.set_flags({"tuning_mode": "consult", "tuning_db": db_path})
        tuning.invalidate_db_cache()
        db = tuning.TuningDB(db_path)
        key = tuning.canonical_key(
            "attention", tuning.attention_key(4, 6, 1, 256, 64, True),
            "float32", tuning.device_kind())
        db.put(key, {"backend": "pallas_paged"}, source="swept")
        db.save(db_path)
        tuning.invalidate_db_cache()
        backend, tier = ao.paged_attention_backend(
            4, 12, 256, 64, torch.float32, tp=2)
        assert (backend, tier) == ("pallas_paged", "db")
        _, tier_full = ao.paged_attention_backend(4, 12, 256, 64,
                                                  torch.float32, tp=1)
        assert tier_full != "db"
    finally:
        flags.set_flags(saved)
        tuning.invalidate_db_cache()


def test_shard_feed_follows_the_annotations():
    """Mesh.shard_feed with the program: an annotated feed splits along its
    annotated dim; an axis the mesh lacks raises (annotation_spec
    strict)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.parallel import make_mesh

    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        x = L.data(name="x", shape=[2, 8, 4], dtype="float32")
        x.sharding = (None, None, "sp", None)
        y = L.data(name="y", shape=[3], dtype="float32")
    mesh = make_mesh({"sp": 1})
    feed = {"x": np.zeros((2, 2, 8, 4), np.float32),
            "y": np.zeros((2, 3), np.float32)}
    out = mesh.shard_feed(feed, axis="sp", program=main)
    assert out["x"].shape == (2, 2, 8, 4) and out["y"].shape == (2, 3)
    y.sharding = ("dp", None)
    with pytest.raises(ValueError, match="does not have"):
        mesh.shard_feed(feed, axis="sp", program=main)
