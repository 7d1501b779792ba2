"""Sequence parallelism of the port (`use_sp` under with_data_parallel over
a mesh with an `sp` axis: the sequence-parallel rewrite, parallel/
spatial.py) on gloo CPU ranks against the JAX package's GSPMD runs on its
virtual CPU mesh (tests/conftest.py's 8 devices) and the port's own
unsharded run.

The port side runs in one pool of spawned ranks (tests/torch_rank_pool.py),
the per-rank code in tests/torch_sp_cases.py; the JAX side runs the same
programs on the global batch in this process.
"""
import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu.parallel import make_mesh as jmesh

import torch_sp_cases as cases
from torch_rank_pool import RankPool

STEPS, B = 3, 4
MESHES = {"sp2": {"sp": 2}, "dp2sp2": {"dp": 2, "sp": 2},
          "tp2sp2": {"tp": 2, "sp": 2}}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, timeout=180.0)
    yield p
    p.close()


def _params(use_tp):
    """The JAX startup's weights, biases drawn (zero at init, they would
    hide a bias added once a rank)."""
    main, startup, _ = cases.bert_programs(jpt, use_tp)
    scope, exe = jpt.Scope(), jpt.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(3)
    out = {}
    for p in main.all_parameters():
        a = np.asarray(scope.find_var(p.name))
        if p.name.endswith(".b"):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[p.name] = a
    return out


@pytest.fixture(scope="module")
def bert_jax():
    """For use_tp False and True: the weights, three seeded batches, and
    the JAX GSPMD runs of bert_tiny(use_sp=True) + Adam over each mesh."""
    feeds = [cases.bert_feed(B, seed=s) for s in range(STEPS)]
    out = {}
    for key, mesh in MESHES.items():
        use_tp = "tp" in mesh
        params = _params(use_tp)
        m, st, ls = cases.bert_programs(jpt, use_tp)
        sc, ex = jpt.Scope(), jpt.Executor()
        ex.run(st, scope=sc)
        for n, a in params.items():
            sc.set_var(n, a)
        target = jpt.CompiledProgram(m).with_data_parallel(
            loss_name=ls.name, mesh=jmesh(mesh))
        losses = [float(np.asarray(ex.run(target, feed=f, fetch_list=[ls],
                                          scope=sc)[0]).reshape(-1)[0])
                  for f in feeds]
        out[key] = (params, losses,
                    {n: np.asarray(sc.find_var(n)) for n in params})
    return feeds, out


def _holds(losses, params, want_losses, want_params):
    """Losses within 1e-5 relative, parameters within 1e-5."""
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for n in want_params:
        np.testing.assert_allclose(params[n], want_params[n], rtol=0,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("key", sorted(MESHES))
def test_bert_use_sp_matches_jax_gspmd(pool, bert_jax, key):
    """Three Adam steps of bert_tiny(use_sp=True) (use_tp=True on the tp x
    sp mesh) equal the JAX GSPMD run on the same mesh and the port's
    unsharded run; every rank fetches the same loss; the user's program
    is left as it was."""
    feeds, runs = bert_jax
    mesh = MESHES[key]
    params, jl, jp = runs[key]
    use_tp = "tp" in mesh
    one_l, one_p, _ = cases.bert_one_process(params, feeds, use_tp)
    n = int(np.prod(list(mesh.values())))
    for losses, glob, _, same in pool.run(n, cases.bert_rank, mesh, params,
                                          feeds, None, use_tp):
        assert same
        _holds(losses, glob, jl, jp)
        _holds(losses, glob, one_l, one_p)


def test_dropout_masks_are_the_one_process_masks(pool, bert_jax):
    """bert_tiny with dropout 0.1 over {"sp": 2}: every dropout mask,
    fetched (gathered along the sequence), is the one-process run's bit
    for bit (each rank keeps its rows of the global draw; the attention
    probabilities' dropout runs on the gathered scores), and so are the
    losses and parameters within 1e-5."""
    feeds, runs = bert_jax
    params = runs["sp2"][0]
    one_l, one_p, one_m = cases.bert_one_process(params, feeds[:2],
                                                 dropout=0.1)
    assert len(one_m) == 2 * 4 + 1
    for losses, glob, masks, _ in pool.run(2, cases.bert_rank, {"sp": 2},
                                           params, feeds[:2], None, False,
                                           0.1):
        for got, want in zip(masks, one_m):
            np.testing.assert_array_equal(got, want)
        _holds(losses, glob, one_l, one_p)


@pytest.mark.parametrize("fault", ["own_keys", "sp_average"])
def test_planted_faults_fail_the_holds(pool, bert_jax, fault):
    """Attention over the rank's own keys only, or the parameter gradients
    averaged over sp: each fails the holds the rewrite passes."""
    feeds, runs = bert_jax
    params, jl, jp = runs["sp2"]
    losses, glob, _, _ = pool.run(2, cases.bert_rank, {"sp": 2}, params,
                                  feeds, fault)[0]
    with pytest.raises(AssertionError):
        _holds(losses, glob, jl, jp)


def test_use_sp_program_equals_jax():
    """use_sp annotates the four feeds on (dp, sp) as IR metadata: the
    port's program equals the JAX one by to_dict()."""
    progs = [cases.bert_programs(pkg)[0].to_dict()
             for pkg in (jpt, __import__("paddle_tpu_torch"))]
    assert progs[1] == progs[0]
    for n in ("src_ids", "pos_ids", "lm_label", "lm_weight"):
        assert progs[1]["blocks"][0]["vars"][n]["sharding"] == ["dp", "sp"]


def test_found_inf_in_one_ranks_rows_skips_the_step_on_every_rank(pool):
    """AMP's dynamic loss scaling under sp: an inf in rank 1's rows alone
    makes both ranks skip the step, as the one-process run skips it (the
    gradients the unscale checks are summed over sp first, so every rank
    sees the inf): the weight is unchanged and the bad-step counter is 1."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 6)).astype(np.float32)
    c = rng.standard_normal((2, 8, 4)).astype(np.float32)
    c[1, 6, 2] = np.inf                    # row 6 of 8: rank 1's half
    w = rng.standard_normal((6, 4)).astype(np.float32)
    for got, scale, bad in pool.run(2, cases.found_inf_rank, x, c, w):
        np.testing.assert_array_equal(got, w)
        assert (scale, bad) == (8.0, 1)


def test_sp_save_is_the_one_process_save(pool, bert_jax, tmp_path):
    """Parameters are replicated over sp: each rank's save_params after
    two steps writes the bytes a one-process save of the same values
    writes, and loading them back needs no slicing."""
    import os

    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.weights import load_params

    feeds, runs = bert_jax
    params = runs["sp2"][0]
    glob = pool.run(2, cases.save_rank, params, feeds[:2], str(tmp_path))[0]
    main, startup, _ = cases.bert_programs(tpt)
    scope, exe = tpt.Scope(), tpt.Executor(place="cpu")
    exe.run(startup, scope=scope)
    load_params(scope, main, glob)
    one = str(tmp_path / "one")
    tpt.io.save_params(exe, one, main, scope=scope)
    files = sorted(os.listdir(one))
    for rank in range(2):
        mine = str(tmp_path / f"rank{rank}")
        assert files == sorted(os.listdir(mine))
        for f in files:
            with open(os.path.join(one, f), "rb") as a, \
                    open(os.path.join(mine, f), "rb") as b:
                assert a.read() == b.read(), (rank, f)
