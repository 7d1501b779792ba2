"""Spatial partition of convolutions in the port: an image's H annotated on
`sp`, under with_data_parallel over {"dp": 2, "sp": 2} (the sequence-
parallel rewrite's halo exchanges, pools over the split H, batch
statistics synced over dp x sp; parallel/spatial.py) on gloo CPU ranks,
against the JAX package's GSPMD runs on its virtual CPU mesh and the
port's unsharded run: tests/test_spatial_partition.py's two programs at
that file's tolerances, and a stack that reaches 7 rows over 2 ranks (the
uneven split GSPMD pads).
"""
import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu.parallel import make_mesh as jmesh

import torch_sp_cases as cases
from torch_rank_pool import RankPool

MESH = {"dp": 2, "sp": 2}
STEPS = {"small": 3, "resnet": 6, "uneven": 3}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, timeout=180.0)
    yield p
    p.close()


@pytest.fixture(scope="module")
def conv_jax():
    """Per program: the JAX startup's parameters, the batch, and the JAX
    GSPMD run's losses and parameters over MESH."""
    out = {}
    for model, steps in STEPS.items():
        main, startup, loss = cases.conv_programs(jpt, model)
        scope, exe = jpt.Scope(), jpt.Executor()
        exe.run(startup, scope=scope)
        params = {p.name: np.asarray(scope.find_var(p.name)).copy()
                  for p in main.all_parameters()}
        feed = cases.conv_feed(model)
        target = jpt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=jmesh(MESH))
        losses = [float(np.asarray(exe.run(target, feed=feed,
                                           fetch_list=[loss],
                                           scope=scope)[0]).reshape(-1)[0])
                  for _ in range(steps)]
        out[model] = (params, feed, losses,
                      {n: np.asarray(scope.find_var(n)) for n in params})
    return out


def _holds(model, losses, params, want_losses, want_params):
    """tests/test_spatial_partition.py's: losses rtol 2e-5 and weights rtol
    2e-4 / atol 1e-5; for resnet_cifar10 step 1's loss rtol 2e-5 and the
    whole trajectory 2e-2 (the statistics' sums in another association,
    amplified by momentum)."""
    if model == "resnet":
        np.testing.assert_allclose(losses[0], want_losses[0], rtol=2e-5)
        np.testing.assert_allclose(losses, want_losses, rtol=2e-2)
        return
    np.testing.assert_allclose(losses, want_losses, rtol=2e-5)
    for n in want_params:
        np.testing.assert_allclose(params[n], want_params[n], rtol=2e-4,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("model", sorted(STEPS))
def test_spatial_partition_matches_jax_gspmd(pool, conv_jax, model):
    """Each program over {"dp": 2, "sp": 2} equals the JAX GSPMD run and
    the port's one-process run, and trains."""
    params, feed, jl, jp = conv_jax[model]
    steps = STEPS[model]
    one_l, one_p = cases.conv_rank(None, model, params, feed, steps)
    for losses, glob in pool.run(4, cases.conv_rank, MESH, model, params,
                                 feed, steps):
        _holds(model, losses, glob, jl, jp)
        _holds(model, losses, glob, one_l, one_p)
        assert losses[-1] < losses[0]


@pytest.mark.parametrize("fault", ["no_halo", "local_stats"])
def test_planted_faults_fail_the_holds(pool, conv_jax, fault):
    """On the uneven stack: each rank padding its own edges where its
    neighbours' halo rows belong, or batch statistics over the rank's own
    rows: each fails the holds."""
    params, feed, jl, jp = conv_jax["uneven"]
    losses, glob = pool.run(4, cases.conv_rank, MESH, "uneven", params, feed,
                            STEPS["uneven"], fault)[0]
    with pytest.raises(AssertionError):
        _holds("uneven", losses, glob, jl, jp)
