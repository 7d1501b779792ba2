"""ring_attention of the port (its op, hand-written grad and layer) on gloo
CPU ranks against the JAX package's ring tests (tests/test_attention.py
:62, :90, :116, :160), whose JAX side runs here under shard_map on the
virtual CPU mesh of tests/conftest.py. The port side runs in spawned ranks
(tests/torch_rank_pool.py), the per-rank code in tests/torch_tp_cases.py.
"""
import numpy as np
import pytest

import paddle_tpu as jpt

import torch_tp_cases as cases
from torch_rank_pool import RankPool


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, timeout=120.0)
    yield p
    p.close()


def _jax_ring(q, k, v, sp, causal):
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.ops.attention_ops import ring_attention_local
    from paddle_tpu.ops.collective_ops import compat_shard_map
    from paddle_tpu.parallel import make_mesh

    dh = q.shape[-1]
    fn = compat_shard_map(
        lambda a, b, c: ring_attention_local(a, b, c, "sp", causal=causal,
                                             sm_scale=dh ** -0.5),
        mesh=make_mesh({"sp": sp}), in_specs=(P(None, None, "sp", None),) * 3,
        out_specs=P(None, None, "sp", None))
    return fn


def _port(pool, q, k, v, causal, do=None, sp=4):
    do = np.ones_like(q) if do is None else do
    outs = pool.run(sp, cases.ring_rank, q, k, v, causal, do, sp)
    return [np.concatenate([o[i] for o in outs], axis=2) for i in range(4)]


@pytest.mark.parametrize("causal,shape,seed,jsp", [
    (False, (2, 2, 64, 8), 2, 8), (True, (1, 2, 32, 8), 3, 4)],
    ids=["full", "causal"])
def test_ring_attention_matches_the_jax_ring(pool, causal, shape, seed, jsp):
    """test_attention.py:62 (sp = 8 in JAX) and :90 (sp = 4): the port's 4
    ranks give the JAX ring's output at its tolerances."""
    import jax

    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax.jit(_jax_ring(q, k, v, jsp, causal))(q, k, v))
    got = _port(pool, q, k, v, causal)[0]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grads_match_jax(pool, causal):
    """test_attention.py:116: the gradients of sum(out) through the ring
    (the hand-written grad op, dK and dV carried home round the ring) are
    the JAX ring's dQ and full attention's dK and dV."""
    import jax

    from paddle_tpu.ops.attention_ops import _reference_attention

    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 1, 16, 4)).astype(np.float32)
               for _ in range(3))
    ring = jax.jit(_jax_ring(q, k, v, 4, causal))
    gq = jax.grad(lambda a: ring(a, k, v).sum())(q)
    gk, gv = jax.grad(lambda b, c: _reference_attention(
        q, b, c, causal=causal, sm_scale=0.5).sum(), argnums=(0, 1))(k, v)
    _, dq, dk, dv = _port(pool, q, k, v, causal)
    for got, want in ((dq, gq), (dk, gk), (dv, gv)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4,
                                   atol=5e-5)


def test_ring_attention_program_trains_under_collective(pool):
    """test_attention.py:160: L.ring_attention in a program, its grad op
    appended by append_backward, run under with_collective on an sp mesh
    of 4 ranks (the feeds split on their annotated seq dim, the fleet
    averaging the gradients over sp): q's weights after 4 SGD steps are
    the JAX package's one-device run's."""
    B, nh, S, dh = 2, 2, 16, 4
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, nh, S, dh)).astype(np.float32)
    t = rng.standard_normal((B, nh, S, dh)).astype(np.float32)
    main, startup = jpt.Program(), jpt.Program()
    main.random_seed = startup.random_seed = 9
    with jpt.program_guard(main, startup), jpt.unique_name.guard():
        loss = cases.ring_program(jpt, False)
        jpt.optimizer.SGD(0.1).minimize(loss)
    exe, scope = jpt.Executor(), jpt.Scope()
    exe.run(startup, scope=scope)
    w0 = np.asarray(scope.find_var("q.w_0"))
    b0 = np.asarray(scope.find_var("q.b_0"))
    for _ in range(4):
        exe.run(main, feed={"x": x, "t": t}, fetch_list=[loss.name],
                scope=scope)
    want = np.asarray(scope.find_var("q.w_0"))
    for got in pool.run(4, cases.ring_train_rank, x, t, w0, b0, 4):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_ring_attention_unbound_is_fused_attention_on_one_process():
    """With no ring bound the op is fused_attention on the local sequence
    (test_attention.py's single-device run), forward and grads."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import layers as L

    rng = np.random.default_rng(1)
    q, k, v, cot = (rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
                    for _ in range(4))
    outs = {}
    for op in ("ring", "fused"):
        main = tpt.Program()
        with tpt.program_guard(main, tpt.Program()), tpt.unique_name.guard():
            ins = []
            for n in ("q", "k", "v"):
                x = L.data(name=n, shape=[2, 16, 8], dtype="float32")
                x.stop_gradient = False
                ins.append(x)
            out = (L.ring_attention(*ins, causal=True) if op == "ring"
                   else L.fused_attention(*ins, causal=True))
            c = L.data(name="cot", shape=[2, 16, 8], dtype="float32")
            tpt.backward.append_backward(
                L.reduce_sum(L.elementwise_mul(out, c)))
        outs[op] = tpt.Executor(place="cpu").run(
            main, feed={"q": q, "k": k, "v": v, "cot": cot},
            fetch_list=[out, "q@GRAD", "k@GRAD", "v@GRAD"],
            scope=tpt.Scope())
    for a, b in zip(outs["ring"], outs["fused"]):
        np.testing.assert_array_equal(a, b)
