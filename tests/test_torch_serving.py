"""The port's serving slice (paddle_tpu_torch.serving) on the CPU, held
against the JAX package's ServingEngine on `decoder_tiny` with the weights
carried across by `load_params`, and against its own dense oracle.

Logits tolerance: rtol 1e-4 / atol 1e-5 (fp32 on both sides; the two
frameworks sum in different orders). Greedy tokens must be identical."""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import decoder_tiny as j_tiny
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import Program, program_guard
from paddle_tpu_torch.serving import (PagedKVPool, SamplingParams,
                                      ServingEngine, build_full_forward_program,
                                      decoder_tiny, load_params)
from paddle_tpu_torch.serving import model as sv_model
from paddle_tpu_torch.serving.kv_cache import pool_var_names

LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(**kw):
    """A JAX engine and a port engine on the CPU computing the same function,
    both with the prefix cache off (the default is on in both packages):
    these tests hold the paged path without sharing; the prefix cache is
    held in tests/test_torch_serving_prefix.py."""
    jeng = JEngine(j_tiny(), prefix_cache=False, **kw)
    teng = ServingEngine(decoder_tiny(), device="cpu", prefix_cache=False,
                         **kw)
    load_params(teng, {p.name: np.asarray(jeng._scope.find_var(p.name))
                       for p in jeng._prefill_prog.all_parameters()})
    return jeng, teng


def _prompts(seed, lens, vocab=97):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lens]


def _assert_no_leaks(eng):
    assert eng.leaked_pages() == 0
    assert eng.pool.free_count == eng.pool.num_pages


def test_greedy_tokens_match_jax_engine():
    """Prompts crossing page (4) and bucket (8, 16, 32) boundaries, batched
    together in ragged decode steps."""
    jeng, teng = _pair(page_size=4, pool_pages=64, max_inflight=4)
    prompts = _prompts(7, (3, 9, 17, 5))
    jr = [jeng.submit(p, max_new_tokens=8) for p in prompts]
    tr = [teng.submit(p, max_new_tokens=8) for p in prompts]
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [teng.result(r) for r in tr] == [jeng.result(r) for r in jr]
    assert all(teng.requests[r].state == "finished" for r in tr)
    _assert_no_leaks(teng)


def test_prefill_and_decode_logits_match_jax():
    """One prefill and one decode step through both packages' programs on
    the same feeds: last logits and the written KV pools agree."""
    jeng, teng = _pair(page_size=4, pool_pages=16, max_inflight=2)
    n = 11
    tok = np.zeros((1, 16), np.int32)
    tok[0, :n] = _prompts(3, (n,))[0]
    feed = {sv_model.TOK_FEED: tok,
            sv_model.POS_FEED: np.arange(16, dtype=np.int32)[None, :],
            sv_model.PAGES_FEED: np.asarray([[5, 2, 9, 0]], np.int32),
            sv_model.LEN_FEED: np.asarray([n], np.int32)}
    fetch_j = [jeng._prefill_io["next_token"], jeng._prefill_io["last_logits"]]
    fetch_t = [teng._prefill_io["next_token"], teng._prefill_io["last_logits"]]
    jn, jl = jeng._exe.run(jeng._prefill_prog, feed=feed, fetch_list=fetch_j,
                           scope=jeng._scope)
    tn, tl = teng._exe.run(teng._prefill_prog, feed=feed, fetch_list=fetch_t,
                           scope=teng._scope)
    np.testing.assert_allclose(tl, jl, **LOGITS_TOL)
    assert tn.tolist() == jn.tolist()

    dfeed = {sv_model.TOK_FEED: np.asarray([[int(tn[0])], [0]], np.int32),
             sv_model.POS_FEED: np.asarray([n, 0], np.int32),
             sv_model.PAGES_FEED: np.asarray([[5, 2, 9, 0], [0, 0, 0, 0]], np.int32),
             sv_model.MASK_FEED: np.asarray([[1.0], [0.0]], np.float32)}
    jn, jl = jeng._exe.run(jeng._decode_prog, feed=dfeed, scope=jeng._scope,
                           fetch_list=[jeng._decode_io["next_token"],
                                       jeng._decode_io["logits"]])
    tn, tl = teng._exe.run(teng._decode_prog, feed=dfeed, scope=teng._scope,
                           fetch_list=[teng._decode_io["next_token"],
                                       teng._decode_io["logits"]])
    np.testing.assert_allclose(tl[0], jl[0], **LOGITS_TOL)   # live row only
    assert int(tn[0]) == int(jn[0])
    for kn, vn in pool_var_names(2):
        for name in (kn, vn):
            np.testing.assert_allclose(teng._scope.find_var(name).numpy(),
                                       np.asarray(jeng._scope.find_var(name)),
                                       **LOGITS_TOL)


def test_generation_matches_own_dense_oracle():
    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=64,
                        max_inflight=4, device="cpu", prefix_cache=False)
    prompts = _prompts(11, (3, 9, 17))
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_drained()
    full = Program()
    with program_guard(full, Program()), unique_name.guard():
        io = build_full_forward_program(eng.cfg)
    for p, rid in zip(prompts, rids):
        seq = list(p)
        for _ in range(6):
            (lg,) = eng._exe.run(
                full, scope=eng._scope, fetch_list=[io["logits"]],
                feed={sv_model.TOK_FEED: np.asarray(seq, np.int32)[None, :],
                      sv_model.POS_FEED: np.arange(len(seq), dtype=np.int32)[None, :]})
            seq.append(int(np.argmax(lg[0, -1])))
        assert eng.result(rid) == seq[len(p):]
    _assert_no_leaks(eng)


def test_preemption_recomputes_exactly_with_zero_leaks():
    """9 pages of 2 slots: both requests admit, growing both needs 16 pages,
    so the youngest is preempted and re-prefilled — same tokens as the JAX
    engine with a roomy pool, nothing leaked."""
    jeng, _ = _pair(page_size=2, pool_pages=64, max_inflight=2)
    prompts = _prompts(3, (7, 7))
    want = []
    for p in prompts:
        rid = jeng.submit(p, max_new_tokens=8)
        jeng.run_until_drained()
        want.append(jeng.result(rid))
    small = ServingEngine(decoder_tiny(), page_size=2, pool_pages=9,
                          max_inflight=2, device="cpu", prefix_cache=False)
    load_params(small, {p.name: np.asarray(jeng._scope.find_var(p.name))
                        for p in jeng._prefill_prog.all_parameters()})
    rids = [small.submit(p, max_new_tokens=8) for p in prompts]
    small.run_until_drained()
    assert small.stats["preemptions"] >= 1, "pool pressure never triggered"
    assert [small.result(r) for r in rids] == want
    _assert_no_leaks(small)


def test_pool_exhaustion_backpressures_admission():
    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=6,
                        max_inflight=8, device="cpu", prefix_cache=False)
    rids = [eng.submit(p, max_new_tokens=3) for p in _prompts(1, (9,) * 5)]
    eng.run_until_drained()
    assert all(eng.requests[r].state == "finished" for r in rids)
    assert eng.stats["peak_pages_in_use"] <= eng.pool.num_pages
    _assert_no_leaks(eng)


def test_abort_releases_pages_and_keeps_others_exact():
    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=32,
                        max_inflight=4, device="cpu", prefix_cache=False)
    ref = ServingEngine(decoder_tiny(), page_size=4, pool_pages=32,
                        max_inflight=4, device="cpu", prefix_cache=False)
    prompts = _prompts(5, (6, 10))
    a, b = (eng.submit(p, max_new_tokens=6) for p in prompts)
    rb = ref.submit(prompts[1], max_new_tokens=6)
    eng.step()
    eng.abort(a)
    assert eng.requests[a].state == "aborted" and eng.leaked_pages() == 0
    eng.run_until_drained()
    ref.run_until_drained()
    assert eng.result(b) == ref.result(rb)
    partial = eng.result(a)
    assert eng.pop_result(a) == partial and a not in eng.requests
    _assert_no_leaks(eng)


def test_oversize_request_raises_cleanly():
    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=2,
                        max_inflight=2, device="cpu", prefix_cache=False)
    with pytest.raises(ValueError, match="max_position"):
        eng.submit(list(range(1, 80)), max_new_tokens=60)
    eng.submit(_prompts(0, (20,))[0], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="pool"):
        eng.run_until_drained()


def test_sjf_policy_admits_shortest_first():
    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=64,
                        max_inflight=1, policy="sjf", device="cpu",
                        prefix_cache=False)
    long_rid, short_rid = (eng.submit(p, max_new_tokens=2)
                           for p in _prompts(5, (20, 3)))
    eng.step()
    assert eng.requests[short_rid].state in ("running", "finished")
    assert eng.requests[long_rid].state == "waiting"
    eng.run_until_drained()
    assert eng.requests[long_rid].state == "finished"


def test_sampled_tokens_depend_only_on_request_identity():
    """Host-side sampling keyed by (seed, rid, index): the same request
    draws the same tokens alone or batched with others."""
    s = SamplingParams(temperature=0.8, top_k=20)
    p = _prompts(9, (7,))[0]
    alone = ServingEngine(decoder_tiny(), page_size=4, pool_pages=64,
                          max_inflight=4, device="cpu", prefix_cache=False)
    r0 = alone.submit(p, max_new_tokens=6, sampling=s)
    alone.run_until_drained()
    batched = ServingEngine(decoder_tiny(), page_size=4, pool_pages=64,
                            max_inflight=4, device="cpu", prefix_cache=False)
    r1 = batched.submit(p, max_new_tokens=6, sampling=s)
    for q in _prompts(10, (4, 12)):
        batched.submit(q, max_new_tokens=6)
    batched.run_until_drained()
    assert alone.result(r0) == batched.result(r1)


@pytest.mark.parametrize("kw,item", [({"tp": 3}, "must divide num_heads")])
def test_unported_options_raise(kw, item):
    """tp = 3 on decoder_tiny's 2 heads raises the JAX engine's message
    (tensor-parallel serving is ported: tests/test_torch_tensor_parallel.py)."""
    with pytest.raises(ValueError, match=item):
        ServingEngine(decoder_tiny(), device="cpu", **kw)


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine()


def test_load_params_checks_names_shapes_and_dtypes():
    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=8, device="cpu")
    good = {n: eng._scope.find_var(n).numpy().copy() for n in eng.parameter_names()}
    with pytest.raises(KeyError, match="missing"):
        load_params(eng, {k: v for k, v in good.items() if k != "dec.word_emb"})
    with pytest.raises(KeyError, match="unexpected"):
        load_params(eng, dict(good, extra=np.zeros(1, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        load_params(eng, dict(good, **{"dec.word_emb": good["dec.word_emb"][:3]}))
    with pytest.raises(TypeError, match="float64"):
        load_params(eng, dict(good, **{"dec.pos_emb":
                                       good["dec.pos_emb"].astype(np.float64)}))
    good["dec.lm_head.b"][:] = 0.5
    load_params(eng, good)
    assert torch.all(eng._scope.find_var("dec.lm_head.b") == 0.5)


def test_pool_allocator_edges():
    pool = PagedKVPool(4, 8)
    assert pool.pages_for(1) == 1 and pool.pages_for(8) == 1
    assert pool.pages_for(9) == 2
    got = pool.allocate(3)
    assert len(got) == 3 and pool.free_count == 1
    assert pool.allocate(2) is None, "partial grabs must not happen"
    pool.release(got)
    assert pool.free_count == 4
    with pytest.raises(ValueError, match="double-free"):
        pool.release([got[0], got[0]])
    with pytest.raises(ValueError, match="outside pool"):
        pool.release([99])
