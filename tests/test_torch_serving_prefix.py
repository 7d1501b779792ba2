"""The port's prefix cache with copy-on-write, its speculative decoding and
its bf16 KV pools (paddle_tpu_torch.serving), on the CPU, held against the
JAX package's ServingEngine on `decoder_tiny` with the weights carried
across by `load_params`.

Tolerance for fp32 logits and pools: rtol 1e-4 / atol 1e-5 (fp32 on both
sides; the two frameworks sum in different orders). Greedy tokens and the
prefix / copy-on-write / speculation counts must be identical. bf16: the
port's tokens are held by chip_smoke's teacher-forced gate (the dense bf16
oracle's logit for each generated token within BF16_DELTA_ULPS bf16 units
of its max), since an argmax near-tie can round either way in bf16."""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import unique_name as jun
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.ops import attention_ops as jops
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import decoder_tiny as j_tiny
from paddle_tpu.serving import engine as j_engine
from paddle_tpu.serving import model as jmodel
from paddle_tpu.serving import ngram_draft as j_ngram_draft
from paddle_tpu_torch import flags
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.framework import Program, program_guard
from paddle_tpu_torch.ops import attention_ops as tops
from paddle_tpu_torch.ops.cuda_kernels import paged_attention as k1
from paddle_tpu_torch.serving import (PagedKVPool, PrefixCache, ServingEngine,
                                      decoder_tiny, load_params, ngram_draft)
from paddle_tpu_torch.serving import engine as t_engine
from paddle_tpu_torch.serving import model as tmodel
from paddle_tpu_torch.serving.kv_cache import pool_var_names

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)
STATS = ("prefix_hit_tokens", "prefix_lookups", "prefix_full_hits",
         "cow_copies", "prefill_tokens_computed", "prefills", "decode_steps",
         "decode_tokens", "preemptions", "spec_steps", "spec_proposed",
         "spec_accepted")


def _pair(dtype="float32", **kw):
    """A JAX engine and a port engine on the CPU computing the same function
    (the port takes the JAX engine's weights)."""
    jcfg = dataclasses.replace(j_tiny(), dtype=dtype)
    tcfg = dataclasses.replace(decoder_tiny(), dtype=dtype)
    jeng = JEngine(jcfg, **kw)
    teng = ServingEngine(tcfg, device="cpu", **kw)
    load_params(teng, {p.name: np.asarray(jeng._scope.find_var(p.name))
                       for p in jeng._prefill_prog.all_parameters()})
    return jeng, teng


def _rand(rng, n):
    return [int(t) for t in rng.integers(1, 97, n)]


def _serve(eng, batches, max_new=6):
    """Submit each batch of prompts together and drain it; returns every
    request's tokens in order."""
    rids = []
    for batch in batches:
        rids += [eng.submit(p, max_new_tokens=max_new) for p in batch]
        eng.run_until_drained()
    return [eng.result(r) for r in rids]


def _stats(eng):
    return {k: eng.stats[k] for k in STATS}


def _assert_drained_clean(eng):
    assert eng.leaked_pages() == 0
    assert eng.pool.check_consistency() == []
    eng.flush_prefix_cache()
    assert eng.leaked_pages() == 0
    assert eng.pool.free_count == eng.pool.num_pages


def _same_as_jax(batches, max_new=6, **kw):
    jeng, teng = _pair(**kw)
    want = _serve(jeng, batches, max_new)
    got = _serve(teng, batches, max_new)
    assert got == want
    assert _stats(teng) == _stats(jeng)
    return jeng, teng


# -- flags --------------------------------------------------------------------

def test_engine_resolves_prefix_cache_and_draft_k_from_flags():
    """The JAX package's defaults (prefix cache on, draft_k 0, tp 1), and a
    flag set at runtime reaches the next engine."""
    eng = ServingEngine(decoder_tiny(), device="cpu")
    assert isinstance(eng.prefix_cache, PrefixCache) and eng.draft_k == 0
    assert eng.tp == 1
    assert (flags.get_flag("serving_prefix_cache"),
            flags.get_flag("serving_draft_k"),
            flags.get_flag("serving_tp")) == (True, 0, 1)
    try:
        flags.set_flags({"FLAGS_serving_prefix_cache": "0",
                         "serving_draft_k": 3})
        eng = ServingEngine(decoder_tiny(), device="cpu")
        assert eng.prefix_cache is None and eng.draft_k == 3
        eng = ServingEngine(decoder_tiny(), device="cpu", prefix_cache=True,
                            draft_k=0)
        assert eng.prefix_cache is not None and eng.draft_k == 0
    finally:
        flags.set_flags({"serving_prefix_cache": True, "serving_draft_k": 0})
    with pytest.raises(ValueError, match="draft_k"):
        ServingEngine(decoder_tiny(), device="cpu", draft_k=-1)


# -- pool refcounts and the prefix index --------------------------------------

def test_pool_refcount_share_release():
    """share bumps a holder, release drops one; a page returns to the free
    list only when its last holder releases it, and over-releasing raises
    before any change."""
    pool = PagedKVPool(8, 4)
    got = pool.allocate(2)
    assert [pool.refcount(p) for p in got] == [1, 1]
    assert pool.can_allocate(6) and not pool.can_allocate(7)
    assert pool.occupancy() == 2 / 8
    pool.share(got)
    assert [pool.refcount(p) for p in got] == [2, 2]
    assert pool.release(got) == 0, "a held page must not free"
    assert pool.free_count == 6
    assert pool.release(got) == 2
    assert pool.free_count == 8
    with pytest.raises(ValueError, match="double-free"):
        pool.release([got[0]])
    with pytest.raises(ValueError, match="sharing free page"):
        pool.share([got[0]])
    with pytest.raises(ValueError, match="outside pool"):
        pool.share([8])
    more = pool.allocate(1)
    before = pool.free_count
    with pytest.raises(ValueError, match="double-free"):
        pool.release([more[0], more[0]])
    assert pool.free_count == before and pool.refcount(more[0]) == 1
    pool.free(more)
    assert pool.free_count == 8


def test_pool_consistency_audit():
    """check_consistency: clean on a live pool with the right holders; dirty
    for a phantom holder, a missing one, a free page with a refcount and a
    live page off the free list with refcount 0."""
    pool = PagedKVPool(6, 4)
    a = pool.allocate(2)
    pool.share([a[0]])
    assert pool.check_consistency() == []
    assert pool.check_consistency({a[0]: 2, a[1]: 1}) == []
    assert "live holders" in pool.check_consistency({a[0]: 1, a[1]: 1})[0]
    assert "still map it" in pool.check_consistency(
        {a[0]: 2, a[1]: 1, pool._free[0]: 1})[0]
    pool._refs[pool._free[-1]] = 1
    assert "on the free list with refcount 1" in pool.check_consistency()[0]
    pool._refs[pool._free[-1]] = 0
    pool._refs[a[1]] = 0
    assert "missing from the free list" in pool.check_consistency()[0]


def test_prefix_cache_match_insert_evict_lru():
    """Page-granular trie: full blocks match longest prefix first; eviction
    is LRU over leaves whose page only the cache holds, and never touches a
    page a request still maps (tests/test_serving_multitenant.py's case)."""
    pool = PagedKVPool(16, 4)
    cache = PrefixCache(pool)
    toks = list(range(1, 13))                      # 3 full blocks
    pages = pool.allocate(3)
    assert cache.insert(toks, pages) == 3
    dup = pool.allocate(3)
    assert cache.insert(toks, dup) == 0, "first writer wins"
    pool.release(dup)
    assert [pool.refcount(p) for p in pages] == [2, 2, 2]
    assert cache.match(toks) == pages
    assert cache.match(toks[:7]) == pages[:1], "partial block must not match"
    assert cache.match([99] + toks[1:]) == []
    pool.release(pages)
    other = pool.allocate(2)
    cache.insert(list(range(50, 58)), other)
    pool.release(other)
    cache.match(toks)                              # refresh chain 1
    assert cache.evict(1) == 1
    assert cache.match(list(range(50, 58))) == other[:1], (
        "LRU evicts the stale chain's leaf first")
    pool.share([pages[0]])
    cache.evict(16)
    assert cache.match(toks[:4]) == pages[:1], "a mapped page was evicted"
    pool.release([pages[0]])
    assert cache.flush() == 1
    assert cache.pages_held == 0
    assert (cache.inserted_pages, cache.evicted_pages) == (5, 5)


def test_prefix_cache_clear_drops_the_index_without_releasing():
    pool = PagedKVPool(8, 2)
    cache = PrefixCache(pool)
    pages = pool.allocate(2)
    cache.insert([1, 2, 3, 4], pages)
    pool.release(pages)
    assert cache.clear() == 2
    assert cache.match([1, 2, 3, 4]) == [] and pool.pages_in_use == 2


# -- ops ----------------------------------------------------------------------

def _pools(rng, num_pages=12, ps=4, nh=2, dh=8, dtype=np.float32):
    return [rng.standard_normal((num_pages, ps, nh, dh)).astype(dtype)
            for _ in range(2)]


def test_windowed_prefill_write_matches_jax():
    """kv_cache_prefill_write with Start: local position s of row b writes
    slot start[b] + s where s < lens[b] (a row of lens 0 writes nothing),
    across page boundaries."""
    rng = np.random.default_rng(0)
    kp, vp = _pools(rng)
    k = rng.standard_normal((3, 2, 5, 8)).astype(np.float32)
    v = rng.standard_normal((3, 2, 5, 8)).astype(np.float32)
    table = np.asarray([[3, 7, 1], [0, 2, 5], [9, 9, 9]], np.int32)
    lens = np.asarray([5, 2, 0], np.int32)
    start = np.asarray([2, 6, 1], np.int32)
    jk, jv = jops.kv_cache_prefill_write_fn(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(start))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tops.kv_cache_prefill_write_(
        tk, tv, torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(lens),
        torch.from_numpy(start))
    assert out[0] is tk and out[1] is tv, "the write is in place"
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(tk.numpy(), kp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_attention_matches_jax(dtype):
    """The window attention over the pool (query s attends slots 0..start +
    s), the torch composition of the JAX package's XLA gather reference:
    fp32 to LOGITS_TOL, bf16 to two units of its last place."""
    rng = np.random.default_rng(1)
    kp, vp = _pools(rng)
    q = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    table = np.asarray([[4, 1, 8], [2, 0, 6]], np.int32)
    start = np.asarray([5, 0], np.int32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jops.paged_prefill_attention_fn(
        jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
        jnp.asarray(table), jnp.asarray(start), sm_scale=8 ** -0.5)
    got = tops.paged_prefill_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kp).to(td),
        torch.from_numpy(vp).to(td), torch.from_numpy(table),
        torch.from_numpy(start), sm_scale=8 ** -0.5)
    assert got.dtype == td
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


def test_copy_page_matches_jax_in_place():
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng)
    src, dst = np.asarray([3], np.int32), np.asarray([9], np.int32)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tops.kv_cache_copy_page_(tk, tv, torch.from_numpy(src),
                                   torch.from_numpy(dst))
    assert out[0] is tk and out[1] is tv
    jk, jv = jnp.asarray(kp).at[9].set(kp[3]), jnp.asarray(vp).at[9].set(vp[3])
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_decode_plain_bf16_matches_jax_reference(seed):
    """K1's plain version in bf16 against the JAX package's
    `_paged_attention_reference` in bf16 (scores and their scale in bf16,
    an fp32 softmax, the probabilities rounded to bf16 before the PV
    product), over padded and out-of-range table entries and a kv_len 0
    row: two units of bf16's last place."""
    rng = np.random.default_rng(seed)
    kp, vp = _pools(rng, num_pages=20, ps=4, nh=3, dh=40)
    q = rng.standard_normal((4, 3, 40)).astype(np.float32)
    table = rng.integers(-2, 23, (4, 6)).astype(np.int32)
    lens = np.asarray([0, 1, 13, 24], np.int32)
    want = jops._paged_attention_reference(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(table), jnp.asarray(lens),
        sm_scale=40 ** -0.5)
    got = k1.paged_decode_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)),
        torch.from_numpy(table), torch.from_numpy(lens), sm_scale=40 ** -0.5)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


# -- the window and copy-on-write programs -----------------------------------

def _build(which, Prog, guard, un, mod, cfg):
    main, startup = Prog(), Prog()
    with guard(main, startup), un.guard():
        getattr(mod, which)(cfg, 16, 4)
    return main, startup


@pytest.mark.parametrize("which", ["build_window_program",
                                   "build_cow_program"])
def test_window_and_cow_programs_equal_jax(which):
    """Op for op, var for var and dtype for dtype (to_dict), the startup
    programs too, in fp32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        t = _build(which, Program, program_guard, tun, tmodel,
                   dataclasses.replace(tmodel.decoder_tiny(), dtype=dtype))
        j = _build(which, JProgram, jguard, jun, jmodel,
                   dataclasses.replace(jmodel.decoder_tiny(), dtype=dtype))
        assert t[0].to_dict() == j[0].to_dict()
        assert t[1].to_dict() == j[1].to_dict()


def _run_window(eng, feed, io_keys=("next_token", "tokens", "logits")):
    return eng._exe.run(eng._window_prog, feed=feed, scope=eng._scope,
                        fetch_list=[eng._window_io[k] for k in io_keys])


def _pool_arrays(eng):
    return [np.asarray(eng._scope.find_var(n)) if not torch.is_tensor(
        eng._scope.find_var(n)) else eng._scope.find_var(n).numpy()
        for kv in pool_var_names(eng.cfg.num_layers) for n in kv]


def test_suffix_prefill_and_verify_windows_match_jax():
    """One suffix-prefill window past a cached prefix (3 cached pages,
    Start 12, 5 valid of an 8-slot bucket) and one verify window (2 rows of
    S = 4, one padded row with Lens 0) through both packages' window
    programs on the same pools: logits, greedy tokens and the written
    pools agree."""
    jeng, teng = _pair(page_size=4, pool_pages=16, max_inflight=2,
                       prefix_cache=True)
    rng = np.random.default_rng(4)
    # the cached prefix: one whole-prompt prefill of 12 tokens in both; the
    # finished request released its pages, the cache holds the 3 full ones
    prompt = _rand(rng, 12)
    for eng in (jeng, teng):
        eng.submit(prompt, max_new_tokens=1)
        eng.run_until_drained()
    table = jeng.prefix_cache.match(prompt)
    assert table == teng.prefix_cache.match(prompt) and len(table) == 3
    spare = [p for p in range(16) if p not in table]
    tok = np.zeros((1, 8), np.int32)
    tok[0, :5] = _rand(rng, 5)
    feed = {tmodel.TOK_FEED: tok,
            tmodel.POS_FEED: (12 + np.arange(8, dtype=np.int32))[None, :],
            tmodel.PAGES_FEED: np.asarray([table + spare[:5]], np.int32),
            tmodel.START_FEED: np.asarray([12], np.int32),
            tmodel.LEN_FEED: np.asarray([5], np.int32)}
    jn, jt, jl = _run_window(jeng, feed)
    tn, tt, tl = _run_window(teng, feed)
    np.testing.assert_allclose(tl[0, :5], np.asarray(jl)[0, :5], **LOGITS_TOL)
    assert tn.tolist() == np.asarray(jn).tolist()
    assert tt[0, :5].tolist() == np.asarray(jt)[0, :5].tolist()
    for t, j in zip(_pool_arrays(teng), _pool_arrays(jeng)):
        np.testing.assert_allclose(t, j, **LOGITS_TOL)

    vfeed = {tmodel.TOK_FEED: np.asarray([[int(tn[0])] + _rand(rng, 3),
                                          _rand(rng, 4), [0] * 4], np.int32),
             tmodel.POS_FEED: np.asarray([17 + np.arange(4), np.arange(4),
                                          np.zeros(4)], np.int32),
             tmodel.PAGES_FEED: np.asarray([table + spare[:3],
                                            spare[5:7] + [0] * 4,
                                            [0] * 6], np.int32),
             tmodel.START_FEED: np.asarray([17, 0, 0], np.int32),
             tmodel.LEN_FEED: np.asarray([4, 3, 0], np.int32)}
    jn, jt, jl = _run_window(jeng, vfeed)
    tn, tt, tl = _run_window(teng, vfeed)
    np.testing.assert_allclose(tl[:2], np.asarray(jl)[:2], **LOGITS_TOL)
    assert tt[:2].tolist() == np.asarray(jt)[:2].tolist()
    for t, j in zip(_pool_arrays(teng), _pool_arrays(jeng)):
        np.testing.assert_allclose(t, j, **LOGITS_TOL)


# -- the prefix cache through the engine --------------------------------------

def test_shared_prefix_requests_match_jax_engine():
    """Requests sharing a 12-token system prompt, admitted together: the
    later ones map the first one's pages and prefill only their suffixes
    (the window program); tokens and counts equal the JAX engine's and the
    prefix_cache=False engine's tokens."""
    rng = np.random.default_rng(11)
    sysp = _rand(rng, 12)
    batches = [[sysp + _rand(rng, 3) for _ in range(3)]]
    jeng, teng = _same_as_jax(batches, page_size=4, pool_pages=64,
                              max_inflight=4, prefix_cache=True)
    st = teng.stats
    assert st["prefix_hit_tokens"] == 2 * 12
    assert st["prefill_tokens_computed"] == 3 * 15 - 24
    _, off = _pair(page_size=4, pool_pages=64, max_inflight=4,
                   prefix_cache=False)
    load_params(off, {n: teng._scope.find_var(n).numpy()
                      for n in teng.parameter_names()})
    assert _serve(off, batches) == [teng.result(r) for r in range(3)]
    _assert_drained_clean(teng)


def test_full_prefix_hit_cow_and_isolation_match_jax():
    """A page-aligned prompt served, then served again: the second is a
    full hit (no prefill), its first decode step copies the shared tail
    page, and both requests' tokens equal the JAX engine's."""
    rng = np.random.default_rng(5)
    prompt = _rand(rng, 8)
    jeng, teng = _same_as_jax([[prompt], [prompt], [prompt, prompt]],
                              max_new=5, page_size=4, pool_pages=64,
                              max_inflight=4, prefix_cache=True)
    st = teng.stats
    assert st["prefix_full_hits"] == 3 and st["cow_copies"] == 3
    assert st["prefill_tokens_computed"] == 8
    outs = [teng.result(r) for r in range(4)]
    assert outs.count(outs[0]) == 4
    _assert_drained_clean(teng)


def test_prefix_cache_evicts_under_pool_pressure_like_jax():
    """A pool mostly full of cached prompts still admits new work: unshared
    cache entries evict LRU first (tests/test_serving_multitenant.py's
    case), step for step as the JAX engine."""
    rng = np.random.default_rng(9)
    batches = [[_rand(rng, 8)] for _ in range(4)] + [[_rand(rng, 20)]]
    jeng, teng = _same_as_jax(batches, max_new=3, page_size=4, pool_pages=12,
                              max_inflight=2, prefix_cache=True)
    assert teng.prefix_cache.evicted_pages == jeng.prefix_cache.evicted_pages
    assert teng.prefix_cache.evicted_pages > 0, "pressure never evicted"
    assert teng.leaked_pages() == 0


def test_admission_pins_the_match_before_allocating_like_jax():
    """Pool-pressure admission with a prefix hit (tests/
    test_serving_multitenant.py's case): the eviction relief must never
    reclaim the pages match() just returned, or one physical page would
    map at two ordinals; the pin stays on a failed admission. Step for
    step against the JAX engine, with the page tables audited each step."""
    rng = np.random.default_rng(17)
    hot, cold, tail = _rand(rng, 8), _rand(rng, 8), _rand(rng, 12)
    jeng, teng = _pair(page_size=4, pool_pages=8, max_inflight=4,
                       prefix_cache=True)
    for eng in (jeng, teng):
        r1 = eng.submit(hot, max_new_tokens=8)
        eng.step()
        r2 = eng.submit(cold, max_new_tokens=1)
        while eng.requests[r2].state != "finished":
            eng.step()
        while len(eng.requests[r1].pages) < 4:
            eng.step()
        r3 = eng.submit(cold + tail, max_new_tokens=4)
        while eng.has_work():
            eng.step()
            for r in eng.requests.values():
                assert len(set(r.pages)) == len(r.pages), r.pages
            assert eng.leaked_pages() == 0
    assert ([teng.result(r) for r in (r1, r2, r3)]
            == [jeng.result(r) for r in (r1, r2, r3)])
    assert _stats(teng) == _stats(jeng)
    _assert_drained_clean(teng)


def test_failed_admission_keeps_its_pin_and_abort_releases_it():
    """A waiting request whose private pages do not fit keeps its matched
    pages pinned (refcount held) until it is admitted or aborted."""
    rng = np.random.default_rng(3)
    sysp = _rand(rng, 8)
    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=6,
                        max_inflight=4, prefix_cache=True, device="cpu")
    eng.submit(sysp, max_new_tokens=1)
    eng.run_until_drained()
    big = eng.submit(_rand(rng, 12), max_new_tokens=8)    # 4 private pages
    eng.step()
    waiter = eng.submit(sysp + _rand(rng, 9), max_new_tokens=4)
    eng.step()
    req = eng.requests[waiter]
    assert req.state == "waiting" and len(req.pages) == 2
    assert req.cached_len == 8
    assert all(eng.pool.refcount(p) == 2 for p in req.pages)
    eng.abort(waiter)
    assert req.pages == [] and req.cached_len == 0
    assert eng.leaked_pages() == 0
    eng.run_until_drained()
    assert eng.requests[big].state == "finished"
    _assert_drained_clean(eng)


# -- speculative decoding -----------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_ngram_draft_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 300))
        toks = [int(t) for t in rng.integers(0, int(rng.integers(2, 12)), n)]
        k = int(rng.integers(0, 6))
        assert ngram_draft(toks, k) == j_ngram_draft(toks, k)
        assert ngram_draft(toks, k, window=16) == j_ngram_draft(toks, k,
                                                                window=16)
    assert ngram_draft([1, 2, 3, 9, 1, 2, 3], 3) == [9, 1, 2]
    assert ngram_draft([7], 2) == [7, 7]


@pytest.mark.parametrize("k", [1, 3])
def test_spec_decode_matches_plain_greedy_and_jax(k):
    """draft_k in {1, 3} gives the plain greedy sequence bit for bit, with
    the JAX engine's speculative steps, proposals and acceptances."""
    rng = np.random.default_rng(7)
    batches = [[_rand(rng, n) for n in (3, 9, 17)]]
    _, plain = _pair(page_size=4, pool_pages=64, max_inflight=4,
                     prefix_cache=False, draft_k=0)
    want = _serve(plain, batches)
    jeng, teng = _same_as_jax(batches, page_size=4, pool_pages=64,
                              max_inflight=4, prefix_cache=True, draft_k=k)
    load_params(plain, {n: teng._scope.find_var(n).numpy()
                        for n in teng.parameter_names()})
    assert _serve(plain, batches) == [teng.result(r) for r in range(3)]
    assert teng.stats["spec_steps"] > 0
    assert want and teng.leaked_pages() == 0


def test_forced_full_acceptance(monkeypatch):
    """With the proposer swapped for the known greedy continuation, every
    draft is accepted (the multi-token acceptance path) and the tokens are
    unchanged, in both packages, with the same counts."""
    rng = np.random.default_rng(13)
    prompts = [_rand(rng, n) for n in (4, 11)]
    jeng, teng = _pair(page_size=4, pool_pages=64, max_inflight=4,
                       prefix_cache=True, draft_k=3)
    want = _serve(teng, [prompts], max_new=9)
    _serve(jeng, [prompts], max_new=9)
    known = [p + w for p, w in zip(prompts, want)]

    def oracle(tokens, k, window=128):
        tokens = [int(t) for t in tokens]
        seq = next(s for s in known if s[:len(tokens)] == tokens)
        cont = seq[len(tokens):len(tokens) + k]
        return cont + [tokens[-1]] * (k - len(cont))

    monkeypatch.setattr(t_engine, "ngram_draft", oracle)
    monkeypatch.setattr(j_engine, "ngram_draft", oracle)
    before = _stats(teng)
    assert _serve(teng, [prompts], max_new=9) == want
    assert _serve(jeng, [prompts], max_new=9) == want
    prop = teng.stats["spec_proposed"] - before["spec_proposed"]
    acc = teng.stats["spec_accepted"] - before["spec_accepted"]
    assert prop > 0 and acc == prop
    assert teng.stats["spec_steps"] - before["spec_steps"] <= 3
    assert _stats(teng) == _stats(jeng)


def test_abort_under_speculation_keeps_refcounts_balanced():
    """Aborts while speculative windows run over shared prefixes
    (tests/test_serving_multitenant.py's chaos case, the aborts made by
    hand at fixed steps): lookahead pages, copy-on-write copies and shared
    mappings all release exactly once, every cycle."""
    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=32,
                        max_inflight=4, prefix_cache=True, draft_k=3,
                        device="cpu")
    rng = np.random.default_rng(17)
    sysp = _rand(rng, 8)
    for cycle in range(3):
        rids = [eng.submit(sysp + _rand(rng, n), max_new_tokens=6)
                for n in (0, 4, 9)]
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
            if steps in (1, 3):
                live = [r for r in rids
                        if eng.requests[r].state in ("running", "waiting")]
                if live:
                    eng.abort(live[0])
            holders: dict[int, int] = {}
            for r in eng.requests.values():
                for p in r.pages:
                    holders[p] = holders.get(p, 0) + 1
            for node in eng.prefix_cache._nodes.values():
                holders[node.page] = holders.get(node.page, 0) + 1
            assert eng.pool.check_consistency(holders) == []
        states = {eng.requests[r].state for r in rids}
        assert states <= {"finished", "aborted"} and "aborted" in states
        assert eng.leaked_pages() == 0, f"cycle {cycle} orphaned pages"
    _assert_drained_clean(eng)


# -- bf16 pools ---------------------------------------------------------------

@pytest.mark.parametrize("draft_k", [0, 3])
def test_bf16_engine_matches_jax_under_the_delta_gate(draft_k):
    """A bf16 decoder_tiny engine (prefix cache on) against the JAX bf16
    engine on the same weights: the port's tokens pass chip_smoke's
    teacher-forced gate against its own dense bf16 oracle, and against the
    JAX engine's tokens the same gate decides every position where they
    differ; the prefix and copy-on-write counts equal the JAX engine's."""
    rng = np.random.default_rng(21)
    sysp = _rand(rng, 12)
    batches = [[sysp + _rand(rng, 3), sysp + _rand(rng, 6)],
               [sysp[:8], sysp[:8]], [_rand(rng, n) for n in (5, 17)]]
    jeng, teng = _pair("bfloat16", page_size=4, pool_pages=64, max_inflight=4,
                       prefix_cache=True, draft_k=draft_k)
    jout = _serve(jeng, batches)
    tout = _serve(teng, batches)
    prompts = [p for b in batches for p in b]
    n, differ, worst = chip_smoke._hold_delta("bf16 port engine", teng,
                                              prompts, tout)
    assert n == 6 * len(prompts) and worst <= chip_smoke.BF16_DELTA_ULPS
    chip_smoke._hold_delta("bf16 JAX engine", teng, prompts, jout)
    for k in ("prefix_hit_tokens", "prefix_full_hits", "cow_copies",
              "prefix_lookups"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.leaked_pages() == 0
    _assert_drained_clean(teng)
