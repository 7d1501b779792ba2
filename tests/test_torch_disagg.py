"""The port's disaggregated prefill/decode serving on the CPU: the lease
ledger of `PagedKVPool` and leases as holders in its audit, the handoff
state machine (`HandoffManager`: prepare -> commit, the reaper under an
injected clock, double commit and commit after reap refused, abandon and
supersede), role validation, and role-split fleets
(`disagg_fleet_factory`: one shared pool, one shared scope) whose greedy
tokens equal the JAX engine's on `decoder_tiny` with its weights — fault
free, with a shared prefix and speculation, through the lease-expiry race,
a prefill kill before commit, a dropped handoff reaped and replayed, and a
decode kill holding adopted pages. The shared scope's invariants: a later
engine neither re-initializes the weights nor zeroes live KV."""
import pytest
import torch

from torch_serving_parity import (ENGINE_KW, fleet_prompts, jax_oracle,
                                  jax_params)

from paddle_tpu.serving.fleet.handoff import HandoffManager as JHandoff
from paddle_tpu.serving.kv_cache import PagedKVPool as JPool
from paddle_tpu_torch.resilience.faults import fault_scope
from paddle_tpu_torch.serving import (FleetRouter, PagedKVPool, ServingEngine,
                                      decoder_tiny, disagg_fleet_factory,
                                      load_params)
from paddle_tpu_torch.serving.fleet.handoff import (COMMITTED, REAPED,
                                                    HandoffError,
                                                    HandoffManager,
                                                    LeaseExpired)
from paddle_tpu_torch.serving.kv_cache import pool_var_names


def _factory(**kw):
    """disagg_fleet_factory on the CPU; each engine it builds writes the
    JAX engine's weights into the shared scope (its own startup run put the
    port's seed-0 init there)."""
    base = disagg_fleet_factory(decoder_tiny(), device="cpu",
                                **dict(ENGINE_KW, **kw))

    def factory(role="mixed"):
        eng = base(role)
        load_params(eng, jax_params())
        return eng

    factory.shared_pool = base.shared_pool
    factory.shared_scope = base.shared_scope
    return factory


def _fleet(roles, heartbeat_s=30.0, lease_ttl_s=None, affinity=False, **kw):
    return FleetRouter(_factory(**kw), len(roles), roles=list(roles),
                       heartbeat_s=heartbeat_s, affinity=affinity,
                       lease_ttl_s=lease_ttl_s)


def _serve(fr, prompts, max_new, plan=None):
    fids = [fr.submit(p, max_new) for p in prompts]
    if plan is not None:
        with fault_scope(plan):
            fr.run_until_idle()
    else:
        fr.run_until_idle()
    assert all(fr.state(f) == "finished" for f in fids), \
        {f: fr.state(f) for f in fids}
    return [fr.result(f) for f in fids]


def _warm(fr, n=1):
    fids = [fr.submit([9, 8, 7], 2) for _ in range(n)]
    fr.run_until_idle()
    assert all(fr.state(f) == "finished" for f in fids)
    fr.reset_stats()


def _assert_clean(fr):
    """No lease left PREPARED, a clean shared-pool audit, zero leaked pages
    on every surviving engine, every lease reclaimed exactly once (granted
    = committed + reaped), no replay divergence."""
    hm = fr.handoff
    assert hm.active() == 0
    assert hm.pool.check_consistency(None) == []
    assert hm.pool.leased_page_count == 0
    assert hm.stats["granted"] == hm.stats["committed"] + hm.stats["reaped"]
    for rep in fr.replicas:
        if rep.alive:
            assert rep.engine.leaked_pages() == 0, f"replica {rep.rid}"
            assert rep.engine.audit_pool()[0] == []
    assert fr.stats["replay_divergence"] == 0


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- leases in the pool ------------------------------------------------------

def test_lease_is_first_class_audit_holder_and_forged_lease_is_dirty():
    for Pool in (PagedKVPool, JPool):   # the same ledger in both packages
        pool = Pool(8, 4)
        pages = pool.allocate(2)
        holders = {p: 1 for p in pages}
        pool.lease_grant("l0", pages)
        assert pool.check_consistency(holders) == []
        assert pool.leased_page_count == 2
        with pytest.raises(ValueError):
            pool.lease_grant("l0", pages)
        pool.release(pages)
        assert pool.check_consistency({}) == []
        assert all(p not in pool._free for p in pages)
        assert sorted(pool.lease_transfer("l0")) == sorted(pages)
        assert pool.leased_page_count == 0
        assert pool.check_consistency({p: 1 for p in pages}) == []
        assert pool.release(pages) == 2
        held = pool.allocate(1)
        pool._leases["forged"] = [held[0], held[0]]
        problems = pool.check_consistency({held[0]: 1})
        assert any("forged or duplicate lease" in p for p in problems)
        del pool._leases["forged"]
        pool.release(held)
        assert pool.check_consistency({}) == []


def test_lease_release_reclaims_the_orphaned_pin():
    pool = PagedKVPool(8, 4)
    pages = pool.allocate(3)
    pool.lease_grant("l0", pages)
    pool.release(pages)
    assert pool.lease_release("l0") == 3
    assert pool.check_consistency({}) == []
    assert len(pool._free) == 8
    with pytest.raises(KeyError):
        pool.lease_release("l0")


# -- the handoff state machine -----------------------------------------------

def _manager(pool, ttl_s=5.0, cls=HandoffManager):
    clk = _Clock()
    return cls(pool, ttl_s=ttl_s, clock=clk), clk


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_handoff_prepare_then_commit_happy_path(pkg):
    pool = PagedKVPool(8, 4) if pkg == "port" else JPool(8, 4)
    pages = pool.allocate(2)
    hm, clk = _manager(pool, cls=HandoffManager if pkg == "port" else JHandoff)
    lid = hm.prepare(7, {"pages": pages})
    assert lid == "lease-0" and hm.active() == 1
    assert hm.is_current(hm.leases[lid])
    clk.t = 1.0
    lease = hm.commit(lid)
    assert lease.state == COMMITTED and lease.pages == pages
    assert hm.active() == 0 and pool.leased_page_count == 0
    assert pool.check_consistency({p: 2 for p in pages}) == []
    assert hm.stats == {"granted": 1, "committed": 1, "reaped": 0,
                        "expired_at_commit": 0, "commit_failed": 0}


def test_handoff_reaper_reclaims_expired_lease():
    pool = PagedKVPool(8, 4)
    pages = pool.allocate(2)
    hm, clk = _manager(pool)
    lid = hm.prepare(1, {"pages": pages})
    pool.release(pages)
    clk.t = 4.0
    assert hm.reap_expired() == []
    clk.t = 5.5
    reaped = hm.reap_expired()
    assert [l.lease_id for l in reaped] == [lid]
    assert reaped[0].state == REAPED
    assert len(pool._free) == 8
    assert hm.reap_expired() == []
    assert hm.stats["reaped"] == 1


def test_handoff_double_commit_rejected():
    pool = PagedKVPool(8, 4)
    pages = pool.allocate(1)
    hm, _ = _manager(pool)
    lid = hm.prepare(1, {"pages": pages})
    hm.commit(lid)
    with pytest.raises(HandoffError, match="double commit"):
        hm.commit(lid)
    with pytest.raises(HandoffError, match="unknown lease"):
        hm.commit("lease-404")
    assert hm.stats["commit_failed"] == 2
    assert pool.check_consistency({pages[0]: 2}) == []


def test_handoff_commit_after_reap_and_expiry_race_reclaim_exactly_once():
    pool = PagedKVPool(8, 4)
    hm, clk = _manager(pool)
    a = pool.allocate(1)
    lid = hm.prepare(1, {"pages": a})
    pool.release(a)
    clk.t = 6.0
    hm.reap_expired()
    with pytest.raises(LeaseExpired, match="after reap"):
        hm.commit(lid)
    assert len(pool._free) == 8
    b = pool.allocate(1)
    lid2 = hm.prepare(2, {"pages": b})
    pool.release(b)
    clk.t = 20.0
    with pytest.raises(LeaseExpired, match="expired before commit"):
        hm.commit(lid2)
    assert hm.leases[lid2].state == REAPED
    assert len(pool._free) == 8
    assert (hm.stats["expired_at_commit"], hm.stats["reaped"]) == (1, 2)


def test_handoff_abandon_and_supersede():
    pool = PagedKVPool(8, 4)
    hm, _ = _manager(pool)
    pages = pool.allocate(1)
    lid = hm.prepare(1, {"pages": pages})
    hm.supersede(1)
    assert not hm.is_current(hm.leases[lid])
    assert hm.abandon(lid)
    assert not hm.abandon(lid)
    assert hm.leases[lid].state == REAPED
    assert pool.leased_page_count == 0
    lid2 = hm.prepare(2, {"pages": pages})
    hm.commit(lid2)
    assert not hm.abandon(lid2)


def test_roles_are_validated_at_construction():
    fac = _factory(max_inflight=2)
    with pytest.raises(ValueError, match="at least one"):
        FleetRouter(fac, 2, roles=["prefill", "prefill"])
    with pytest.raises(ValueError, match="roles"):
        FleetRouter(fac, 3, roles=["prefill", "decode"])
    with pytest.raises(ValueError, match="inline"):
        FleetRouter(fac, 2, roles=["prefill", "decode"], pump="threads")

    def plain(role="mixed"):
        return ServingEngine(decoder_tiny(), device="cpu",
                             **dict(ENGINE_KW, max_inflight=2))
    with pytest.raises(ValueError, match="disagg_fleet_factory"):
        FleetRouter(plain, 2, roles=["prefill", "decode"])


# -- the shared scope --------------------------------------------------------

def test_shared_scope_engine_added_later_keeps_weights_and_live_kv():
    """An engine built on a live shared scope runs the startup again with
    the same seed and generator counter: the weights come out bit for bit
    the same (a no-op), and the KV pools, already there, are not created
    again (a peer's live context survives)."""
    fac = disagg_fleet_factory(decoder_tiny(), device="cpu", **ENGINE_KW)
    first = fac("prefill")
    rid = first.submit([5, 6, 7, 8, 9], 2)
    first.step()   # prefill: the pools now hold this request's context
    assert first.requests[rid].state == "running"
    scope = fac.shared_scope
    names = first.parameter_names()
    before = {n: scope.find_var(n).clone() for n in names}
    k0 = pool_var_names(first.cfg.num_layers)[0][0]
    pool_before = scope.find_var(k0)
    live = pool_before.clone()
    assert live.abs().sum() > 0
    fac("decode")
    for n in names:
        assert torch.equal(scope.find_var(n), before[n]), n
    assert scope.find_var(k0) is pool_before
    assert torch.equal(scope.find_var(k0), live)


# -- role-split fleets against the JAX engine --------------------------------

def test_disagg_affinity_greedy_exactness_and_lease_expiry_race():
    prompts = fleet_prompts(5)
    want = jax_oracle(prompts, 7)
    with _fleet(["prefill", "decode", "decode"], affinity=True) as fr:
        decode_rids = {r.rid for r in fr.replicas if r.role == "decode"}
        for p in fleet_prompts(12, seed=3):
            assert fr._affinity_rid(p) in decode_rids
        got = _serve(fr, prompts, 7)
        again = _serve(fr, prompts, 7)
        assert fr.handoff.stats["committed"] >= 1
        assert fr.stats["handoff.replays"] == 0
        assert fr.stats["affinity_hits"] == 10
        assert fr.stats["prefill_dispatches"] == 10
        pre = next(r for r in fr.replicas if r.role == "prefill")
        assert pre.engine.stats["handoff_extracts"] >= 1
        assert pre.engine.stats["adopts"] == 0
        assert pre.engine.stats["decode_steps"] == 0
        assert sum(r.engine.stats["adopts"] for r in fr.replicas
                   if r.role == "decode") >= 1
        _assert_clean(fr)
        fr.reset_stats()
        race = fleet_prompts(3)
        got_race = _serve(fr, race, 5, plan="disagg_lease_expire_race:1")
        assert fr.handoff.stats["expired_at_commit"] >= 1
        assert fr.stats["handoff.replays"] >= 1
        _assert_clean(fr)
    assert got == want and again == want
    assert got_race == jax_oracle(race, 5)


def test_disagg_shared_prefix_and_spec_decode_stay_exact():
    base = [5, 6, 7, 8, 9, 10, 11, 12]
    prompts = [base + [t] for t in (20, 30, 40, 50)]
    want = jax_oracle(prompts, 6)
    with _fleet(["prefill", "decode", "decode"], draft_k=2) as fr:
        got = _serve(fr, prompts, 6)
        pre = next(r for r in fr.replicas if r.role == "prefill")
        assert pre.engine.stats["prefix_hit_tokens"] > 0
        _assert_clean(fr)
    assert got == want


def test_disagg_prefill_kill_pre_commit_equals_jax_engine():
    prompts = fleet_prompts(4)
    want = jax_oracle(prompts, 6)
    with _fleet(["prefill", "prefill", "decode", "decode"],
                heartbeat_s=0.3) as fr:
        _warm(fr, 2)
        got = _serve(fr, prompts, 6, plan="disagg_prefill_kill:2")
        assert fr.stats["deaths"] >= 1
        assert any(r.state == "dead" and r.role == "prefill"
                   for r in fr.replicas)
        _assert_clean(fr)
    assert got == want


def test_disagg_dropped_handoff_is_reaped_and_replayed():
    prompts = fleet_prompts(3)
    want = jax_oracle(prompts, 5)
    with _fleet(["prefill", "decode", "decode"], lease_ttl_s=0.2) as fr:
        _warm(fr)
        got = _serve(fr, prompts, 5, plan="disagg_handoff_drop:1")
        assert fr.stats["handoff.dropped"] >= 1
        assert fr.handoff.stats["reaped"] >= 1
        assert fr.stats["handoff.replays"] >= 1
        _assert_clean(fr)
    assert got == want


def test_disagg_decode_kill_holding_adopted_pages_dedups_and_forfeits():
    prompts = fleet_prompts(4)
    want = jax_oracle(prompts, 10)
    with _fleet(["prefill", "decode", "decode"], heartbeat_s=0.3) as fr:
        _warm(fr)
        fids = [fr.submit(p, 10) for p in prompts]
        victim = None
        for _ in range(3000):
            fr.step()
            victim = next(
                (r for r in fr.replicas
                 if r.alive and r.role == "decode"
                 and r.engine.stats["adopts"] > 0
                 and any(q.state == "running"
                         for q in r.engine.requests.values())), None)
            if victim is not None:
                break
        assert victim is not None
        held = victim.engine.pool.owned_pages_in_use
        assert held > 0
        fr.kill(victim.rid)
        assert victim.engine.pool.owned_pages_in_use == 0   # forfeited
        fr.run_until_idle()
        assert all(fr.state(f) == "finished" for f in fids)
        got = [fr.result(f) for f in fids]
        assert fr.stats["deaths"] == 1
        assert fr.stats["dedup_tokens"] >= 1
        _assert_clean(fr)
    assert got == want
