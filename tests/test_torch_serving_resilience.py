"""The port's serving resilience (paddle_tpu_torch/serving/engine.py) on the
CPU: deadlines, admission control with priority shedding, the degradation
ladder, supervised dispatch, the pool audit and the recovery pass, held
against the JAX engine on `decoder_tiny` with its weights (greedy token for
greedy token, the same requests quarantined, the same counters) and
against the port's own fault-free runs. Also: an in-program fault (a KV
write that fails after the first layer's has landed) retried by
`_dispatch` leaves the tokens unchanged; a random fault drill over the
serving sites; the serving.* metrics in the registry; the profiler's
trace front end."""
import time

import numpy as np
import pytest

from torch_serving_parity import drain, jax_engine, port_engine, prompt

from paddle_tpu.resilience.faults import fault_scope as j_fault_scope
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import profiler
from paddle_tpu_torch.observability import parse_prometheus, prometheus_text
from paddle_tpu_torch.ops import attention_ops
from paddle_tpu_torch.resilience.faults import fault_scope
from paddle_tpu_torch.serving import AdmissionRejected, PagedKVPool

RECOVERY_KEYS = ("recovery.passes", "recovery.replayed",
                 "recovery.quarantined", "step_retries", "prefills",
                 "decode_tokens")


def _engine(**kw):
    kw.setdefault("prefix_cache", False)
    return port_engine(**kw)


# -- the JAX engine's runs: one a scenario, shared by the module -------------

_SCENARIOS = {
    # name: (engine kwargs, fault plan, prompt seeds)
    "fault_free": ({"prefix_cache": False}, None, (30, 31, 32)),
    "retry": ({"prefix_cache": False, "step_retries": 3},
              "serving_step_fail:3,7", (20, 21, 22)),
    "step_fail_exhaustion": ({"prefix_cache": False, "step_retries": 3},
                             "serving_step_fail:5,6,7", (30, 31, 32)),
    "quarantine": ({"prefix_cache": False, "audit_every": 1},
                   "serving_pool_corrupt:2", (40, 41, 42)),
    "refcount": ({"prefix_cache": False, "audit_every": 1},
                 "serving_pool_corrupt:3", (50, 51)),
}


def _run(eng, scope, plan, seeds):
    prompts = [prompt(s, 5) for s in seeds]
    if plan is None:
        outs, rids = drain(eng, prompts, 4)
    else:
        with scope(plan) as p:
            outs, rids = drain(eng, prompts, 4)
            assert p.stats()["fired"]
    states = [eng.requests[r].state for r in rids]
    return outs, states, {k: eng.stats[k] for k in RECOVERY_KEYS}


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _run(jax_engine(**kw), j_fault_scope, plan, seeds)
            for name, (kw, plan, seeds) in _SCENARIOS.items()}


def _port_run(name):
    kw, plan, seeds = _SCENARIOS[name]
    eng = port_engine(**kw)
    return eng, _run(eng, fault_scope, plan, seeds)


# -- pool invariant audit ----------------------------------------------------

def test_check_consistency_clean_and_each_corruption_kind():
    pool = PagedKVPool(num_pages=8, page_size=4)
    pages = pool.allocate(3)
    assert pool.check_consistency() == []
    assert pool.check_consistency(holders={p: 1 for p in pages}) == []
    pool._refs[pages[0]] += 1       # phantom holder
    assert pool.check_consistency(holders={p: 1 for p in pages})
    pool._refs[pages[0]] -= 1
    pool._free.append(pages[1])     # live page pushed back on the free list
    assert pool.check_consistency()
    pool._free.pop()
    pool._free.append(pool._free[-1])   # duplicate free-list entry
    assert pool.check_consistency()
    pool._free.pop()
    assert pool.check_consistency() == []
    pool.reset()
    assert pool.free_count == pool.num_pages
    assert pool.check_consistency() == []


# -- deadlines ---------------------------------------------------------------

def test_deadline_expires_while_waiting():
    obs.reset("serving.")
    eng = _engine()
    rid = eng.submit(prompt(0, 5), 4, deadline_s=1e-4)
    time.sleep(0.01)
    eng.step()   # the top-of-step expiry fires before admission
    req = eng.requests[rid]
    assert req.state == "deadline_exceeded"
    assert req.pages == [] and req.n_generated == 0
    assert eng.stats["deadline_exceeded"] == 1
    assert obs.snapshot()["counters"].get("serving.deadline_exceeded") == 1
    assert not eng.has_work()
    assert eng.leaked_pages() == 0
    assert eng.pop_result(rid) == []


def test_deadline_expires_mid_decode_keeps_partial_tokens():
    eng = _engine()
    rid = eng.submit(prompt(1, 5), 8)
    eng.step()   # admit + prefill + first decode
    req = eng.requests[rid]
    assert req.state == "running" and req.n_generated >= 1
    req.deadline_t = time.perf_counter() - 1.0
    eng.step()
    assert req.state == "deadline_exceeded"
    assert req.pages == []
    assert 1 <= req.n_generated < 8
    assert eng.stats["deadline_exceeded"] == 1
    assert eng.leaked_pages() == 0
    assert eng.pool.free_count == eng.pool.num_pages


def test_deadline_crossing_inside_first_step_caught_same_step():
    """A TTL crossed inside the prefill/decode span is caught by the
    post-decode sweep of the same step. The crossing is made exact by
    moving the deadline to the past from inside the prefill (the JAX test
    relies on its first step's compile taking longer than 20 ms)."""
    eng = _engine()
    rid = eng.submit(prompt(2, 6), 4)
    prefill = eng._prefill

    def crossing(req):
        prefill(req)
        req.deadline_t = time.perf_counter() - 1e-9

    eng._prefill = crossing
    eng.step()
    req = eng.requests[rid]
    assert req.state == "deadline_exceeded"
    assert req.pages == [] and req.n_generated >= 1
    assert eng.stats["deadline_exceeded"] == 1
    assert eng.leaked_pages() == 0


def test_abort_waiting_request_releases_prefix_pin():
    """A failed admission leaves the matched prefix-cache pages pinned on
    the waiting request; abort() of it releases the pin."""
    eng = _engine(pool_pages=16, prefix_cache=True)
    sysp = prompt(3, 8)   # two full pages
    a = eng.submit(sysp, 2)
    eng.run_until_drained()
    assert eng.requests[a].state == "finished"
    cache_pages = [n.page for n in eng.prefix_cache._nodes.values()]
    assert len(cache_pages) == 2
    r = eng.submit(prompt(4, 5), 3)
    eng.step()
    hold = eng.pool.allocate(eng.pool.free_count)   # starve the pool
    assert hold is not None
    b = eng.submit(sysp + prompt(5, 4), 2)
    eng.step()   # matches the cached prefix; the private allocation fails
    breq = eng.requests[b]
    assert breq.state == "waiting"
    assert sorted(breq.pages) == sorted(cache_pages)
    assert all(eng.pool.refcount(p) == 2 for p in cache_pages)
    eng.abort(b)
    assert breq.state == "aborted" and breq.pages == []
    assert all(eng.pool.refcount(p) == 1 for p in cache_pages)
    eng.pool.release(hold)
    eng.run_until_drained()
    assert eng.requests[r].state == "finished"
    assert eng.leaked_pages() == 0
    eng.flush_prefix_cache()
    assert eng.pool.free_count == eng.pool.num_pages


# -- admission control and the ladder ----------------------------------------

def test_admission_rejects_and_sheds_by_priority():
    eng = _engine(max_inflight=1, shed_queue_depth=2)
    a = eng.submit(prompt(6, 4), 2, priority=0)
    b = eng.submit(prompt(7, 4), 2, priority=0)
    with pytest.raises(AdmissionRejected) as ei:
        eng.submit(prompt(8, 4), 2, priority=0)
    assert "queue_depth" in ei.value.signals
    assert ei.value.retry_after_s > 0
    assert eng.stats["rejects"] == 1
    d = eng.submit(prompt(9, 4), 2, priority=5)
    assert eng.requests[b].state == "shed"
    assert eng.stats["shed"] == 1
    assert eng.pop_result(b) == []
    eng.run_until_drained()
    assert eng.requests[a].state == "finished"
    assert eng.requests[d].state == "finished"
    assert eng.leaked_pages() == 0


def test_ttft_p99_floor_sheds_through_the_slo_monitor():
    """The TTFT floor reads the serving.ttft_s histogram through the
    SloMonitor: with the observed TTFT far above a 1 us floor, a submit
    sheds the lower-priority waiter and is still refused (shedding does
    not lower a TTFT)."""
    obs.reset("serving.")
    eng = _engine(max_inflight=1, shed_ttft_p99_ms=1e-3)
    eng.submit(prompt(60, 4), 2)
    eng.run_until_drained()   # one TTFT observed, far above 1 us
    assert "ttft_p99_s" in eng._overload_signals()
    slo, eng._slo = eng._slo, None
    low = eng.submit(prompt(61, 4), 2, priority=0)   # queued with the floor off
    eng._slo = slo
    with pytest.raises(AdmissionRejected) as ei:
        eng.submit(prompt(62, 4), 2, priority=1)
    assert "ttft_p99_s" in ei.value.signals
    assert eng.requests[low].state == "shed"
    assert (eng.stats["shed"], eng.stats["rejects"]) == (1, 1)
    assert not eng.has_work() and eng.leaked_pages() == 0


def test_ladder_climbs_under_pressure_and_descends_calm():
    eng = _engine(pool_pages=8, max_inflight=2, shed_occupancy=0.3,
                  degrade_after=1)
    rids = [eng.submit(prompt(10 + i, 3), 6) for i in range(6)]
    eng.run_until_drained()
    for rung in ("spec_off", "lookahead_shrink", "cache_evict", "shed"):
        assert eng.stats["ladder." + rung] >= 1, f"rung {rung} never hit"
    assert eng.stats["shed"] >= 1
    states = {eng.requests[r].state for r in rids}
    assert states <= {"finished", "shed"} and "finished" in states
    assert eng.leaked_pages() == 0
    for _ in range(8):
        eng.step()
    assert eng._ladder_rung == 0


def test_ladder_and_shedding_equal_the_jax_engines():
    """The same pressured workload through both engines: the same rungs
    climbed, the same requests shed, the same tokens for the rest."""
    kw = dict(pool_pages=8, max_inflight=2, prefix_cache=False,
              shed_occupancy=0.3, degrade_after=1)
    got = []
    for eng in (jax_engine(**kw), port_engine(**kw)):
        rids = [eng.submit(prompt(10 + i, 3), 6) for i in range(6)]
        eng.run_until_drained()
        got.append(([eng.requests[r].state for r in rids],
                     [eng.result(r) for r in rids],
                     {k: v for k, v in eng.stats.items()
                      if k.startswith("ladder.") or k == "shed"}))
    assert got[1] == got[0]


# -- supervision: retries and recovery, against the JAX engine ---------------

def test_transient_step_faults_absorbed_by_retry(jax_runs):
    eng, (outs, states, st) = _port_run("retry")
    want = jax_runs["retry"]
    assert (outs, states) == want[:2]
    assert st["step_retries"] == want[2]["step_retries"] == 2
    assert st["recovery.passes"] == 0
    assert eng.leaked_pages() == 0


def test_recovery_oracle_step_fail_exhaustion(jax_runs):
    """Hits 5, 6, 7 burn every attempt of one dispatch: a recovery pass
    replays from the prompts, and the tokens are the JAX engine's (same
    plan) and the fault-free run's."""
    eng, got = _port_run("step_fail_exhaustion")
    assert got == jax_runs["step_fail_exhaustion"]
    assert got[0] == jax_runs["fault_free"][0]
    assert got[2]["recovery.passes"] == 1
    assert got[2]["recovery.replayed"] >= 1
    assert got[2]["recovery.quarantined"] == 0
    assert eng.leaked_pages() == 0
    assert eng.pool.free_count == eng.pool.num_pages


def test_recovery_quarantines_poisoned_request(jax_runs):
    """Corruption kind 2 (a duplicate ordinal in the newest running table)
    poisons that request: the audit catches it, recovery quarantines the
    same request as the JAX engine does and replays the others to the JAX
    engine's tokens."""
    eng, got = _port_run("quarantine")
    assert got == jax_runs["quarantine"]
    assert got[1].count("aborted") == 1
    assert got[2]["recovery.passes"] == 1
    assert got[2]["recovery.quarantined"] == 1
    problems, _ = eng.audit_pool()
    assert problems == []
    assert eng.leaked_pages() == 0
    assert eng.pool.free_count == eng.pool.num_pages


def test_recovery_from_refcount_corruption_replays_all(jax_runs):
    eng, got = _port_run("refcount")
    assert got == jax_runs["refcount"]
    assert got[2]["recovery.passes"] == 1
    assert got[2]["recovery.quarantined"] == 0
    assert set(got[1]) == {"finished"}
    assert eng.leaked_pages() == 0


@pytest.mark.parametrize("draft_k", [0, 2])
def test_in_program_fault_retry_leaves_tokens_unchanged(draft_k):
    """The port writes the KV pools in place, op by op: fail a decode (or
    verify-window) dispatch INSIDE the program, after its first layer's
    K/V write has landed, and let `_dispatch` retry it. The retry rewrites
    those slots with the same values, so the tokens equal a fault-free
    run's."""
    prompts = [prompt(s, 5) for s in (70, 71, 72)]
    want, _ = drain(_engine(draft_k=draft_k), prompts, 6)
    eng = _engine(draft_k=draft_k, step_retries=3)
    write = attention_ops._write_kept_
    state = {"calls": 0, "armed": False, "fired": 0}

    def flaky(*args):
        state["calls"] += 1
        if state["armed"] and state["calls"] == 2:
            state["armed"] = False
            state["fired"] += 1
            raise ConnectionError("transport lost after layer 0's write")
        return write(*args)

    dispatch = eng._dispatch

    def arm(kind, prog, feed, fetch):
        if kind in ("decode", "verify_window") and eng.stats["decode_steps"] == 2:
            state["calls"], state["armed"] = 0, True
        return dispatch(kind, prog, feed, fetch)

    eng._dispatch = arm
    attention_ops._write_kept_ = flaky
    try:
        got, _ = drain(eng, prompts, 6)
    finally:
        attention_ops._write_kept_ = write
    assert state["fired"] == 1
    assert eng.stats["step_retries"] == 1
    assert eng.stats["recovery.passes"] == 0
    assert got == want
    assert eng.leaked_pages() == 0


def test_random_fault_drill_keeps_the_pool_clean():
    """Random plans over the serving fault sites (the JAX package's chaos
    drill, small): every request ends in a terminal state, the audit is
    clean and nothing leaks after each cycle; finished requests' tokens
    are the fault-free run's (aborted, expired and quarantined ones keep a
    prefix of them)."""
    prompts = [prompt(80 + i, 4 + i % 3) for i in range(4)]
    want, _ = drain(_engine(prefix_cache=True), prompts, 5)
    eng = _engine(prefix_cache=True, audit_every=1, step_retries=2)
    fired = []
    for cycle in range(3):
        spec = ("rand:p=0.12,seed=%d,sites=serving_step_fail|"
                "serving_pool_corrupt|serving_deadline|serving_abort" % cycle)
        with fault_scope(spec) as plan:
            outs, rids = drain(eng, prompts, 5)
            fired += plan.stats()["fired"]
        for i, r in enumerate(rids):
            req = eng.requests[r]
            assert req.state in ("finished", "aborted", "deadline_exceeded")
            if req.state == "finished":
                assert outs[i] == want[i]
            else:
                assert outs[i] == want[i][:len(outs[i])]
        assert eng.audit_pool()[0] == []
        assert eng.leaked_pages() == 0
        eng.prune_finished()
    assert any(fired)
    eng.flush_prefix_cache()
    assert eng.pool.free_count == eng.pool.num_pages


# -- observability: the serving.* series -------------------------------------

def test_stats_snapshot_rate_guard():
    eng = _engine(draft_k=2)
    ss = eng.stats_snapshot()
    for k in ("spec_accept_rate", "tokens_per_decode_step",
              "prefix_cache_hit_rate", "occupancy_mean"):
        assert ss[k] == 0.0
    assert all(np.isfinite(v) for v in ss.values()
               if isinstance(v, (int, float)))


def test_serving_engine_mirrors_stats_into_registry():
    obs.reset("serving.")
    eng = _engine(pool_pages=32, prefix_cache=True)
    for n in (3, 9):
        eng.submit(prompt(90 + n, n), 4)
    eng.run_until_drained()
    snap = obs.snapshot()
    for key in ("prefills", "decode_steps", "decode_tokens",
                "prefill_tokens_computed", "prefix_lookups"):
        assert snap["counters"].get("serving." + key, 0) == eng.stats[key], key
    assert snap["gauges"]["serving.pages_in_use"] == (
        eng.pool.num_pages - eng.pool.free_count)
    assert snap["histograms"]["serving.ttft_s"]["count"] == 2
    assert snap["histograms"]["serving.request_s"]["count"] == 2
    assert snap["histograms"]["serving.decode.seconds"]["count"] \
        == eng.stats["decode_steps"]
    phases = [e["payload"]["phase"] for e in snap["events"]
              if e["name"] == "serving.request"]
    for ph in ("queued", "admitted", "first_token", "finished"):
        assert ph in phases, f"missing lifecycle phase {ph}"
    parsed = parse_prometheus(prometheus_text(snap))
    assert parsed["serving_prefills"] == eng.stats["prefills"]
    assert parsed["serving_ttft_s_count"] == 2
    eng.reset_stats()
    assert obs.snapshot()["counters"].get("serving.prefills", 0) == 0
    assert eng.stats["prefills"] == 0


# -- the profiler's trace front end ------------------------------------------

def test_profiler_traces_into_the_resolved_directory(tmp_path):
    import torch

    d = tmp_path / "trace"
    profiler.start_profiler("All", profile_path=str(d))
    with profiler.RecordEvent("serving.step"):
        torch.ones(8).sum()
    out = profiler.stop_profiler()
    assert out.startswith(str(d)) and out.endswith(".json")
    assert "serving.step" in open(out).read()
    with profiler.profiler(profile_path=str(d)):
        torch.ones(4).mean()
    assert len(list(d.iterdir())) == 2


def test_stop_profiler_without_start_names_the_fix():
    with pytest.raises(RuntimeError, match="start_profiler"):
        profiler.stop_profiler()


def test_failed_trace_start_leaves_no_half_open_state(tmp_path, monkeypatch):
    def boom(path, exist_ok=False):
        raise OSError("read-only filesystem")

    monkeypatch.setattr(profiler.os, "makedirs", boom)
    with pytest.raises(OSError, match="read-only"):
        with profiler.profiler(profile_path=str(tmp_path / "trace")):
            pass  # pragma: no cover — the start fails before the body
    monkeypatch.undo()
    assert profiler._trace_active is False
    with pytest.raises(RuntimeError, match="start_profiler"):
        profiler.stop_profiler()
    profiler.start_profiler(profile_path=str(tmp_path / "again"))
    with pytest.raises(RuntimeError, match="already active"):
        profiler.start_profiler(profile_path=str(tmp_path / "again"))
    profiler.stop_profiler()
