"""The port's serving fleet (paddle_tpu_torch/serving/fleet/: FleetRouter,
EngineReplica) on the CPU, every replica a port engine holding the JAX
engine's `decoder_tiny` weights: the fleet's greedy tokens equal the JAX
engine's, through a replica kill mid-stream (also inside speculative
accept windows and of a draining replica), a hang found by the heartbeat,
drain-and-retire with nothing shed, and the threaded pump; affinity
placement, fleet-wide shedding, the failover budget, the heartbeat
monitor, and the fleet.* metrics in the registry."""
import time

import pytest

from torch_serving_parity import fleet_prompts, jax_oracle, port_engine

from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.resilience.faults import fault_scope
from paddle_tpu_torch.resilience.watchdog import (HeartbeatMonitor,
                                                  watchdog_scale)
from paddle_tpu_torch.serving import AdmissionRejected, FleetRouter
from paddle_tpu_torch.serving.fleet import DEAD, DRAINING, HEALTHY, RETIRED


def _factory(**kw):
    return lambda: port_engine(**kw)


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


def _warm(fr):
    fids = [fr.submit([9, 8, 7], 2) for _ in fr.replicas]
    fr.run_until_idle()
    assert all(fr.state(f) == "finished" for f in fids)
    fr.reset_stats()


def _no_leaks(fr):
    for rep in fr.replicas:
        if rep.alive or rep.state == RETIRED:
            assert rep.engine.leaked_pages() == 0, f"replica {rep.rid}"
            assert rep.engine.audit_pool()[0] == []


# -- the heartbeat monitor ---------------------------------------------------

def test_watchdog_scale_clamps_and_widens():
    assert watchdog_scale() == 1.0
    old = flags.get_flag("watchdog_scale")
    try:
        flags.set_flags({"watchdog_scale": 0.25})
        assert watchdog_scale() == 1.0
        flags.set_flags({"watchdog_scale": 3.0})
        assert HeartbeatMonitor(2.0).deadline_s == pytest.approx(6.0)
    finally:
        flags.set_flags({"watchdog_scale": old})
    assert HeartbeatMonitor(2.0).deadline_s == pytest.approx(2.0)


def test_heartbeat_monitor_overdue_and_lifecycle():
    mon = HeartbeatMonitor(0.05, scale=1.0)
    mon.register("a", now=0.0)
    mon.register("b", now=0.0)
    assert mon.overdue(now=0.04) == []
    mon.beat("a", now=0.04)
    assert mon.overdue(now=0.08) == ["b"]
    mon.deregister("b")
    assert mon.overdue(now=10.0) == ["a"]
    mon.beat("zombie", now=0.0)
    assert mon.age("a", now=0.1) == pytest.approx(0.06)
    disabled = HeartbeatMonitor(0.0)
    assert not disabled.enabled
    disabled.register("x", now=0.0)
    assert disabled.overdue(now=1e9) == []


# -- serving through the fleet -----------------------------------------------

def test_fleet_matches_jax_engine_and_affinity_routes():
    prompts = fleet_prompts(4)
    want = jax_oracle(prompts, 6)
    with FleetRouter(_factory(), n_replicas=2, heartbeat_s=30.0) as fr:
        got = _serve(fr, prompts, 6)
        again = _serve(fr, prompts, 6)
        homes = {f.fid: f.replica for f in fr.requests.values()}
        _no_leaks(fr)
    assert got == want and again == want
    assert [homes[i] for i in range(4)] == [homes[i + 4] for i in range(4)]
    assert fr.stats["affinity_hits"] == 8
    assert fr.stats["affinity_misses"] == 0
    assert fr.stats["deaths"] == 0


def test_fleet_wide_shed_vs_single_replica_reject():
    fac = _factory(shed_queue_depth=1, max_inflight=1)
    with FleetRouter(fac, n_replicas=2, heartbeat_s=30.0,
                     affinity=False) as fr:
        for p in ([1, 2, 3], [4, 5, 6], [7, 8, 9], [2, 4, 6]):
            fr.submit(list(p), 12)
            fr.step()
        with pytest.raises(AdmissionRejected):
            fr.submit([7, 7, 7], 4)
        assert fr.stats["sheds"] == 1
        fr.run_until_idle()
    with FleetRouter(_factory(shed_queue_depth=1), n_replicas=2,
                     heartbeat_s=30.0, affinity=False) as fr2:
        fr2.replicas[0].engine.submit([9, 9, 9, 9], 3)
        fid = fr2.submit([1, 2, 3], 4)
        fr2.run_until_idle()
        assert fr2.state(fid) == "finished"
        assert fr2.stats["rejects"] >= 1
        assert fr2.stats["failovers"] >= 1


# -- failover: the JAX engine's tokens through every death --------------------

def test_failover_mid_stream_kill_equals_jax_engine():
    """`fleet_replica_kill` fires a few pumps in, mid-decode for whichever
    replica draws it; nothing is announced. The survivor replays from the
    prompts and the router's ledger delivers each token once: the streams
    equal the JAX engine's greedy tokens."""
    prompts = fleet_prompts(4)
    want = jax_oracle(prompts, 8)
    with FleetRouter(_factory(), n_replicas=2, heartbeat_s=0.3,
                     affinity=False) as fr:
        _warm(fr)
        got = _serve(fr, prompts, 8, plan="fleet_replica_kill:6")
        _no_leaks(fr)
    assert got == want
    assert fr.stats["deaths"] == 1
    assert fr.stats["failovers"] >= 1
    assert fr.stats["replayed_tokens"] >= 1
    assert fr.stats["dedup_tokens"] == fr.stats["replayed_tokens"]
    assert fr.stats["replay_divergence"] == 0


def test_failover_kill_in_spec_accept_window_equals_jax_engine():
    prompts = fleet_prompts(4)
    want = jax_oracle(prompts, 16)
    with FleetRouter(_factory(draft_k=3), n_replicas=2, heartbeat_s=0.3,
                     affinity=False) as fr:
        _warm(fr)
        got = _serve(fr, prompts, 16, plan="fleet_replica_kill:6")
        accepted = sum(r.engine.stats["spec_accepted"] for r in fr.replicas)
    assert accepted > 0, "the workload must exercise the accept window"
    assert got == want
    assert fr.stats["deaths"] == 1
    assert fr.stats["replay_divergence"] == 0


def test_failover_kill_of_draining_replica_equals_jax_engine():
    prompts = fleet_prompts(4)
    want = jax_oracle(prompts, 8)
    with FleetRouter(_factory(), n_replicas=2, heartbeat_s=0.3,
                     affinity=False) as fr:
        _warm(fr)
        fids = [fr.submit(p, 8) for p in prompts]
        for _ in range(3):
            fr.step()
        fr.drain(0)
        fr.kill(0)
        fr.run_until_idle()
        got = [fr.result(f) for f in fids]
        assert all(fr.state(f) == "finished" for f in fids)
    assert got == want
    assert fr.replicas[0].state == DEAD
    assert fr.stats["deaths"] == 1
    assert fr.stats["replay_divergence"] == 0


def test_hang_is_discovered_and_failed_over_exactly():
    prompts = fleet_prompts(3)
    want = jax_oracle(prompts, 8)
    with FleetRouter(_factory(), n_replicas=2, heartbeat_s=0.3,
                     affinity=False) as fr:
        _warm(fr)
        got = _serve(fr, prompts, 8, plan="fleet_replica_hang:6")
    assert got == want
    assert fr.stats["deaths"] == 1
    assert fr.stats["replay_divergence"] == 0


def test_one_slow_heartbeat_does_not_kill_a_margined_replica():
    prompts = fleet_prompts(3)
    with FleetRouter(_factory(), n_replicas=2, heartbeat_s=30.0,
                     affinity=False) as fr:
        _warm(fr)
        got = _serve(fr, prompts, 6, plan="fleet_heartbeat_slow:3")
    assert fr.stats["deaths"] == 0
    assert fr.stats["failovers"] == 0
    assert got == jax_oracle(prompts, 6)
    with FleetRouter(_factory(), n_replicas=2, heartbeat_s=0.15,
                     affinity=False) as fr2:
        _warm(fr2)
        with fault_scope("rand:p=1.0,seed=0,sites=fleet_heartbeat_slow"):
            deadline = time.monotonic() + 60.0
            while (fr2.stats["deaths"] < len(fr2.replicas)
                   and time.monotonic() < deadline):
                fr2.step()
                time.sleep(0.002)
        assert fr2.stats["deaths"] == len(fr2.replicas)


# -- drain-and-retire, the budget, the threaded pump -------------------------

def test_drain_and_retire_sheds_nothing_and_stamps_duration():
    prompts = fleet_prompts(6)
    want = jax_oracle(prompts, 8)
    obs.reset("fleet.")
    with FleetRouter(_factory(), n_replicas=2, heartbeat_s=30.0,
                     affinity=False) as fr:
        _warm(fr)
        fids = [fr.submit(p, 8) for p in prompts]
        for _ in range(2):
            fr.step()
        fr.drain(0)
        assert fr.replicas[0].state == DRAINING
        fr.run_until_idle()
        got = [fr.result(f) for f in fids]
        assert fr.replicas[0].state == RETIRED
        assert fr.replicas[1].state == HEALTHY
        assert got == want
        assert (fr.stats["retires"], fr.stats["failed"], fr.stats["sheds"],
                fr.stats["deaths"]) == (1, 0, 0, 0)
        assert obs.snapshot()["histograms"]["fleet.drain_s"]["count"] == 1
        fid = fr.submit([3, 1, 4, 1], 4)
        fr.run_until_idle()
        assert fr.requests[fid].replica == 1
        _no_leaks(fr)


def test_failover_budget_exhaustion_fails_the_request():
    with FleetRouter(_factory(), n_replicas=3, heartbeat_s=30.0,
                     affinity=False, failover_budget=1) as fr:
        _warm(fr)
        fid = fr.submit([5, 6, 7, 8], 16)
        fr.step()
        first = fr.requests[fid].replica
        fr.kill(first)
        fr.step()
        second = fr.requests[fid].replica
        assert second is not None and second != first
        fr.kill(second)
        fr.run_until_idle()
        assert fr.state(fid) == "failed"
        assert fr.stats["failed"] == 1
        assert fr.stats["failovers"] == 1
        assert any(r.state == HEALTHY for r in fr.replicas)


def test_threaded_pump_serves_and_survives_kill():
    prompts = fleet_prompts(4)
    want = jax_oracle(prompts, 6)
    with FleetRouter(_factory(), n_replicas=2, heartbeat_s=60.0,
                     affinity=False, pump="threads") as fr:
        fids = [fr.submit(p, 6) for p in prompts]
        deadline = time.monotonic() + 120.0
        while (any(fr.state(f) != "finished" for f in fids)
               and time.monotonic() < deadline):
            fr.poll()
            time.sleep(0.005)
        assert [fr.result(f) for f in fids] == want
        fr.kill(0)
        fid = fr.submit([2, 7, 1, 8], 4)
        deadline = time.monotonic() + 60.0
        while fr.state(fid) != "finished" and time.monotonic() < deadline:
            fr.poll()
            time.sleep(0.005)
        assert fr.state(fid) == "finished"
        assert fr.requests[fid].replica == 1


def test_fleet_metrics_land_in_the_registry():
    """The fleet.* series (the counterpart of the JAX package's
    observability test): router counters mirror `stats`, the per-replica
    state gauges and the TTFT / request histograms fill, and
    `reset_stats` clears the series with the dict."""
    obs.reset("fleet.")
    prompts = fleet_prompts(3)
    with FleetRouter(_factory(), n_replicas=2, heartbeat_s=30.0,
                     affinity=False) as fr:
        _serve(fr, prompts, 4)
        fr.kill(1)
        snap = obs.snapshot()
        for key in ("submits", "finished", "deaths"):
            assert snap["counters"].get("fleet." + key, 0) \
                == fr.stats[key] > 0, key
        assert snap["gauges"]["fleet.replicas_healthy"] == 1
        assert snap["gauges"]["fleet.replicas_dead"] == 1
        assert snap["gauges"]['fleet.replica_state{rid="1"}'] == 3
        assert snap["histograms"]["fleet.ttft_s"]["count"] == 3
        assert snap["histograms"]["fleet.request_s"]["count"] == 3
        phases = {e["payload"]["phase"] for e in snap["events"]
                  if e["name"] == "fleet.request"}
        assert {"placed", "finished"} <= phases
        fr.reset_stats()
        assert obs.snapshot()["counters"].get("fleet.submits", 0) == 0



# -- the kernel runtime under the threaded pump ------------------------------

def test_kernel_library_builds_once_under_threads(monkeypatch):
    """Threaded replicas launch their first kernels at once: 8 threads
    calling `_build.library` together build once and load once (the build
    monkeypatched to count its calls), and the launch counters lose no
    increment."""
    import threading

    import torch

    from paddle_tpu_torch.ops.cuda_kernels import _build

    calls = {"build": 0, "load": 0}

    def build_all():
        calls["build"] += 1
        time.sleep(0.05)   # hold the window a racing thread would enter
        return 0.0

    def cdll(path):
        calls["load"] += 1
        return object()

    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "_libs", {})

    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by_dtype = 0, {}
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait()
        got.append(_build.library("paged_attention"))
        for _ in range(2000):
            _build.count(wrapper, torch.float32)

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert wrapper.launches == 16000
    assert wrapper.launches_by_dtype == {"float32": 16000}
