"""Deterministic fault injection for the training runtime (the JAX
package's resilience/faults.py; the site list is copied whole, so a plan
parses the same way in both packages, and the sites the port has not
ported yet simply never fire).

The runtime's recovery paths (checkpoint rollback, RPC retry, compile-cache
invalidation) are only trustworthy if they can be exercised on demand, on one
host, reproducibly. This module plants named *sites* in the hot paths —

    ckpt.write        save_sharded, before the stage directory's write
    ps.send           PSClient.send_var, before the wire
    ps.recv           PSClient.get_var, before the wire
    collective.step   Executor.run, once per executed step
    executor.compile  Executor._compile, before lowering
    rpc_drop          PSClient._call, before ANY request frame hits the wire
                      (send/get/prefetch retry it like a real transport drop;
                      barrier/checkpoint surface it)
    trainer_crash     PSClient.send_barrier — the trainer process dies via
                      os._exit(137) with no cleanup, the in-process stand-in
                      for a mid-round SIGKILL (only schedule it in a
                      subprocess worker's plan)
    heartbeat_loss    the PSClient heartbeat thread's tick — that beat is
                      silently skipped, so a scheduled run of hits starves
                      the server's liveness monitor into evicting
    pipeline_stall    Executor's async completion-token drain and the
                      DeviceLoader producer — the wait wedges as if the
                      device/feed hung, so the resilience watchdog must fire
    numeric_nan       Executor feed staging — a NaN is planted in the step's
                      first floating feed (the compiled step is opaque, so
                      the feed is the injection boundary); it propagates into
                      the loss and every gradient slot, which the in-graph
                      health sentinel must catch and skip
    numeric_spike     Executor feed staging — the first floating feed is
                      scaled 1e4x, driving a finite loss spike that the
                      sentinel's EMA gate (FLAGS_guard_spike_factor) must
                      catch
    collective_stall  Executor's async completion-token drain, for steps
                      dispatched under the shard_map/with_collective regime
                      only — the drain wedges as if one rank of the mesh
                      never posted its allreduce (a lost collective
                      partner), so the stall watchdog must surface the hung
                      allreduce with step ids and queue depths instead of
                      blocking forever
    serving_abort     ServingEngine.step, once per scheduler iteration —
                      the oldest running generate-request is aborted
                      mid-decode (the client vanished), so its KV pages
                      must return to the free list; the chaos test drives
                      repeated abort cycles and asserts the pool leaks
                      zero pages
    serving_step_fail ServingEngine._dispatch, before every compiled
                      prefill/decode/window/COW step — the dispatch fails
                      like a lost device transport; the engine's
                      RetryPolicy must absorb isolated hits, and a run of
                      hits exhausting the attempts must trigger the
                      recovery pass (quarantine + pool rebuild + replay),
                      never a poisoned batch
    serving_pool_corrupt
                      ServingEngine.step, once per scheduler iteration —
                      one piece of host-side pool bookkeeping is
                      vandalized (phantom refcount holder, live page
                      pushed back on the free list, or a duplicate
                      ordinal in a request's page table); the periodic
                      PagedKVPool.check_consistency audit must detect it
                      and the recovery pass must rebuild a clean pool
    serving_deadline  ServingEngine.step, once per scheduler iteration —
                      the oldest live request's deadline is forced into
                      the past, so the expiry machinery must surface it
                      as deadline_exceeded with every page returned
    fleet_replica_kill
                      EngineReplica.pump_once, once per pump iteration —
                      the replica dies SIGKILL-style: its engine is never
                      touched again, its heartbeat stops, and NOTHING is
                      announced; the router's HeartbeatMonitor must
                      discover the death by missed beats and replay every
                      in-flight request from its prompt on a survivor
                      (token-deduplicated at the router, bitwise-exact
                      under greedy)
    fleet_replica_hang
                      EngineReplica.pump_once — the replica wedges: the
                      pump keeps getting called but makes no progress and
                      stamps no beats (a hung host, not a dead one); the
                      health checker must treat it exactly like a kill
    fleet_heartbeat_slow
                      EngineReplica.pump_once, at the beat stamp — ONE
                      beat is silently dropped (a slow/loaded host), so a
                      correctly-margined deadline (FLAGS_fleet_heartbeat_s
                      x FLAGS_watchdog_scale) must NOT declare the replica
                      dead; a scheduled run of hits starves the monitor
                      into a (correct) death verdict
    disagg_prefill_kill
                      EngineReplica.pump_once, prefill-role replicas only
                      (disaggregated serving) — the prefill
                      replica dies SIGKILL-style exactly like
                      fleet_replica_kill; requests mid-prefill (or whose
                      lease never published) must replay on a surviving
                      prefill replica within the fleet_policy budget,
                      while already-published leases survive the death
                      (the shared pool, not the dead host, owns the pin)
                      and still commit
    disagg_handoff_drop
                      FleetRouter handling of a "prepared" event — the
                      event is dropped on the floor: the lease is
                      published and pinned but the commit is never
                      dispatched (a lost message between the stages), so
                      the lease REAPER must reclaim the orphaned pin at
                      TTL and the router must replay the prompt
    disagg_lease_expire_race
                      HandoffManager.commit — the lease's expiry is
                      forced into the past at the exact moment the commit
                      arrives, so the reap-vs-commit race resolves REAP:
                      the commit must be rejected atomically (never a
                      half-adopted table), the pin reclaimed once, and
                      the request replayed cleanly
    emb_host_stall    the tiered-embedding miss resolver
                      (embedding/engine.resolve_feed) — the host-tier
                      prefetch parks forever (a hung remote shard / page-in
                      storm stand-in) on the DeviceLoader's producer
                      thread, so the consumer-side stall watchdog
                      must surface it with queue depths instead of the
                      trainer hanging on an empty staging queue

— and a *plan* that decides, per site and per hit, whether to raise an
`InjectedFault`. Plans are either explicit hit schedules or seeded Bernoulli
draws; both are pure functions of (site, hit index), so a failing chaos run
replays exactly from its plan string.

Plan spec grammar (the `FLAGS_fault_plan` value / `fault_scope` argument):

    "ckpt.write:2;ps.send:1,4"      raise on those 1-based hits of each site
    "rand:p=0.2,seed=7"             each hit at every site fails w.p. 0.2
    "rand:p=0.2,seed=7,sites=ps.send|ps.recv,max=5"
                                    restrict sites; stop after 5 faults total

The schedule is *per-process*: subprocess trainers inherit the plan through
the FLAGS_fault_plan environment variable (flags.py reads FLAGS_* at import).
"""
from __future__ import annotations

import hashlib
import threading
from contextlib import contextmanager

__all__ = ["FAULT_SITES", "InjectedFault", "FaultPlan", "fault_point",
           "fault_scope", "fault_stats", "install_plan"]

# the named sites the runtime instruments; fault_point accepts only these so
# a typo'd site name fails loudly instead of silently never firing
FAULT_SITES = frozenset({
    "ckpt.write", "ps.send", "ps.recv", "collective.step", "executor.compile",
    "rpc_drop", "trainer_crash", "heartbeat_loss", "pipeline_stall",
    "collective_stall", "numeric_nan", "numeric_spike", "serving_abort",
    "emb_host_stall", "serving_step_fail", "serving_pool_corrupt",
    "serving_deadline", "fleet_replica_kill", "fleet_replica_hang",
    "fleet_heartbeat_slow", "disagg_prefill_kill", "disagg_handoff_drop",
    "disagg_lease_expire_race",
})


class InjectedFault(ConnectionError):
    """Raised by fault_point on schedule.

    Subclasses ConnectionError so the injected failure travels the same
    except-clauses real transport faults do — the recovery code under test
    must not need to know it is being tested.
    """

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at '{site}' (hit {hit})")
        self.site = site
        self.hit = hit


class FaultPlan:
    """A deterministic (site, hit index) -> should-raise schedule."""

    def __init__(self, schedule: dict[str, frozenset[int]] | None = None,
                 p: float = 0.0, seed: int = 0,
                 sites: frozenset[str] | None = None,
                 max_faults: int | None = None, spec: str = ""):
        self.schedule = schedule or {}
        self.p = float(p)
        self.seed = int(seed)
        self.sites = sites  # None = every site (random mode only)
        self.max_faults = max_faults
        self.spec = spec
        self._hits: dict[str, int] = {}
        self._fired: list[tuple[str, int]] = []
        self._lock = threading.Lock()

    # -- construction --------------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        spec = (spec or "").strip()
        if not spec:
            return cls(spec=spec)
        if spec.startswith("rand:"):
            p, seed, sites, max_faults = 0.0, 0, None, None
            for kv in spec[len("rand:"):].split(","):
                k, _, v = kv.partition("=")
                k, v = k.strip(), v.strip()
                if k == "p":
                    p = float(v)
                elif k == "seed":
                    seed = int(v)
                elif k == "sites":
                    sites = frozenset(s.strip() for s in v.split("|") if s)
                elif k == "max":
                    max_faults = int(v)
                else:
                    raise ValueError(f"unknown fault-plan key '{k}' in {spec!r}")
            unknown = (sites or frozenset()) - FAULT_SITES
            if unknown:
                raise ValueError(f"unknown fault sites {sorted(unknown)}; "
                                 f"known: {sorted(FAULT_SITES)}")
            return cls(p=p, seed=seed, sites=sites, max_faults=max_faults,
                       spec=spec)
        schedule: dict[str, frozenset[int]] = {}
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            site, _, hits = part.partition(":")
            site = site.strip()
            if site not in FAULT_SITES:
                raise ValueError(f"unknown fault site '{site}'; known: "
                                 f"{sorted(FAULT_SITES)}")
            schedule[site] = frozenset(int(h) for h in hits.split(",") if h)
        return cls(schedule=schedule, spec=spec)

    # -- the decision --------------------------------------------------------
    def _draw(self, site: str, hit: int) -> bool:
        """Seeded Bernoulli, pure in (seed, site, hit): a replayed plan makes
        identical decisions regardless of thread interleaving."""
        h = hashlib.sha256(f"{self.seed}:{site}:{hit}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2**64 < self.p

    def check(self, site: str) -> None:
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            fire = False
            if site in self.schedule:
                fire = hit in self.schedule[site]
            elif self.p > 0.0 and (self.sites is None or site in self.sites):
                if (self.max_faults is None
                        or len(self._fired) < self.max_faults):
                    fire = self._draw(site, hit)
            if fire:
                self._fired.append((site, hit))
        if fire:
            raise InjectedFault(site, hit)

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"hits": dict(self._hits), "fired": list(self._fired),
                    "spec": self.spec}


_active: FaultPlan | None = None
_install_lock = threading.Lock()


def _bootstrap_from_flags() -> None:
    """Pick up FLAGS_fault_plan (env or set_flags) lazily, once."""
    global _active
    from .. import flags

    try:
        spec = flags.get_flag("fault_plan")
    except KeyError:  # flags module not fully imported yet
        return
    if spec:
        with _install_lock:
            if _active is None:
                _active = FaultPlan.parse(spec)


_bootstrapped = False


def install_plan(plan: "FaultPlan | str | None") -> FaultPlan | None:
    """Install (or clear, with None) the process-wide plan; returns the
    previous one. Prefer `fault_scope` in tests."""
    global _active, _bootstrapped
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    with _install_lock:
        prev, _active = _active, plan
        _bootstrapped = True  # explicit install wins over the env flag
    return prev


def fault_point(site: str) -> None:
    """The instrumented sites call this; near-free when no plan is active."""
    global _bootstrapped
    if _active is None:
        if not _bootstrapped:
            _bootstrapped = True
            _bootstrap_from_flags()
            if _active is None:
                return
        else:
            return
    if site not in FAULT_SITES:
        raise ValueError(f"unknown fault site '{site}'; known: "
                         f"{sorted(FAULT_SITES)}")
    _active.check(site)


@contextmanager
def fault_scope(plan: "FaultPlan | str"):
    """Scoped plan for tests: install on entry, restore the previous plan on
    exit. Yields the plan so the test can assert on .stats()."""
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    prev = install_plan(plan)
    try:
        yield plan
    finally:
        install_plan(prev)


def fault_stats() -> dict:
    """Hit/fire counters of the active plan ({} when none)."""
    return _active.stats() if _active is not None else {}
