"""Fleet router: N engine replicas behind one submit/poll surface.

`FleetRouter` fronts N in-process `EngineReplica`s (each a full
`ServingEngine` — own KV pool, prefix cache, executor — i.e. one
failure domain) and owns everything that must survive a replica death:

  * placement — prefix-cache affinity first (`FLAGS_fleet_affinity`: the
    prompt head hashes to a home replica, so shared-prefix traffic keeps
    hitting the replica that already caches it), degrading gracefully to
    least-loaded whenever the home replica is not HEALTHY;
  * health — a `HeartbeatMonitor` over per-replica beats stamped by the
    pumps; a beat older than FLAGS_fleet_heartbeat_s (widened by
    FLAGS_watchdog_scale for slow CI) declares the replica DEAD. Death is
    *discovered*, never announced — kills, hangs, and engine crashes all
    look identical from here: a heartbeat that stopped;
  * failover — every request in flight on a dead replica is replayed from
    its prompt on a survivor through `resilience.retry.fleet_policy` (the
    shared RetryPolicy; max_attempts IS the per-request budget). The
    router keeps the authoritative per-request token ledger (`delivered`),
    so the replay's regenerated prefix is deduplicated position-by-
    position: clients see each token exactly once, and under greedy
    decoding the replayed suffix is bitwise-identical to what the dead
    replica would have produced (batch-composition invariance — the same
    property the engine's recovery replay leans on). Positions that
    DO disagree (possible under temperature sampling, where the replay
    re-draws) are suppressed and counted as fleet.replay_divergence;
  * drain-and-retire — `drain(rid)` moves a replica to DRAINING: it
    admits nothing, hands off engine-WAITING work immediately (replayed
    elsewhere, budget-free — a planned migration is not a failure), lets
    RUNNING decodes finish, then RETIRES and stamps fleet.drain_s. Zero
    requests shed: live scale-down;
  * fleet-wide shed — admission is refused (`AdmissionRejected`, same
    type as the engine's) only when EVERY healthy replica reports overload
    signals; a single overloaded replica just loses the
    placement. Per-replica rejections bounce back asynchronously and
    re-place on another replica under the same failover budget.

Pump modes: `pump="inline"` (default) steps every replica on the caller's
thread inside `step()` — fully deterministic, what the failover-exactness
tests and chaos drills use; `pump="threads"` gives each replica a worker
thread (the serving topology) — the router thread then only routes and polls.

Replay exactness requires every replica to serve the SAME model: the
`engine_factory` must build identically-seeded engines.

Disaggregation: pass `roles=["prefill","prefill","decode",...]`
(or set FLAGS_disagg_prefill_replicas) and an engine factory whose engines
share ONE `PagedKVPool` (`handoff.disagg_fleet_factory`). The router then
places every request on a decode-role home (affinity hashes over the
DECODE universe only; prefill replicas never appear in placement) but
dispatches the prompt to the least-loaded prefill replica first; the
prefill side publishes the finished context under a TTL'd lease
("prepared"), the router forwards the commit to the decode home, and the
adopting side streams every token. Crash recovery composes out of the
pieces above plus three lease rules: a dead replica's `OwnedPoolView`
forfeits its pins (lease pins survive — they belong to the
`HandoffManager`), an orphaned PREPARED lease reaps at TTL and replays
the prompt under the ordinary failover budget, and a request that moved
on abandons its stale lease the moment its event surfaces. Disaggregated
fleets pump inline only: the shared pool is single-writer by design.
"""
from __future__ import annotations

import hashlib
import time
from typing import Callable

from ... import observability as obs
from ...resilience.faults import InjectedFault, fault_point
from ...resilience.retry import fleet_policy
from ...resilience.watchdog import HeartbeatMonitor
from ..engine import AdmissionRejected
from .replica import (DEAD, DRAINING, HEALTHY, RETIRED, STATE_ORDINAL,
                      EngineReplica)

__all__ = ["FleetRouter", "FleetRequest", "NoHealthyReplica",
           "QUEUED", "FINISHED", "FAILED", "FLEET_TERMINAL"]

QUEUED, FINISHED, FAILED = "queued", "finished", "failed"
# aborted / deadline_exceeded / shed arrive verbatim from the engine
FLEET_TERMINAL = frozenset(
    {FINISHED, FAILED, "aborted", "deadline_exceeded", "shed"})


class NoHealthyReplica(ConnectionError):
    """Placement found no HEALTHY replica to target (ConnectionError so the
    fleet RetryPolicy treats it as transient while any budget remains)."""


class FleetRequest:
    """Router-side record of one request: where it lives now and the
    authoritative `delivered` token ledger that makes failover replay
    exactly-once from the client's point of view."""

    __slots__ = ("fid", "prompt", "max_new_tokens", "eos_id", "sampling",
                 "priority", "deadline_s", "state", "replica", "delivered",
                 "failovers", "aborting", "t_submit", "t_first", "t_done",
                 "prefill_replica", "lease_id")

    def __init__(self, fid: int, prompt, max_new_tokens: int, eos_id,
                 sampling, priority, deadline_s):
        self.fid = fid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.sampling = sampling
        self.priority = priority
        self.deadline_s = deadline_s
        self.state = QUEUED
        self.replica: int | None = None
        self.delivered: list[int] = []
        self.failovers = 0
        self.aborting = False
        self.t_submit = time.perf_counter()
        self.t_first: float | None = None
        self.t_done: float | None = None
        # disaggregated path: where the prompt prefills, and the lease id
        # the router is shepherding toward commit (None once adopted)
        self.prefill_replica: int | None = None
        self.lease_id: str | None = None

    def job(self) -> dict:
        return {"fid": self.fid, "prompt": self.prompt,
                "max_new_tokens": self.max_new_tokens, "eos_id": self.eos_id,
                "sampling": self.sampling, "priority": self.priority,
                "deadline_s": self.deadline_s}


class FleetRouter:
    def __init__(self, engine_factory: Callable[[], object],
                 n_replicas: int | None = None, *,
                 heartbeat_s: float | None = None,
                 affinity: bool | None = None,
                 affinity_tokens: int | None = None,
                 failover_budget: int | None = None,
                 pump: str = "inline",
                 roles: "list[str] | None" = None,
                 lease_ttl_s: float | None = None):
        """engine_factory() -> ServingEngine, called once per replica; it
        MUST seed every engine identically (same weights) or failover
        replay loses bitwise exactness. Knobs default from FLAGS_fleet_*.

        `roles` (or FLAGS_disagg_prefill_replicas > 0) turns on
        disaggregation: one entry per replica from {"prefill", "decode",
        "mixed"}; the factory is then called as factory(role) and every
        engine must sit on ONE shared PagedKVPool (see
        handoff.disagg_fleet_factory). `lease_ttl_s` overrides
        FLAGS_disagg_lease_ttl_s for the fleet's HandoffManager."""
        from ... import flags

        if pump not in ("inline", "threads"):
            raise ValueError(f"pump must be 'inline' or 'threads', got {pump!r}")
        n = int(flags.get_flag("fleet_replicas")
                if n_replicas is None else n_replicas)
        if n < 1:
            raise ValueError("n_replicas must be >= 1")
        self.control_role_info: dict = {"tier": "hand",
                                        "reason": "explicit_roles"}
        if roles is None:
            # the prefill:decode split reads its prior from the control
            # measurement store: the best-goodput recorded pd
            # for THIS fleet size, confidence-gated back to the hand flag
            # whenever the store is silent or the hand split ties it
            from .. import control as sv_control

            n_pre, self.control_role_info = \
                sv_control.role_split_prior(n)
            if n_pre:
                if n_pre >= n:
                    raise ValueError(
                        f"FLAGS_disagg_prefill_replicas={n_pre} leaves no "
                        f"decode replica in a fleet of {n}")
                roles = ["prefill"] * n_pre + ["decode"] * (n - n_pre)
        self._roles: list[str] | None = None
        if roles is not None:
            roles = [str(r) for r in roles]
            if len(roles) != n:
                raise ValueError(f"{len(roles)} roles for {n} replicas")
            bad = sorted(set(roles) - {"prefill", "decode", "mixed"})
            if bad:
                raise ValueError(f"unknown replica roles {bad}")
            if "prefill" in roles and all(r == "prefill" for r in roles):
                raise ValueError("a disaggregated fleet needs at least one "
                                 "decode-capable replica")
            self._roles = roles
        self._disagg = bool(roles) and "prefill" in roles
        if self._disagg and pump != "inline":
            raise ValueError(
                "disaggregated fleets pump inline only: the shared "
                "PagedKVPool keeps single-writer discipline")
        self.handoff = None  # built below, after the replicas exist
        self.heartbeat_s = float(flags.get_flag("fleet_heartbeat_s")
                                 if heartbeat_s is None else heartbeat_s)
        self.affinity = bool(flags.get_flag("fleet_affinity")
                             if affinity is None else affinity)
        self.affinity_tokens = int(flags.get_flag("fleet_affinity_tokens")
                                   if affinity_tokens is None
                                   else affinity_tokens)
        self.pump = pump
        self._factory = engine_factory
        # deadline already scaled by watchdog_scale inside HeartbeatMonitor
        self.monitor = HeartbeatMonitor(self.heartbeat_s)
        self._retry = fleet_policy() if failover_budget is None \
            else fleet_policy(max_attempts=max(1, failover_budget))
        self.replicas: list[EngineReplica] = []
        self.requests: dict[int, FleetRequest] = {}
        self._next_fid = 0
        self._retire_seen: set[int] = set()
        self.stats: dict[str, int] = {
            "submits": 0, "finished": 0, "failed": 0, "sheds": 0,
            "rejects": 0, "failovers": 0, "handoffs": 0, "deaths": 0,
            "retires": 0, "replayed_tokens": 0, "dedup_tokens": 0,
            "replay_divergence": 0, "affinity_hits": 0, "affinity_misses": 0,
            "prefill_dispatches": 0, "handoff.dropped": 0,
            "handoff.replays": 0, "handoff.released": 0,
        }
        self._started = False
        for i in range(n):
            self.add_replica(self._roles[i] if self._roles else None)
        if self._disagg:
            from .handoff import HandoffManager

            pools = [getattr(r.engine.pool, "pool", None)
                     for r in self.replicas]
            if any(p is None for p in pools) \
                    or any(p is not pools[0] for p in pools):
                raise ValueError(
                    "disaggregated fleet needs every engine on ONE shared "
                    "PagedKVPool (build engines with "
                    "handoff.disagg_fleet_factory)")
            self._lease_now = 0.0
            self._lease_last = time.monotonic()
            self.handoff = HandoffManager(pools[0], ttl_s=lease_ttl_s,
                                          clock=self._lease_clock)
            for rep in self.replicas:
                rep.handoff = self.handoff
        if pump == "threads":
            self._started = True
            for rep in self.replicas:
                rep.start()

    # -- fleet membership ---------------------------------------------------
    def add_replica(self, role: str | None = None) -> EngineReplica:
        """Scale up by one failure domain (elastic counterpart of drain).
        Role-split fleets default new capacity to "decode" (decode is the
        long-lived, load-bearing stage); the factory receives the role."""
        if role is None:
            role = "decode" if self._roles is not None else "mixed"
        engine = (self._factory(role) if self._roles is not None
                  else self._factory())
        if self.handoff is not None \
                and getattr(engine.pool, "pool", None) is not self.handoff.pool:
            raise ValueError(
                "new replica's engine is not on the fleet's shared pool")
        rep = EngineReplica(len(self.replicas), engine, self.monitor,
                            role=role, handoff=self.handoff)
        if self._roles is not None and len(self._roles) == len(self.replicas):
            self._roles.append(role)
        self.replicas.append(rep)
        obs.event("fleet.replica", {"rid": rep.rid, "state": HEALTHY})
        if self.pump == "threads" and self._started:
            rep.start()
        self._refresh_gauges()
        return rep

    def drain(self, rid: int) -> None:
        """Begin drain-and-retire on one replica: admits nothing from now
        on, hands off its waiting work, finishes its running decodes,
        retires. Completion shows up as fleet.retires / fleet.drain_s."""
        rep = self.replicas[rid]
        rep.begin_drain()
        obs.event("fleet.replica", {"rid": rid, "state": DRAINING})
        self._refresh_gauges()

    def kill(self, rid: int) -> None:
        """Administrative kill (tests/chaos): same path a discovered death
        takes — mark dead and fail over its in-flight requests."""
        self._on_dead(self.replicas[rid], reason="killed")

    # -- client surface ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, eos_id=None,
               sampling=None, priority: int | None = None,
               deadline_s: float | None = None) -> int:
        """Place one request; returns the fleet request id. Raises
        AdmissionRejected only on FLEET-WIDE overload (every healthy
        replica tripping its shed signals); single-replica rejections
        are absorbed by re-placement."""
        sig = self.overload_signals()
        if sig is not None:
            self._count("sheds")
            obs.event("fleet.request",
                      {"fid": -1, "phase": "rejected", "signals": sig},
                      level="warning")
            reasons = sorted({k for s in sig.values() for k in s})
            raise AdmissionRejected("fleet:" + ",".join(reasons), 0.05,
                                    {str(r): s for r, s in sig.items()})
        fid = self._next_fid
        self._next_fid += 1
        freq = FleetRequest(fid, prompt, max_new_tokens, eos_id, sampling,
                            priority, deadline_s)
        self.requests[fid] = freq
        self._count("submits")
        try:
            self._place(freq, exclude=frozenset())
        except NoHealthyReplica:
            self._finish(freq, FAILED, "failed")
            raise
        return fid

    def abort(self, fid: int) -> None:
        freq = self.requests[fid]
        if freq.state in FLEET_TERMINAL:
            return
        freq.aborting = True
        if freq.replica is not None:
            self.replicas[freq.replica].enqueue({"abort": fid})

    def state(self, fid: int) -> str:
        return self.requests[fid].state

    def result(self, fid: int) -> list[int]:
        """The delivered-token ledger — every token exactly once, in
        order, regardless of how many replicas the request lived on."""
        return list(self.requests[fid].delivered)

    def overload_signals(self) -> dict | None:
        """Fleet-wide aggregate of per-replica overload signals.
        None = at least one healthy replica can absorb work; a dict (rid ->
        signals) = EVERY healthy replica is shedding, the fleet-wide
        refusal condition."""
        per: dict = {}
        healthy = [r for r in self.replicas if r.state == HEALTHY]
        if not healthy:
            return None  # placement failure, not overload — handled there
        for rep in healthy:
            try:
                sig = rep.engine._overload_signals()
            except Exception:  # racing a death: count it as not-shedding
                return None
            if not sig:
                return None
            per[rep.rid] = sig
        return per

    # -- progress ------------------------------------------------------------
    def step(self) -> bool:
        """One router iteration. Inline pump: pump every live replica then
        poll; threaded pump: just poll (the workers pump themselves)."""
        progressed = False
        if self.pump == "inline":
            for rep in self.replicas:
                if rep.alive:
                    progressed |= rep.pump_once()
        return self.poll() or progressed

    def poll(self) -> bool:
        """Drain replica outboxes, run the health check, account retires."""
        progressed = False
        for rep in self.replicas:
            for ev in rep.drain_events():
                progressed = True
                self._handle(rep, ev)
            if rep.state == RETIRED and rep.rid not in self._retire_seen:
                self._retire_seen.add(rep.rid)
                self._count("retires")
                dt = time.perf_counter() - (rep.t_drain_start or
                                            time.perf_counter())
                obs.histogram_observe("fleet.drain_s", dt)
                obs.event("fleet.replica", {"rid": rep.rid, "state": RETIRED,
                                            "drain_s": round(dt, 4)})
                self._refresh_gauges()
                progressed = True
        if self.handoff is not None:
            progressed |= self._reap_orphans()
        self._check_health()
        self._tick_control()
        return progressed

    def _tick_control(self) -> None:
        """Controller epochs for the fleet: tick every healthy
        replica's own controller. An engine also ticks itself inside
        step(), but an idle engine never steps — the router's poll is the
        epoch clock of last resort. Ticks are idempotent per epoch (the
        controller fires once per due time, whoever calls first), and
        threaded fleets skip this entirely: the worker thread owns its
        engine, and it ticks from inside step()."""
        if self.pump != "inline":
            return
        for rep in self.replicas:
            if rep.state != HEALTHY:
                continue
            ctrl = getattr(rep.engine, "_ctrl", None)
            if ctrl is not None:
                ctrl.tick(rep.engine)

    def _lease_clock(self) -> float:
        """Stall-capped clock for lease expiry, the TTL counterpart of the
        t_last_pump death rule: a lease only AGES while the router is
        actually pumping. Wall time accrues normally, but any single gap
        between samples — a first step blocking the inline pump for
        seconds — contributes at most TTL/8, so a healthy handoff is never
        reaped just because a neighbor replica sat in a long step. A genuine
        orphan (commit lost while the fleet keeps polling) still reaps
        after ~TTL of live router time."""
        now = time.monotonic()
        cap = self.handoff.ttl_s / 8 if self.handoff is not None else 0.25
        self._lease_now += min(now - self._lease_last, cap)
        self._lease_last = now
        return self._lease_now

    def _reap_orphans(self) -> bool:
        """Orphan recovery: every PREPARED lease past its TTL (commit lost
        to a drop or a dead inbox) reaps — its pin returns to the pool —
        and, when the lease is still the request's CURRENT one, the prompt
        replays under the normal failover budget. Superseded leases reap
        silently: their request already moved on."""
        progressed = False
        for lease in self.handoff.reap_expired():
            progressed = True
            if not self.handoff.is_current(lease):
                continue
            freq = self.requests.get(lease.fid)
            if freq is None or freq.state in FLEET_TERMINAL:
                continue
            freq.lease_id = None  # already reaped; nothing to abandon
            self._count("handoff.replays")
            self._replace(freq, exclude=frozenset(), reason="failover")
        return progressed

    def run_until_idle(self, max_steps: int = 200_000,
                       idle_sleep_s: float = 0.0005) -> None:
        """Drive step() until every request is terminal. Sleeps a hair on
        no-progress iterations so wall clock advances past heartbeat
        deadlines (that is how a silent death gets discovered)."""
        for _ in range(max_steps):
            if all(r.state in FLEET_TERMINAL for r in self.requests.values()):
                return
            if not self.step():
                time.sleep(idle_sleep_s)
        raise RuntimeError(
            f"fleet did not go idle in {max_steps} steps; live="
            f"{[f.fid for f in self.requests.values() if f.state not in FLEET_TERMINAL]}")

    def shutdown(self) -> None:
        for rep in self.replicas:
            rep.stop(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- placement -----------------------------------------------------------
    def _healthy(self, exclude=frozenset()) -> list[EngineReplica]:
        return [r for r in self.replicas
                if r.state == HEALTHY and r.rid not in exclude]

    def _affinity_rid(self, prompt) -> int:
        head = tuple(prompt[:self.affinity_tokens])
        h = hashlib.sha256(repr(head).encode()).digest()
        # modulo the FIXED replica universe so a death or retire elsewhere
        # never reshuffles every other prompt's home — and the DECODE
        # universe only: a prefill-role replica is never a home, and for
        # role-free fleets this reduces to the old h % len(replicas)
        universe = [r.rid for r in self.replicas if r.role != "prefill"]
        return universe[int.from_bytes(h[:8], "big") % len(universe)]

    def _decode_load(self, rep) -> int:
        """Placement load for a decode home. A role-split fleet cannot use
        the replica's queue depth alone: a freshly placed request parks at
        the PREFILL stage, so its decode home reports zero until the
        commit lands — and every placement would pile onto one replica.
        Count the router's own non-terminal assignments instead (plus any
        jobs already on the replica, for the co-located roles)."""
        assigned = sum(1 for q in self.requests.values()
                       if q.replica == rep.rid
                       and q.state not in FLEET_TERMINAL)
        return max(assigned, rep.load())

    def _placement_costs(self, cands) -> dict[int, float]:
        """Apply-mode placement weighting: each candidate's
        predicted seconds per goodput token for its CURRENT config, from
        its controller's last epoch. Placement then minimizes
        (load + 1) * cost — queue depth discounted by how fast the
        replica is predicted to serve it. Every replica weighs 1.0 —
        the plain least-loaded rule — unless the mode is apply AND a
        prediction exists for ALL candidates: mixed scales (one replica
        predicted at milliseconds, the rest defaulted to 1.0) would
        stampede the predicted one."""
        neutral = {r.rid: 1.0 for r in cands}
        from .. import control as sv_control

        if sv_control.mode() != "apply":
            return neutral
        out: dict[int, float] = {}
        for r in cands:
            ctrl = getattr(r.engine, "_ctrl", None)
            c = ctrl.last_cost.get(id(r.engine)) if ctrl is not None else None
            if not isinstance(c, (int, float)) or c <= 0:
                return neutral
            out[r.rid] = float(c)
        return out

    def _place(self, freq: FleetRequest, exclude=frozenset()) -> None:
        cands = [r for r in self._healthy(exclude) if r.role != "prefill"]
        if not cands:
            raise NoHealthyReplica(
                f"no healthy decode-capable replica for fid={freq.fid} "
                f"(excluded {sorted(exclude)})")
        load = self._decode_load if self._disagg else \
            (lambda r: r.load())
        costs = self._placement_costs(cands)
        rank = lambda r: ((load(r) + 1) * costs[r.rid], r.rid)
        if self.affinity:
            home = self._affinity_rid(freq.prompt)
            rep = next((r for r in cands if r.rid == home), None)
            if rep is not None:
                self._count("affinity_hits")
            else:  # graceful degradation: least-loaded healthy survivor
                self._count("affinity_misses")
                rep = min(cands, key=rank)
        else:
            rep = min(cands, key=rank)
        hits, misses = self.stats["affinity_hits"], self.stats["affinity_misses"]
        if hits + misses:
            obs.gauge_set("fleet.affinity_hit_rate", hits / (hits + misses))
        freq.replica = rep.rid
        if self._disagg:
            # the decode home is chosen, but the prompt goes to the
            # prefill stage first; the "prepared" event brings it back
            self._dispatch_prefill(freq, exclude)
        else:
            rep.enqueue(freq.job())
        obs.event("fleet.request",
                  {"fid": freq.fid, "phase": "placed", "rid": rep.rid,
                   "prefill_rid": freq.prefill_replica,
                   "failovers": freq.failovers})

    def _dispatch_prefill(self, freq: FleetRequest, exclude) -> None:
        pres = [r for r in self._healthy(exclude) if r.role == "prefill"]
        if not pres:
            raise NoHealthyReplica(
                f"no healthy prefill replica for fid={freq.fid} "
                f"(excluded {sorted(exclude)})")
        prep = min(pres, key=lambda r: (r.load(), r.rid))
        freq.prefill_replica = prep.rid
        freq.lease_id = None
        # any older lease for this fid is now history: it must still reap
        # (its pin needs reclaiming) but must not trigger a second replay
        self.handoff.supersede(freq.fid)
        prep.enqueue(freq.job())
        self._count("prefill_dispatches")

    def _replace(self, freq: FleetRequest, exclude, reason: str) -> None:
        """Move a live request to another replica. `reason` decides the
        cost: failover/reject consume the per-request budget (the
        fleet_policy max_attempts), a drain handoff is free — planned
        migration is not a failure."""
        freq.replica = None
        if freq.lease_id is not None and self.handoff is not None:
            # the replay supersedes any in-flight lease: reclaim its pin
            # now instead of waiting out the TTL
            self.handoff.abandon(freq.lease_id)
            freq.lease_id = None
        if freq.prefill_replica is not None:
            prep = self.replicas[freq.prefill_replica]
            if prep.alive:  # dead prefills already forfeited their pins
                prep.enqueue({"release": freq.fid})
            freq.prefill_replica = None
        if reason == "handoff":
            self._count("handoffs")
        else:
            if freq.failovers >= self._retry.max_attempts:
                self._finish(freq, FAILED, "failed")
                obs.event("fleet.request",
                          {"fid": freq.fid, "phase": "budget_exhausted",
                           "failovers": freq.failovers}, level="error")
                return
            freq.failovers += 1
            self._count("failovers")
            if reason == "reject":  # pace re-placement onto shedding peers
                time.sleep(self._retry.delay(freq.failovers))
        # the replay starts from the prompt; everything already delivered
        # will be regenerated and suppressed by the ledger
        self._count("replayed_tokens", len(freq.delivered))
        try:
            self._place(freq, exclude=exclude)
        except NoHealthyReplica:
            self._finish(freq, FAILED, "failed")
            obs.event("fleet.request",
                      {"fid": freq.fid, "phase": "unplaceable",
                       "failovers": freq.failovers}, level="error")

    # -- event handling ------------------------------------------------------
    def _handle(self, rep: EngineReplica, ev: tuple) -> None:
        kind, fid = ev[0], ev[1]
        freq = self.requests.get(fid)
        if freq is None or freq.state in FLEET_TERMINAL \
                or rep.rid not in (freq.replica, freq.prefill_replica):
            # stale: the request moved on (failover beat this event) — but
            # a stale "prepared" still owns a pin: abandon its lease so
            # the pages come back now rather than at TTL
            if kind == "prepared" and self.handoff is not None:
                self.handoff.abandon(ev[2])
            return
        if kind == "tokens":
            start, toks = ev[2], ev[3]
            for i, tok in enumerate(toks, start):
                if i < len(freq.delivered):
                    # replayed ground we already delivered: suppress
                    self._count("dedup_tokens")
                    if tok != freq.delivered[i]:
                        # sampling replay re-drew; greedy never gets here
                        self._count("replay_divergence")
                else:
                    if freq.t_first is None:
                        freq.t_first = time.perf_counter()
                        obs.histogram_observe(
                            "fleet.ttft_s", freq.t_first - freq.t_submit)
                    freq.delivered.append(tok)
        elif kind == "done":
            estate = ev[2]
            if estate == "shed" and not freq.aborting:
                # a replica shedding under pressure is that replica's
                # problem — re-place on a survivor under the budget
                self._count("rejects")
                self._replace(freq, exclude={rep.rid}, reason="reject")
            else:
                self._finish(freq, estate,
                             "finished" if estate == FINISHED else None)
        elif kind == "reject":
            self._count("rejects")
            self._replace(freq, exclude={rep.rid}, reason="reject")
        elif kind == "handoff":
            self._replace(freq, exclude={rep.rid}, reason="handoff")
        elif kind == "prepared":
            self._on_prepared(freq, ev[2])
        elif kind == "adopted":
            if freq.lease_id != ev[2]:
                return  # a superseded adopt; the replay owns the request
            if freq.prefill_replica is not None:
                prep = self.replicas[freq.prefill_replica]
                if prep.alive:
                    prep.enqueue({"release": fid})
                    self._count("handoff.released")
                freq.prefill_replica = None
            freq.lease_id = None
            if freq.aborting:
                # the abort raced the handoff: re-issue it to the adopter
                rep.enqueue({"abort": fid})
        elif kind == "commit_failed":
            if freq.lease_id != ev[2]:
                return  # this lease was already reaped/abandoned + replayed
            self._count("handoff.replays")
            self._replace(freq, exclude={rep.rid}, reason="failover")

    def _on_prepared(self, freq: FleetRequest, lid: str) -> None:
        """The prefill stage published `freq` under lease `lid`: forward
        the commit to the decode home (re-picking one if the original
        died while the prompt prefilled). `disagg_handoff_drop` loses this
        message in flight — the lease stays published and the reaper
        recovers it at TTL."""
        try:
            fault_point("disagg_handoff_drop")
        except InjectedFault:
            self._count("handoff.dropped")
            return
        freq.lease_id = lid
        target = None
        if freq.replica is not None \
                and self.replicas[freq.replica].state == HEALTHY:
            target = self.replicas[freq.replica]
        else:
            cands = [r for r in self._healthy() if r.role != "prefill"]
            if cands:
                target = min(cands, key=lambda r: (r.load(), r.rid))
                freq.replica = target.rid
        if target is None:
            self.handoff.abandon(lid)
            freq.lease_id = None
            if freq.prefill_replica is not None:
                prep = self.replicas[freq.prefill_replica]
                if prep.alive:
                    prep.enqueue({"release": freq.fid})
                freq.prefill_replica = None
            self._finish(freq, FAILED, "failed")
            return
        target.enqueue({"commit": lid, "fid": freq.fid})

    def _finish(self, freq: FleetRequest, state: str,
                counter: str | None) -> None:
        freq.state = state
        freq.t_done = time.perf_counter()
        if counter:
            self._count(counter)
        if state == FINISHED:
            obs.histogram_observe("fleet.request_s",
                                  freq.t_done - freq.t_submit)
        obs.event("fleet.request", {"fid": freq.fid, "phase": state})

    # -- health --------------------------------------------------------------
    def _check_health(self) -> None:
        now = time.monotonic()
        for name in self.monitor.overdue(now=now):
            rep = next((r for r in self.replicas if r.name == name), None)
            if rep is None or not rep.alive:
                continue
            # a stale beat alone is not death: on the inline pump a
            # neighbor's multi-second first step (kernel builds, first
            # GEMM shapes) blocks the shared thread,
            # starving every OTHER replica's beat. Death = the replica WAS
            # pumped after its last beat and still never beat again — only
            # kills, hangs and crashes look like that.
            last_beat = now - self.monitor.age(name, now=now)
            if rep.t_last_pump > last_beat:
                self._on_dead(rep, reason="heartbeat")

    def _on_dead(self, rep: EngineReplica, reason: str) -> None:
        rep.mark_dead()
        self._count("deaths")
        obs.event("fleet.replica",
                  {"rid": rep.rid, "state": DEAD, "reason": reason,
                   "crash": repr(rep.crash) if rep.crash else None},
                  level="error")
        if self._disagg:
            # a dead engine's pins never release themselves: forfeit its
            # owner ledger back to the SHARED pool. Lease pins belong to
            # the HandoffManager, so in-transit pages survive this.
            forfeit = getattr(rep.engine.pool, "forfeit", None)
            freed = forfeit() if forfeit is not None else 0
            if freed:
                obs.event("fleet.replica",
                          {"rid": rep.rid, "state": DEAD,
                           "forfeited_pages": freed}, level="warning")
        self._refresh_gauges()
        victims = [f for f in self.requests.values()
                   if f.state not in FLEET_TERMINAL
                   and self._victim_of(f, rep.rid)]
        for freq in victims:
            self._replace(freq, exclude={rep.rid}, reason="failover")

    def _victim_of(self, freq: FleetRequest, rid: int) -> bool:
        """Does `rid` dying strand `freq`? Non-disagg: placed there. With
        disaggregation the lease decides: a request whose PREFILL died
        pre-lease lost its prompt work (replay); one whose lease is
        published survives a prefill death (the pin lives in the shared
        pool, the commit proceeds); a DECODE death strands both adopted
        requests (classic failover, dedup'd by the ledger) and leases
        whose commit sat in the dead inbox (replay now beats waiting out
        the TTL); a decode death while the prompt still prefills strands
        nothing — "prepared" re-targets a survivor."""
        if freq.replica == rid:
            return not self._disagg or freq.lease_id is not None \
                or freq.prefill_replica is None
        return freq.prefill_replica == rid and freq.lease_id is None

    # -- accounting ----------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n
        obs.counter_inc(f"fleet.{key}", n)

    def _refresh_gauges(self) -> None:
        by_state = {HEALTHY: 0, DRAINING: 0, DEAD: 0, RETIRED: 0}
        for rep in self.replicas:
            by_state[rep.state] += 1
            obs.gauge_set("fleet.replica_state", STATE_ORDINAL[rep.state],
                          labels={"rid": str(rep.rid)})
        obs.gauge_set("fleet.replicas_healthy", by_state[HEALTHY])
        obs.gauge_set("fleet.replicas_draining", by_state[DRAINING])
        obs.gauge_set("fleet.replicas_dead", by_state[DEAD])

    def reset_stats(self) -> None:
        """Measurement boundary (mirrors ServingEngine.reset_stats): zero
        the router counters, the handoff lease counters, and the fleet.*
        registry series; per-engine serving.* counters reset separately
        via each engine."""
        for k in self.stats:
            self.stats[k] = 0
        if self.handoff is not None:
            for k in self.handoff.stats:
                self.handoff.stats[k] = 0
        obs.reset("fleet.")
