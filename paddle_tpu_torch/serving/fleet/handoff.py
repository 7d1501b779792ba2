"""Transactional KV handoff for disaggregated prefill/decode serving.

The per-request page tables and refcounts make the
prefill->decode transfer a TABLE move, not a copy — the windowed/decode
programs already read pooled context, so a decode engine can adopt foreign
pages the moment it learns their ids. The hard part is surviving a crash on
either side of the move without leaking a page, double-freeing one, or
changing one output token. This module is that protocol:

    PREPARE   the prefill replica finishes a prompt, extracts the request
              from its engine (`ServingEngine.extract_for_handoff` — the
              request's own pages stay held: the PREFILL PIN), and
              publishes the transfer state under a TTL'd lease
              (`HandoffManager.prepare` -> `PagedKVPool.lease_grant`,
              one more pin per page). Two pins now guard the pages; the
              lease pin lives in the SHARED pool, so it survives the
              prefill host's death.

    COMMIT    the decode replica adopts (`commit` -> `lease_transfer`):
              the lease's refcount moves to the adopting engine's owner
              ledger with no release/share window, and the engine resumes
              decoding mid-request (`adopt_request`). Only AFTER the
              commit does the router tell the prefill side to drop its
              pin (`release_handoff`). Double commits and commits that
              lose the expiry race are rejected atomically — never a
              half-adopted table.

    REAP      `reap_expired` reclaims orphaned prepares: a lease whose
              commit never arrived (dropped handoff, dead decode inbox)
              releases its pin at TTL and the router replays the prompt
              under the ordinary fleet_policy failover budget. A reaped
              lease can never be committed afterwards (commit-after-reap
              rejects, the replay wins).

Every transition is audit-visible: leases are a first-class holder class in
`PagedKVPool.check_consistency`, so a mid-handoff page (pinned, mapped by
no table) audits clean and a forged lease audits dirty.

`disagg_fleet_factory` builds the role-split topology: ONE shared
`PagedKVPool` + ONE shared device scope (weights and KV pools), engines
wrapped in per-owner `OwnedPoolView`s, prefill engines in `prefill_only`
mode and decode engines without a prefix cache (they never prefill).

Knobs: FLAGS_disagg_lease_ttl_s (x FLAGS_watchdog_scale),
FLAGS_disagg_prefill_replicas. Metrics: fleet.lease.* / fleet.handoff.*.
"""
from __future__ import annotations

import itertools
import threading
import time

from ... import observability as obs
from ...resilience.faults import InjectedFault, fault_point
from ...resilience.watchdog import watchdog_scale
from ..kv_cache import PagedKVPool

__all__ = ["HandoffManager", "KVLease", "HandoffError", "LeaseExpired",
           "PREPARED", "COMMITTED", "REAPED", "disagg_fleet_factory"]

PREPARED, COMMITTED, REAPED = "prepared", "committed", "reaped"


class HandoffError(RuntimeError):
    """A commit that cannot proceed: unknown lease, double commit, or a
    draining/dead adopter bouncing the job. The router replays the prompt
    under the fleet failover budget."""


class LeaseExpired(HandoffError):
    """The commit lost the race against the reaper's clock (or arrived
    after the reap): the pin is reclaimed exactly once, on this side of
    the rejection, and the replay owns the request from here."""


class KVLease:
    """One in-transit request: the published transfer state plus the lease
    lifecycle. `payload` is ServingEngine.extract_for_handoff's dict (token
    history, page table, sampling, deadline); `pages` is the pinned table
    the pool tracks under `lease_id`."""

    __slots__ = ("lease_id", "fid", "payload", "state", "t_prepare",
                 "expiry")

    def __init__(self, lease_id: str, fid: int, payload: dict,
                 expiry: float):
        self.lease_id = lease_id
        self.fid = fid
        self.payload = payload
        self.state = PREPARED
        self.t_prepare = time.perf_counter()
        self.expiry = expiry

    @property
    def pages(self) -> list[int]:
        return list(self.payload["pages"])


class HandoffManager:
    """The lease table over ONE shared `PagedKVPool`.

    Thread-safe (threaded pumps prepare/commit concurrently), but the pool
    mutations ride the caller's pump thread — disaggregated fleets run the
    inline pump so the shared pool keeps its single-writer discipline.
    `clock` is injectable for deterministic reaper tests; production uses
    time.monotonic. The TTL is FLAGS_disagg_lease_ttl_s widened by
    FLAGS_watchdog_scale (slow CI must not reap healthy handoffs).
    """

    def __init__(self, pool: PagedKVPool, ttl_s: float | None = None,
                 clock=time.monotonic):
        from ... import flags

        self.pool = pool
        self.ttl_s = float(flags.get_flag("disagg_lease_ttl_s")
                           if ttl_s is None else ttl_s) * watchdog_scale()
        self._clock = clock
        self._lock = threading.Lock()
        self.leases: dict[str, KVLease] = {}
        self._latest: dict[int, str | None] = {}  # fid -> newest lease id
        self._next = 0
        self.stats = {"granted": 0, "committed": 0, "reaped": 0,
                      "expired_at_commit": 0, "commit_failed": 0}

    # -- lifecycle -----------------------------------------------------------
    def prepare(self, fid: int, payload: dict) -> str:
        """Publish one request under a fresh TTL'd lease; pins the page
        table in the shared pool. Returns the lease id."""
        with self._lock:
            lid = f"lease-{self._next}"
            self._next += 1
            self.pool.lease_grant(lid, payload["pages"])
            self.leases[lid] = KVLease(lid, fid, payload,
                                       self._clock() + self.ttl_s)
            self._latest[fid] = lid
            self._count("lease.granted")
            self._gauges_locked()
        obs.event("fleet.handoff", {"lease": lid, "fid": fid,
                                    "phase": PREPARED,
                                    "pages": len(payload["pages"])})
        return lid

    def commit(self, lease_id: str) -> KVLease:
        """Adopt a PREPARED lease: its pin's refcount transfers to the
        caller (who must record it via OwnedPoolView.adopt_transferred —
        ServingEngine.adopt_request does). Raises HandoffError on unknown/
        double commits and LeaseExpired when the reaper's clock won."""
        with self._lock:
            lease = self.leases.get(lease_id)
            if lease is None:
                self._count("handoff.commit_failed")
                raise HandoffError(f"commit of unknown lease {lease_id!r}")
            if lease.state == COMMITTED:
                self._count("handoff.commit_failed")
                raise HandoffError(f"double commit of lease {lease_id!r}")
            if lease.state == REAPED:
                self._count("handoff.commit_failed")
                raise LeaseExpired(
                    f"commit after reap of lease {lease_id!r}")
            try:
                # chaos: the reaper's clock wins the expiry race exactly
                # as the commit arrives
                fault_point("disagg_lease_expire_race")
            except InjectedFault:
                lease.expiry = float("-inf")
            if self._clock() > lease.expiry:
                self._reap_locked(lease)
                self._count("lease.expired_at_commit", "expired_at_commit")
                self._count("handoff.commit_failed")
                raise LeaseExpired(
                    f"lease {lease_id!r} expired before commit "
                    f"(ttl {self.ttl_s:.3f}s)")
            lease.state = COMMITTED
            self.pool.lease_transfer(lease_id)
            self._count("handoff.committed", "committed")
            self._gauges_locked()
        obs.histogram_observe("fleet.handoff.s",
                              time.perf_counter() - lease.t_prepare)
        obs.event("fleet.handoff", {"lease": lease_id, "fid": lease.fid,
                                    "phase": COMMITTED})
        return lease

    def reap_expired(self) -> list[KVLease]:
        """Reclaim every PREPARED lease past its TTL (pin released, state
        REAPED). The router calls this each poll and replays the reaped
        fids; `is_current` filters superseded leases so an old orphan
        never triggers a spurious replay of a request that moved on."""
        now = self._clock()
        reaped = []
        with self._lock:
            for lease in list(self.leases.values()):
                if lease.state == PREPARED and now > lease.expiry:
                    self._reap_locked(lease)
                    reaped.append(lease)
            if reaped:
                self._gauges_locked()
        for lease in reaped:
            obs.event("fleet.handoff",
                      {"lease": lease.lease_id, "fid": lease.fid,
                       "phase": REAPED, "pages": len(lease.pages)},
                      level="warning")
        return reaped

    def abandon(self, lease_id: str) -> bool:
        """Reap one lease NOW regardless of TTL (the router learned it is
        an orphan: the request already failed over elsewhere, or the
        adopter bounced the commit). No-op on committed/reaped leases."""
        with self._lock:
            lease = self.leases.get(lease_id)
            if lease is None or lease.state != PREPARED:
                return False
            self._reap_locked(lease)
            self._gauges_locked()
        obs.event("fleet.handoff", {"lease": lease_id, "fid": lease.fid,
                                    "phase": "abandoned"}, level="warning")
        return True

    def supersede(self, fid: int) -> None:
        """Mark any outstanding lease for `fid` as no longer current (the
        router is replaying the prompt from scratch): the lease still
        reaps at TTL to reclaim its pin, but its reap must not trigger a
        second replay."""
        with self._lock:
            self._latest[fid] = None

    def is_current(self, lease: KVLease) -> bool:
        with self._lock:
            return self._latest.get(lease.fid) == lease.lease_id

    def active(self) -> int:
        with self._lock:
            return sum(1 for l in self.leases.values()
                       if l.state == PREPARED)

    # -- internals -----------------------------------------------------------
    def _reap_locked(self, lease: KVLease) -> None:
        lease.state = REAPED
        self.pool.lease_release(lease.lease_id)
        self._count("lease.reaped", "reaped")

    def _count(self, metric: str, key: str | None = None) -> None:
        obs.counter_inc("fleet." + metric)
        k = key if key is not None else metric.split(".", 1)[1]
        if k in self.stats:
            self.stats[k] += 1

    def _gauges_locked(self) -> None:
        obs.gauge_set("fleet.lease.active",
                      sum(1 for l in self.leases.values()
                          if l.state == PREPARED))
        obs.gauge_set("fleet.lease.pinned_pages", self.pool.leased_page_count)


def disagg_fleet_factory(cfg=None, **engine_kw):
    """Build the role-split engine factory: every engine it returns shares
    ONE `PagedKVPool` (each behind its own `OwnedPoolView`) and ONE device
    scope — identical seeds make the per-engine weight inits bitwise
    no-ops, and the shared KV pools are what makes the handoff a table
    move. `factory(role)` builds a "prefill" engine (prefill_only, keeps
    the prefix cache: shared-prefix absorption happens at the prefill
    stage), a "decode" engine (no prefix cache — it never prefills), or a
    "mixed" co-located engine over the same shared pool.

    The shared pool is exposed as `factory.shared_pool` (the router builds
    its HandoffManager over it). Engine kwargs pass through; `pool_pages`,
    `page_size` and `seed` apply to every role.
    """
    from ...executor import Scope
    from ..engine import ServingEngine

    base_kw = dict(engine_kw)
    pool_pages = base_kw.pop("pool_pages", None)
    page_size = base_kw.pop("page_size", None)
    if pool_pages is None or page_size is None:
        from ... import flags

        pool_pages = pool_pages or flags.get_flag("serving_pool_pages")
        page_size = page_size or flags.get_flag("serving_page_size")
    shared_pool = PagedKVPool(int(pool_pages), int(page_size))
    shared_scope = Scope()
    seq = itertools.count()

    def factory(role: str = "mixed") -> ServingEngine:
        kw = dict(base_kw)
        if role == "prefill":
            kw["prefill_only"] = True
            kw["draft_k"] = 0  # the prefill stage never decodes
        elif role == "decode":
            kw["prefix_cache"] = False
        return ServingEngine(cfg, page_size=page_size,
                             pool_pages=pool_pages,
                             shared_pool=shared_pool,
                             shared_scope=shared_scope,
                             pool_owner=f"{role}{next(seq)}", **kw)

    factory.shared_pool = shared_pool
    factory.shared_scope = shared_scope
    return factory
