"""Replica fleet: failure-domain isolation for the serving engine.

One `FleetRouter` in front of N in-process `EngineReplica`s — each a full
`ServingEngine` with its own KV pool, prefix cache, and executor,
so a replica death takes nothing down but itself. The router owns
placement (prefix-cache affinity, least-loaded fallback), heartbeat
health checking, failover replay with exactly-once token delivery, and
drain-and-retire live migration. `handoff.py` adds disaggregated
prefill/decode serving over the same machinery: role-split replicas on
ONE shared `PagedKVPool` exchanging finished prompt KV through TTL'd
two-phase leases (prepare -> commit, orphans reaped and replayed). See
router.py / handoff.py for the contracts, and FLAGS_fleet_* /
FLAGS_disagg_* for the knobs.
"""
from .handoff import (  # noqa: F401
    HandoffError, HandoffManager, KVLease, LeaseExpired,
    disagg_fleet_factory)
from .replica import (  # noqa: F401
    DEAD, DRAINING, HEALTHY, RETIRED, STATE_ORDINAL, EngineReplica)
from .router import (  # noqa: F401
    FLEET_TERMINAL, FleetRequest, FleetRouter, NoHealthyReplica)

__all__ = [
    "EngineReplica", "FleetRouter", "FleetRequest", "NoHealthyReplica",
    "HEALTHY", "DRAINING", "DEAD", "RETIRED", "STATE_ORDINAL",
    "FLEET_TERMINAL",
    "HandoffManager", "KVLease", "HandoffError", "LeaseExpired",
    "disagg_fleet_factory",
]
