"""The declared metric schema: every name the runtime is allowed to emit
(the JAX package's observability/schema.py, the same names, plus the
dataset stages of the port's data pipeline).

One flat list, imported by the registry at construction. A metric
recorded under a name that is not declared here still lands (post-mortems
beat purity), but the registry tracks it in `snapshot()["undeclared"]`,
and tests/test_torch_observability.py fails on any stage literal of the
port's source that is not declared — adding a counter is a schema act, not
just a call site. The serving, fleet, tuning and guardrail names are
declared for the modules that will record them.

Kinds:
  stage     — the profiler.record_stage/bump accumulators ([events, seconds]
              pairs; the pipeline vocabulary, kept verbatim so every
              legacy call site lands unchanged)
  counter   — monotonically increasing value, optionally labeled
  gauge     — last-set value (occupancy, rates)
  histogram — streaming distribution with p50/p95/p99 (log-spaced buckets)
  event     — structured record on the event ring / JSONL stream
"""
from __future__ import annotations

STAGE, COUNTER, GAUGE, HISTOGRAM, EVENT = (
    "stage", "counter", "gauge", "histogram", "event")

# (name, kind, help, label keys)
DECLARED: list[tuple] = [
    # -- pipeline stage counters (profiler.record_stage / profiler.bump) ----
    ("pipeline.host_ingest", STAGE,
     "DeviceLoader producer: host batch materialization", ()),
    ("pipeline.device_put", STAGE,
     "host->device staging transfers (DeviceLoader / feed_placer)", ()),
    ("pipeline.dispatch", STAGE,
     "Executor compiled-step dispatch (host side of one async step)", ()),
    ("pipeline.window_drain", STAGE,
     "run_async window-boundary waits on the oldest completion token", ()),
    ("feed.skip_corrupt", STAGE,
     "corrupt records skipped under FLAGS_feed_skip_corrupt", ()),
    ("dataset.parse", STAGE,
     "Dataset host threads: MultiSlot file parsing (native parser)", ()),
    ("dataset.assemble", STAGE,
     "Dataset host threads: batch slicing, reshape and dtype cast", ()),
    ("emb.resolved_batches", STAGE,
     "tiered-embedding batches resolved through the hot-ID cache", ()),
    ("ps.nonfinite_drop", STAGE,
     "non-finite gradient sends dropped by the pserver", ()),
    ("comm.nonfinite_drop", STAGE,
     "non-finite gradient sends dropped by the async communicator", ()),
    # -- serving runtime (serving/engine.py) --------------------------------
    ("serving.prefills", COUNTER, "prompt prefills executed", ()),
    ("serving.decode_steps", COUNTER, "batched decode steps", ()),
    ("serving.decode_tokens", COUNTER, "tokens accepted by decode", ()),
    ("serving.preemptions", COUNTER,
     "requests preempted back to the waiting queue", ()),
    ("serving.aborts", COUNTER, "requests aborted", ()),
    ("serving.prefill_tokens_computed", COUNTER,
     "prompt tokens that actually ran through prefill compute", ()),
    ("serving.prefix_hit_tokens", COUNTER,
     "prompt tokens served from the prefix cache", ()),
    ("serving.prefix_lookups", COUNTER, "prefix-cache lookups", ()),
    ("serving.prefix_full_hits", COUNTER,
     "prompts fully covered by cached pages (zero-prefill admits)", ()),
    ("serving.cow_copies", COUNTER, "copy-on-write page copies", ()),
    ("serving.spec_steps", COUNTER, "speculative draft-verify steps", ()),
    ("serving.spec_proposed", COUNTER, "draft tokens proposed", ()),
    ("serving.spec_accepted", COUNTER, "draft tokens accepted", ()),
    ("serving.pages_in_use", GAUGE, "KV pool pages currently mapped", ()),
    ("serving.pool_occupancy", GAUGE,
     "KV pool occupancy fraction (pages_in_use / num_pages)", ()),
    ("serving.leaked_pages", GAUGE,
     "pages no live request or cache entry accounts for (must be 0)", ()),
    ("serving.queue_s", HISTOGRAM,
     "request queue time: submit -> admission", ()),
    ("serving.ttft_s", HISTOGRAM,
     "time to first token: submit -> first generated token", ()),
    ("serving.request_s", HISTOGRAM,
     "request latency: submit -> finished", ()),
    ("serving.prefill.seconds", HISTOGRAM,
     "prefill span durations (also a torch.profiler range)", ()),
    ("serving.decode.seconds", HISTOGRAM,
     "decode-step span durations (also a torch.profiler range)", ()),
    ("serving.request", EVENT,
     "per-request lifecycle record: queued/admitted/first_token/finished/"
     "aborted/deadline_exceeded/shed/rejected/quarantined",
     ("rid", "phase")),
    # -- serving resilience (deadlines/shedding/supervision) ------
    ("serving.deadline_exceeded", COUNTER,
     "requests expired past their TTL (at admission or between steps)", ()),
    ("serving.shed", COUNTER,
     "WAITING requests shed by admission control or the ladder", ()),
    ("serving.rejects", COUNTER,
     "submits rejected with AdmissionRejected (retry-after surfaced)", ()),
    ("serving.step_retries", COUNTER,
     "compiled-step dispatch retries absorbed by the supervisor", ()),
    ("serving.recovery.passes", COUNTER,
     "engine recovery passes (quarantine + pool rebuild + replay)", ()),
    ("serving.recovery.replayed", COUNTER,
     "surviving requests replayed from their prompts by recovery", ()),
    ("serving.recovery.quarantined", COUNTER,
     "poisoned requests quarantined (aborted, pages forfeited) by "
     "recovery", ()),
    ("serving.handoff_extracts", COUNTER,
     "prefilled requests extracted HANDED_OFF for disaggregated "
     "prefill->decode transfer", ()),
    ("serving.adopts", COUNTER,
     "lease-transferred requests adopted mid-decode from a prefill "
     "engine (prefill skipped entirely)", ()),
    ("serving.ladder.spec_off", COUNTER,
     "degradation-ladder climbs to rung 1: speculative decode off", ()),
    ("serving.ladder.lookahead_shrink", COUNTER,
     "degradation-ladder climbs to rung 2: admission reserves no decode "
     "lookahead page", ()),
    ("serving.ladder.cache_evict", COUNTER,
     "degradation-ladder climbs to rung 3: prefix-cache LRU tail "
     "evicted under pressure", ()),
    ("serving.ladder.shed", COUNTER,
     "degradation-ladder climbs to rung 4: lowest-priority waiters "
     "shed", ()),
    ("serving.ladder_rung", GAUGE,
     "current degradation-ladder rung (0 = nominal .. 4 = shedding)", ()),
    ("serving.degrade", EVENT,
     "ladder transition record (rung, direction, pressure signals)", ()),
    ("serving.recovery", EVENT,
     "recovery-pass record (reason, quarantined, replayed, problems)", ()),
    ("serving.step_retry", EVENT,
     "one absorbed dispatch retry (kind, attempt, error)", ()),
    # -- serving fleet (serving/fleet/: router + replicas) ------------------
    ("fleet.submits", COUNTER, "requests accepted by the fleet router", ()),
    ("fleet.finished", COUNTER, "fleet requests finished", ()),
    ("fleet.failed", COUNTER,
     "fleet requests failed: failover budget exhausted or no healthy "
     "replica left to place on", ()),
    ("fleet.sheds", COUNTER,
     "submits refused fleet-wide (EVERY healthy replica shedding)", ()),
    ("fleet.rejects", COUNTER,
     "per-replica admission rejections absorbed by re-placement", ()),
    ("fleet.failovers", COUNTER,
     "budget-consuming re-placements (replica death or rejection)", ()),
    ("fleet.handoffs", COUNTER,
     "budget-free drain handoffs of waiting work off a DRAINING replica",
     ()),
    ("fleet.deaths", COUNTER,
     "replicas declared DEAD (missed heartbeats or administrative kill)",
     ()),
    ("fleet.retires", COUNTER,
     "replicas that completed drain-and-retire", ()),
    ("fleet.replayed_tokens", COUNTER,
     "already-delivered tokens a re-placement must regenerate", ()),
    ("fleet.dedup_tokens", COUNTER,
     "regenerated tokens suppressed by the router's delivered ledger "
     "(each client token delivered exactly once)", ()),
    ("fleet.replay_divergence", COUNTER,
     "replayed positions that disagreed with the ledger (possible under "
     "temperature sampling; must be 0 under greedy)", ()),
    ("fleet.affinity_hits", COUNTER,
     "placements landing on the prompt's affinity home replica", ()),
    ("fleet.affinity_misses", COUNTER,
     "placements degraded to least-loaded (home not HEALTHY)", ()),
    ("fleet.affinity_hit_rate", GAUGE,
     "affinity_hits / (hits + misses) over the router's lifetime", ()),
    ("fleet.replicas_healthy", GAUGE, "replicas currently HEALTHY", ()),
    ("fleet.replicas_draining", GAUGE, "replicas currently DRAINING", ()),
    ("fleet.replicas_dead", GAUGE, "replicas currently DEAD", ()),
    ("fleet.replica_state", GAUGE,
     "per-replica lifecycle state (0=healthy 1=draining 2=retired 3=dead)",
     ("rid",)),
    ("fleet.drain_s", HISTOGRAM,
     "drain-and-retire duration: begin_drain -> RETIRED", ()),
    ("fleet.ttft_s", HISTOGRAM,
     "fleet-level time to first DELIVERED token (failover included)", ()),
    ("fleet.request_s", HISTOGRAM,
     "fleet-level request latency: submit -> finished", ()),
    ("fleet.replica", EVENT,
     "replica lifecycle record (healthy/draining/dead/retired/crashed)",
     ()),
    ("fleet.request", EVENT,
     "fleet request lifecycle record (placed/finished/failed/rejected/"
     "budget_exhausted/unplaceable)", ()),
    # -- disaggregated prefill/decode handoff (serving/fleet/handoff.py) ----
    ("fleet.prefill_dispatches", COUNTER,
     "prompts dispatched to a prefill-role replica (disaggregated "
     "placement: decode home chosen, prefill stage runs first)", ()),
    ("fleet.handoff.prepared", COUNTER,
     "prefill->decode handoffs published under a lease (PREPARE)", ()),
    ("fleet.handoff.committed", COUNTER,
     "handoffs adopted by a decode engine (COMMIT: lease refcount "
     "transferred, decode resumes mid-request)", ()),
    ("fleet.handoff.commit_failed", COUNTER,
     "commits rejected: unknown lease, double commit, expiry race, or a "
     "draining/bouncing adopter", ()),
    ("fleet.handoff.released", COUNTER,
     "post-commit prefill-pin releases confirmed to the prefill side", ()),
    ("fleet.handoff.dropped", COUNTER,
     "prepared messages lost in flight (disagg_handoff_drop site): the "
     "lease stays published and the reaper recovers it at TTL", ()),
    ("fleet.handoff.replays", COUNTER,
     "handed-off requests replayed from the prompt (reaped lease, failed "
     "commit, or a death mid-handoff)", ()),
    ("fleet.handoff.s", HISTOGRAM,
     "handoff latency: lease PREPARE -> decode COMMIT", ()),
    ("fleet.handoff", EVENT,
     "handoff lifecycle record (prepared/committed/reaped/abandoned)", ()),
    ("fleet.lease.granted", COUNTER,
     "KV leases granted (page tables pinned in the shared pool)", ()),
    ("fleet.lease.reaped", COUNTER,
     "leases reclaimed: TTL expiry, abandonment, or expiry at commit", ()),
    ("fleet.lease.expired_at_commit", COUNTER,
     "commits that lost the expiry race (rejected atomically; the "
     "request replays)", ()),
    ("fleet.lease.active", GAUGE, "leases currently PREPARED", ()),
    ("fleet.lease.pinned_pages", GAUGE,
     "shared-pool pages currently pinned by leases (in transit)", ()),
    # -- learned serving control (serving/control/) -------------------------
    ("serving.control.proposals", COUNTER,
     "knob-config proposals resolved, by tier (learned = a gated ridge "
     "prediction stood; hand = the flag config served)", ("tier",)),
    ("serving.control.fallbacks", COUNTER,
     "proposals that fell back to the hand flags, by reason (no_model/"
     "no_group/accuracy/envelope/features/off/...)", ("reason",)),
    ("serving.control.staged", COUNTER,
     "apply-mode proposals staged as a pending EngineConfig", ()),
    ("serving.control.applies", COUNTER,
     "pending EngineConfigs adopted at a safe boundary (engine idle gap "
     "/ router epoch tick)", ()),
    ("serving.control.rewarmups", COUNTER,
     "warmup_decode re-runs forced by an adopted bucket-geometry change "
     "(keeps XLA compiles off the serving path)", ()),
    ("serving.control.regime", GAUGE,
     "current traffic-regime id (stable hash bucket of the regime key)",
     ()),
    ("serving.control.goodput_rel_err", HISTOGRAM,
     "realized-vs-predicted goodput relative error per controller epoch "
     "(the controller grading its own prior)", ()),
    ("serving.control.actuation", EVENT,
     "actuation lifecycle record (staged/adopted, geometry change, "
     "rewarm)", ()),
    # -- training step telemetry (executor.py async window) -----------------
    ("train.steps", COUNTER, "async steps drained to completion", ()),
    ("train.step_latency_s", HISTOGRAM,
     "dispatch -> completion-token latency per drained step", ()),
    ("train.batches_per_sec", GAUGE,
     "train_from_dataset steady-state batch rate", ()),
    ("train.jit_compiles", COUNTER,
     "whole-block XLA compiles observed by jit_compile_counter", ()),
    # -- numeric guardrails (resilience/guardrails.py) ----------------------
    ("guard.events", COUNTER,
     "StepGuard verdicts by action (skip/rewind/...)", ("action",)),
    ("guard.step", EVENT,
     "structured StepGuard event (the health-vector verdicts)", ()),
    # -- hang watchdog (resilience/watchdog.py) -----------------------------
    ("watchdog.stalls", COUNTER, "StallError raises", ()),
    ("watchdog.stall", EVENT,
     "watchdog stall dump (what/window/in-flight state)", ()),
    # -- autotuner provenance (tuning/policy.py) ----------------------------
    ("tuning.decisions", COUNTER,
     "decide() resolutions by (op, tier) — tier in "
     "db/learned/analytic/default",
     ("op", "tier")),
    # -- learned cost model (tuning/learned/) -------------------------------
    ("tuning.learned.predictions", COUNTER,
     "learned-tier decisions that stood (confidence gates passed, "
     "validate accepted)", ("op",)),
    ("tuning.learned.fallbacks", COUNTER,
     "learned-tier attempts that fell back to the analytic prior, by "
     "reason (accuracy/envelope/features/feature_drift/validate)",
     ("op", "reason")),
    ("tuning.learned.explore_promotions", COUNTER,
     "explore-mode candidates promoted to swept DB entries by an "
     "out-of-band online verdict", ("op",)),
    # -- tiered embeddings (embedding/engine.py) ----------------------------
    ("emb.hit_ids", COUNTER,
     "id occurrences served from the hot-ID cache", ("table",)),
    ("emb.miss_ids", COUNTER,
     "id occurrences that missed the cache (host-tier prefetch)",
     ("table",)),
    ("emb.evictions", COUNTER, "cache rows evicted (written back)",
     ("table",)),
    ("emb.writebacks", COUNTER, "dirty rows written back to the host tier",
     ("table",)),
    # -- pserver liveness (distributed/ps_rpc.py) ---------------------------
    ("ps.evictions", COUNTER,
     "trainers evicted from the sync barrier by the liveness monitor", ()),
    ("ps.rejoins", COUNTER, "evicted trainers re-admitted", ()),
    ("ps.liveness", EVENT, "evict/rejoin/grace-shutdown liveness record",
     ()),
    # -- SLO monitor (observability/slo.py) ---------------------------------
    ("slo.breaches", COUNTER, "SLO rule breaches", ("rule", "severity")),
    ("slo.breach", EVENT, "SLO breach record (rule, value, threshold)", ()),
]

DECLARED_NAMES = frozenset(spec[0] for spec in DECLARED)

# the stage names every profiler.bump/record_stage call site uses —
# tests/test_torch_observability.py greps the port's source against this
# set, so a new stage literal must be declared here to stay green
STAGE_NAMES = frozenset(s[0] for s in DECLARED if s[1] == STAGE)
