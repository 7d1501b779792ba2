"""Global flags registry of the PyTorch port.

Same contract as the JAX package's flags module: flags are declared here
with defaults and overridden from the environment (`FLAGS_<name>`) at
import. Only the flags the ported modules read are declared.
"""
from __future__ import annotations

import os
from typing import Any

_FLAGS: dict[str, Any] = {}
_DEFS: dict[str, tuple[type, str]] = {}


def _define(name: str, default, help: str):
    ftype = type(default)
    _DEFS[name] = (ftype, help)
    env = os.environ.get("FLAGS_" + name)
    _FLAGS[name] = _parse(ftype, env) if env is not None else default


def _parse(ftype, text: str):
    if ftype is bool:
        return text.strip().lower() in ("1", "true", "yes", "on")
    return ftype(text)


def get_flag(name: str):
    if name not in _FLAGS:
        raise KeyError(f"unknown flag '{name}'; known: {sorted(_FLAGS)}")
    return _FLAGS[name]


def set_flags(flags: dict) -> None:
    """Runtime override, by name or by `FLAGS_<name>`."""
    for k, v in flags.items():
        k = k[len("FLAGS_"):] if k.startswith("FLAGS_") else k
        if k not in _DEFS:
            raise KeyError(f"unknown flag '{k}'; known: {sorted(_DEFS)}")
        ftype = _DEFS[k][0]
        _FLAGS[k] = v if isinstance(v, ftype) else _parse(ftype, str(v))


_define("op_callstack", True,
        "capture the Python creation stack of every Operator for error "
        "attribution")
_define("check_nan_inf", False,
        "validate every op's floating outputs are finite as the executor "
        "runs it, raising an OpError that names the op (one host read an "
        "op: a debug mode; the numeric guard's blame replay turns it on)")
_define("bn_fuse_stats", True,
        "minimize()-time pass (passes.py): rewrite conv2d -> batch_norm"
        "(training) pairs into one conv2d_bn op, as the JAX package's flag "
        "of the same name does")
_define("fuse_epilogue", True,
        "minimize()-time pass (passes.py): fold norm -> [residual add ->] "
        "relu chains into the norm op (attr act, input Residual), the "
        "program structure the JAX package builds under "
        "FLAGS_pallas_epilogue=on. Structure only: fused or not, a CUDA "
        "tensor's batch-norm apply runs the hand-written kernels")
_define("tuning_mode", "off",
        "framework-wide autotuner (tuning/): 'off' keeps every lever on its "
        "pre-tuner logic; 'consult' resolves tunable decisions (the "
        "attention route, conv+BN fusion, the tiered embeddings' slots, AMP "
        "gray ops, bucket boundaries) through the tier policy exact-DB-hit "
        "-> learned cost model -> analytic prior -> conservative default; "
        "'sweep' resolves analytically but records every distinct decision "
        "key into the DB as a candidate to measure; 'explore' is consult "
        "plus bounded online measurement — tuning/learned/explore.py probes "
        "one recorded candidate every FLAGS_tuning_explore_every "
        "Executor.run_async steps and promotes out-of-interference-band "
        "verdicts to swept entries")
_define("tuning_db", "",
        "path of the persistent tuning decision database (schema-versioned "
        "JSON, atomic temp+rename writes; tuning/db.py), the JAX package's "
        "format. Empty = no DB: consult mode degrades to the analytic "
        "priors. A corrupt/missing file warns once and falls back to "
        "analytic — never an error")
_define("tuning_measurements", "",
        "path of the append-only JSONL measurement store "
        "(tuning/learned/store.py) the sweeps, A/B harnesses and explore "
        "probes append raw per-arm window timings to — the learned cost "
        "model's training set. Empty = derived from FLAGS_tuning_db (<db "
        "stem>.measurements.jsonl next to it); with no DB either, nothing "
        "records")
_define("tuning_record", "auto",
        "measurement-store gate (tuning/learned/store.py "
        "recording_enabled), read by the explore probe before it appends "
        "its arms' windows: 'auto' (default) records whenever a store path "
        "resolves, from the runtime only under tuning_mode sweep/explore "
        "(from a tool with tool=True in any mode); 'on' always records; "
        "'off' never records. The probe's verdict and DB entry do not "
        "depend on it")
_define("tuning_model", "",
        "path of the trained cost-model artifact (tuning/learned/model.py). "
        "Empty = derived from FLAGS_tuning_db (<db stem>.model.json next to "
        "it). Missing file = no learned tier; a corrupt file warns once and "
        "the policy falls back to the analytic prior — never an error")
_define("tuning_explore_every", 64,
        "explore-mode pacing: probe at most one candidate key per this "
        "many Executor.run_async steps (tuning/learned/explore.py). Each "
        "probe is a few tiny timed windows after the window drain; verdicts "
        "inside the interference band never overwrite the analytic "
        "decision. <= 0 disables probing even in explore mode")
_define("attention_force_backend", "",
        "A/B-harness override for fused_attention's route (ops/"
        "attention_ops.py attention_backend): force every decision to this "
        "arm ('pallas_short' or 'pallas_short128': K2/K4; 'flash_bundled': "
        "K10/K11) regardless of the tuning DB and the analytic prior. The "
        "port has no plain route for a CUDA tensor, so a forced arm the "
        "port cannot run at the op's shape ('xla', or K2/K4 past S = 512) "
        "raises. Read at an op's first run in a prepared program. Empty "
        "(default) = normal tiered dispatch")
_define("serving_page_size", 16,
        "KV-cache page size in token slots (serving/kv_cache.py)")
_define("serving_pool_pages", 512,
        "total pages in the preallocated KV pool (per layer, K and V each)")
_define("serving_max_inflight", 8,
        "continuous-batching scheduler: max requests decoding concurrently")
_define("serving_sched_policy", "fcfs",
        "admission order for waiting requests: 'fcfs' or 'sjf'")
_define("serving_prefix_cache", True,
        "copy-on-write prefix caching (serving/kv_cache.PrefixCache): "
        "prompts are indexed at page granularity and later requests "
        "sharing a prefix map the cached pages with a refcount bump "
        "instead of re-prefilling; the first write to a shared page "
        "copy-on-writes it. Cached pages are evicted LRU-first under pool "
        "pressure, so the cache can only ever trade idle HBM for prefill "
        "compute")
_define("serving_draft_k", 0,
        "speculative decoding draft length (serving/engine): each decode "
        "step self-drafts k tokens per request (n-gram continuation of "
        "its own history) and verifies all k+1 positions in one batched "
        "window step — exact under greedy decoding, accepting 1..k+1 "
        "tokens per step. 0 disables (plain one-token decode)")
_define("serving_tp", 1,
        "tensor-parallel degree for the serving engine: the engine's "
        "programs run the Megatron rewrite (parallel/tensor_parallel.py) "
        "over a `tp` group of that many ranks (parallel/mesh."
        "make_tp_mesh), SPMD driven from rank 0 (the other ranks follow "
        "its broadcasts, ServingEngine.follow); each rank holds nh/tp "
        "attention heads and their KV pool pages and runs K1 on them; "
        "paged_decode_attention keys the tuning DB on the per-shard "
        "(nh/tp) shape. Must divide the model's num_heads; 1 disables")
# serving resilience knobs (deadlines, shedding, degradation, supervision)
_define("serving_deadline_s", 0.0,
        "default per-request TTL in seconds, measured from submit: a "
        "request past its deadline is expired at admission and between "
        "decode steps with every KV page returned, surfaced as the "
        "'deadline_exceeded' terminal state (partial tokens kept). "
        "Per-request `deadline_s=` on submit overrides; <=0 (default) "
        "means no deadline")
_define("serving_priority_default", 1,
        "priority class assigned to requests submitted without an explicit "
        "priority (higher = more important). Under overload the shedder "
        "evicts lowest-priority WAITING requests first; ties shed the "
        "youngest")
_define("serving_shed_occupancy", 0.0,
        "admission-control floor on KV pool occupancy: when pages_in_use / "
        "num_pages crosses this fraction, new submits shed lower-priority "
        "waiters or are rejected with a retry-after hint "
        "(AdmissionRejected) instead of queueing unboundedly. <=0 "
        "(default) disables the occupancy trigger")
_define("serving_shed_queue_depth", 0,
        "admission-control floor on waiting-queue depth: a submit that "
        "would leave more than this many requests WAITING sheds "
        "lower-priority waiters or is rejected (AdmissionRejected). <=0 "
        "(default) disables the depth trigger")
_define("serving_shed_ttft_p99_ms", 0.0,
        "SLO floor on p99 time-to-first-token in milliseconds, read from "
        "the serving.ttft_s histogram via the SloMonitor: while p99 TTFT "
        "sits above this, new submits shed or reject exactly as under the "
        "occupancy/depth triggers. Needs FLAGS_obs_enable for the "
        "histogram to populate; <=0 (default) disables the SLO trigger")
_define("serving_degrade_after", 4,
        "graceful-degradation ladder patience: consecutive overloaded "
        "scheduler steps before climbing one rung (disable speculative "
        "decode -> shrink decode lookahead -> evict prefix-cache LRU tail "
        "-> shed waiters), and consecutive calm steps before descending "
        "one. Each climb is counted (serving.ladder.*) and evented")
_define("serving_step_retries", 3,
        "engine supervisor: max attempts for one prefill/decode/window/COW "
        "dispatch under the serving RetryPolicy (transient transport "
        "faults retry with millisecond backoff; a step writes the KV slots "
        "its feed names, so a retry rewrites them with the same values). "
        "Exhaustion triggers the recovery pass: quarantine poisoned "
        "requests, audit + rebuild the pool, replay survivors from their "
        "prompts")
_define("serving_audit_every", 16,
        "run the PagedKVPool.check_consistency invariant audit (free list "
        "and mapped ordinals partition the pool; refcounts equal live "
        "holder counts) every N scheduler steps; a dirty audit triggers "
        "the recovery pass. 1 audits every step (chaos drills); <=0 "
        "disables the periodic audit")
# serving fleet knobs (serving/fleet/: a router over N engine replicas, one
# failure domain each)
_define("fleet_replicas", 1,
        "default replica count for FleetRouter(): N independent engine "
        "replicas (each its own KV pool and prefix cache) behind the "
        "health-checked router. Constructor argument overrides; 1 "
        "degenerates to a supervised single engine")
_define("fleet_heartbeat_s", 2.0,
        "per-replica heartbeat deadline in seconds: a replica whose last "
        "beat (stamped after every pump iteration, skipped by the "
        "fleet_heartbeat_slow/hang/kill fault sites) is older than this is "
        "declared DEAD and its in-flight requests fail over to survivors. "
        "Scaled by FLAGS_watchdog_scale; <=0 disables health checking "
        "(replicas only die by explicit retire)")
_define("fleet_failover_budget", 3,
        "max failover re-placements per request over its lifetime (the "
        "fleet RetryPolicy's max_attempts): each replica death costs the "
        "request one attempt; past the budget the request lands in the "
        "'failed' terminal state instead of hopping forever between dying "
        "replicas")
_define("fleet_affinity", True,
        "prefix-cache-affinity placement: requests hash their prompt head "
        "(FLAGS_fleet_affinity_tokens tokens) to a preferred replica so "
        "same-system-prompt traffic lands on the replica already holding "
        "those pages; an unhealthy/rejecting target degrades to "
        "least-loaded. False = pure least-loaded placement")
_define("fleet_affinity_tokens", 16,
        "prompt-head length (tokens) hashed for affinity placement; "
        "prompts shorter than this hash whole. Align to the page size so "
        "requests sharing cached pages share a routing key")
# disaggregated prefill/decode serving (serving/fleet/handoff.py)
_define("disagg_prefill_replicas", 0,
        "split the fleet into roles: the first N replicas become "
        "prefill-only engines and the rest decode engines, all over ONE "
        "shared PagedKVPool, with prefill->decode KV handoff via TTL'd "
        "leases (FleetRouter roles= overrides; must leave at least one "
        "decode replica). 0 = co-located serving, every replica does both "
        "stages")
_define("disagg_lease_ttl_s", 2.0,
        "KV handoff lease time-to-live in seconds: a PREPARED lease whose "
        "commit has not arrived within the TTL is reaped — its page pin "
        "returns to the shared pool and the router replays the prompt "
        "under the normal failover budget. Scaled by FLAGS_watchdog_scale; "
        "commits that lose the expiry race are rejected atomically, never "
        "half-adopted")
# learned serving control (serving/control/)
_define("serve_control_mode", "shadow",
        "the learned serving controller: 'off' disables observation "
        "entirely; 'shadow' (default) observes regimes, proposes knob "
        "configs and logs/counts them but never applies one; 'apply' "
        "stages confident proposals for adoption at the next safe "
        "boundary (engine idle gap / router epoch tick), re-running "
        "warmup_decode when the decode bucket geometry changes")
_define("serve_control_store", "",
        "measurement-store path for serving.control regime rows; empty "
        "falls back to the tuning store (FLAGS_tuning_measurements / "
        "derived from FLAGS_tuning_db): kernels and regimes share one "
        "append-only dataset unless split out")
_define("serve_control_model", "",
        "trained control-model artifact; empty falls back to "
        "FLAGS_tuning_model (the serving.control group ships inside the "
        "same cost-model artifact). Missing = hand flags; corrupt warns "
        "once and fails open to the hand flags")
_define("serve_control_conf", 0.6,
        "confidence threshold: a control proposal stands only when the "
        "trained group's holdout rank accuracy clears this floor (the "
        "stricter of this and the model-wide gate); below it every "
        "regime serves the hand-flag config")
_define("serve_control_epoch_s", 5.0,
        "controller epoch interval in seconds: regimes are observed, "
        "realized goodput recorded and proposals made at most once per "
        "epoch per engine. <=0 disables the tick entirely")
_define("profiler_dir", "",
        "default trace output directory for profiler.profiler() and "
        "start_profiler(); empty = <tempdir>/paddle_tpu_torch_profile")
_define("device_prefetch_depth", 2,
        "DeviceLoader: batches staged into device memory ahead of the "
        "consumer by the background transfer thread (train_from_dataset "
        "and PyReader use_double_buffer); <=0 disables device prefetch in "
        "train_from_dataset")
_define("feed_bucketing", False,
        "pad ragged tail batches up to the bucket size (DataFeeder bucket / "
        "Dataset batch_size) and attach a '<batch_mask>' row-mask feed so "
        "every batch of an epoch has one shape; loss/metric ops must "
        "honor the mask for exact numerics (see README)")
_define("feed_skip_corrupt", False,
        "reader robustness: a sample/batch whose ndarray conversion raises "
        "(corrupt record) is skipped and counted on the profiler "
        "'feed.skip_corrupt' counter instead of killing the epoch "
        "(DataFeeder.feed, train_from_dataset, DeviceLoader placement)")
_define("max_inflight_steps", 4,
        "Executor.run_async window: dispatched-but-undrained steps allowed "
        "before the host blocks on the oldest step's completion token (a "
        "CUDA event recorded after the step's last op). 1 = fully "
        "synchronous per step; <=0 = unbounded runahead")
# unified telemetry layer (observability/: registry, exporters, spans, SLO)
_define("obs_enable", True,
        "the observability layer's histogram/event/span machinery "
        "(observability/registry.py): ON records streaming-percentile "
        "histograms, the structured event ring, and torch.profiler "
        "record_function + JSONL spans alongside every counter; OFF "
        "reduces the layer to the bare counter/gauge/stage accumulators "
        "(profiler.stage_counters() keeps working either way)")
_define("obs_jsonl_dir", "",
        "directory for the JSONL telemetry stream: when set, every event "
        "and span record appends atomically to <dir>/obs.jsonl (rotated at "
        "FLAGS_obs_jsonl_rotate_mb to obs.jsonl.1). Empty (default) "
        "disables the stream")
_define("obs_jsonl_rotate_mb", 8.0,
        "size trigger in MB for rotating the FLAGS_obs_jsonl_dir stream "
        "(os.replace to <path>.1 — the live path always holds a complete "
        "stream)")
_define("obs_prometheus_path", "",
        "when set, observability.export_prometheus() writes the registry "
        "snapshot here in Prometheus text exposition format (atomic "
        "temp+rename). Empty (default) disables the file export")
_define("obs_http_port", 0,
        "serve the live registry snapshot at http://127.0.0.1:<port>"
        "/metrics (Prometheus text) from a stdlib daemon thread; "
        "0 (default) disables the endpoint")
_define("obs_max_events", 1024,
        "capacity of the in-memory structured-event ring the registry "
        "keeps for snapshot()['events'] (the JSONL stream is unbounded; "
        "this only caps what a snapshot carries)")
_define("obs_slo_p99_ms", 0.0,
        "SLO monitor (observability/slo.py): warn/alert when the "
        "serving.request_s p99 exceeds this many milliseconds over the "
        "rolling window; <=0 (default) disables the latency rule")
_define("obs_slo_min_hit_rate", 0.0,
        "SLO monitor: warn/alert when the prefix-cache hit rate "
        "(prefix_hit_tokens over all prefill tokens) falls below this "
        "floor; <=0 (default) disables the rule")
_define("obs_slo_max_leaked_pages", 0,
        "SLO monitor: warn/alert when the serving.leaked_pages gauge "
        "exceeds this count (default 0 — any leak breaches)")
# tiered giant-embedding knobs (embedding/, the minimize()-time rewrite in
# passes.rewrite_tiered_embeddings)
_define("emb_hbm_budget_mb", 0.0,
        "per-table HBM budget in MB for embedding tables: at minimize() "
        "time every lookup_table whose table exceeds this is rewritten onto "
        "the two-tier path — host-memory shards behind a device-resident "
        "hot-ID cache sized to the budget, with miss prefetch resolved off "
        "the step on the feed pipeline. <=0 (default) disables tiering "
        "entirely: every table keeps the single-gather path unchanged")
_define("emb_cache_slots", 0,
        "hot-ID cache rows per tiered table; 0 (default) derives the slot "
        "count from FLAGS_emb_hbm_budget_mb / row bytes. A positive value "
        "is a hard per-run force (A/B arms); otherwise a swept "
        "'embedding|table=..' tuning-DB verdict refines the derived count "
        "under FLAGS_tuning_mode consult/explore")
_define("emb_prefetch_rows", 0,
        "fixed width of the per-step miss-prefetch buffer; 0 = auto — pow2 "
        "of the first batch's miss count, growing if a later batch "
        "overflows. A positive value forces the width; batches missing "
        "more rows still grow it rather than fail")
_define("emb_admit_min_freq", 1,
        "frequency-based cache admission: an id seen fewer than this many "
        "times total enters the cache on probation (zero accumulated "
        "frequency, first in line for eviction) instead of with its batch "
        "count — keeps one-shot ids from displacing hot rows. 1 (default) "
        "admits every miss at full weight; eviction is min-frequency with "
        "LRU tie-break either way")
_define("emb_host_shards", 1,
        "contiguous row shards per host-tier table (one numpy allocation "
        "each) — the in-process analogue of the per-pserver row partition")
_define("emb_ckpt_base_every", 4,
        "streaming delta checkpoints: a full host-tier base snapshot is "
        "written every this-many saves (atomically, to the checkpoint "
        "root); the saves between write only the rows dirtied since the "
        "base (cumulative delta in the step directory; restore = base + "
        "that one delta)")
# hang watchdog (resilience/watchdog.py)
_define("allreduce_bucket_mb", 4.0,
        "gradient-bucket size in MB for the collective regime "
        "(parallel/collective.py): GradAllReduce coalesces the gradients "
        "into reverse-topological buckets of about this many megabytes and "
        "inserts each bucket's mean-allreduce right where its last gradient "
        "is final. <=0: one allreduce a gradient, inserted before the "
        "optimizer ops. Under FLAGS_tuning_mode=consult the size resolves "
        "through the tuning DB ('collective|mesh=..|payload=..' keys), this "
        "flag the analytic prior")
_define("zero1", False,
        "ZeRO-1 in the collective regime (parallel/sharding.py apply_zero1): "
        "each eligible gradient is reduce-scattered, the optimizer op "
        "updates this rank's rows of the parameter and its state, the "
        "parameter's rows are gathered back, and each rank keeps only its "
        "rows of the state. Parameters whose leading dim does not divide by "
        "the ranks stay on the bucketed allreduce")
_define("pipeline_schedule", "1f1b",
        "default microbatch schedule for PipelineOptimizer / "
        "build_pipeline_plan when none is passed explicitly: '1f1b' "
        "(PipeDream-flush steady state — at most ~n_stages microbatches in "
        "flight, boundary stash freed as each backward completes) or "
        "'gpipe' (naive fill-drain: all forwards then all backwards, stash "
        "grows with num_microbatches). Both are numerically identical; "
        "PipelinePlan.last_bubble records the per-stage bubble accounting "
        "either way")
_define("watchdog_stall_s", 600.0,
        "hang watchdog window for Executor.run_async/wait completion-token "
        "drains and DeviceLoader batch waits: if no progress within this "
        "many seconds a StallError carrying the in-flight state dump is "
        "raised instead of blocking forever; <=0 disables the watchdog")
_define("watchdog_scale", 1.0,
        "global multiplier on every watchdog/heartbeat deadline "
        "(FLAGS_watchdog_stall_s windows): set >1 on loaded/slow runners "
        "so chaos tests don't flake on scheduling noise without rewriting "
        "per-site deadlines; values <1 are clamped to 1 (the margin only "
        "ever widens)")
# resilience runtime knobs (resilience/: faults, retry, checkpoint, runner)
_define("fault_plan", "",
        "deterministic fault-injection plan for the named runtime sites "
        "(resilience/faults.py grammar, e.g. 'ckpt.write:2;ps.send:1' or "
        "'rand:p=0.1,seed=7,max=5'); empty = injection off. Read from "
        "FLAGS_fault_plan at import, so subprocess trainers inherit it")
_define("retry_max_attempts", 4,
        "RetryPolicy: attempts per call for transient RPC/IO failures")
_define("retry_base_delay_ms", 50,
        "RetryPolicy: first backoff delay in milliseconds")
_define("retry_max_delay_ms", 2000,
        "RetryPolicy: backoff ceiling in milliseconds")
_define("retry_deadline_s", 30.0,
        "RetryPolicy: wall-clock budget for all attempts of one call; "
        "0 = unbounded")
_define("ckpt_keep_last_k", 3,
        "CheckpointManager: versioned step directories kept after GC")
_define("ckpt_save_every", 10,
        "CheckpointedRunner: checkpoint cadence in steps")
_define("runner_max_retries", 5,
        "CheckpointedRunner: per-step recovery attempts (restore and "
        "retry, then the prepared-program record dropped, then a plain "
        "retry) before the error surfaces")
# numeric guardrail knobs (resilience/guardrails.py, ops health_sentinel)
_define("guard_numerics", False,
        "append the health sentinel to every minimize(): the loss's "
        "finiteness, the global grad norm and AMP's found_inf are computed "
        "on the device inside the step (read back with the async "
        "completion token, no host sync), and a non-finite or spiking "
        "step's gradients are zeroed branchlessly (the AMP found_inf skip "
        "generalized to fp32)")
_define("guard_bad_step_budget", 3,
        "StepGuard: consecutive bad (skipped) steps tolerated before the "
        "guard rewinds to the last good checkpoint; the skip itself is "
        "always in-graph and free")
_define("guard_spike_factor", 0.0,
        "health sentinel loss-spike gate: a finite loss greater than this "
        "factor times the in-graph loss EMA counts as a bad step and skips "
        "the update (e.g. 10.0); <=0 disables spike gating (non-finite "
        "gating is always on under FLAGS_guard_numerics). Baked into the "
        "program at minimize() time")
_define("guard_lr_backoff", 0.5,
        "StepGuard: multiply the learning rate by this factor after each "
        "rewind (recovery ladder: skip -> rewind -> LR backoff -> surface); "
        "1.0 disables the backoff")
_define("guard_max_rewinds", 3,
        "StepGuard: rewinds tolerated across a run before the guard stops "
        "recovering and surfaces GuardError")
