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
        "tensor-parallel degree for the serving engine: attention heads "
        "and the KV pool shard over a `tp` device mesh "
        "(parallel/mesh.make_tp_mesh + GSPMD annotations); "
        "paged_decode_attention keys the tuning DB on the per-shard "
        "(nh/tp) shape. Must divide the model's num_heads; 1 disables. "
        "The port serves tp = 1 only (ROADMAP Queue 1, parallel and "
        "distributed)")
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
        "is a hard per-run force (A/B arms). The JAX package also refines "
        "the derived count through its tuning DB; the port has no tuning "
        "DB yet (ROADMAP Queue 1, tuning)")
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
# resilience runtime knobs (resilience/: faults, retry, checkpoint)
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
