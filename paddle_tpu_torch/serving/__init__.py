"""LLM serving runtime of the port: paged KV cache + continuous batching +
ragged paged decode attention.

  * `kv_cache` — fixed-size pages over a preallocated device pool (device
                 side: persistable pool tensors the programs update in
                 place; host side: refcounted free list + page tables, the
                 page-granular prefix cache, the handoff leases and the
                 per-engine `OwnedPoolView` over a shared pool);
  * `model`    — the served decoder as bucketed prefill / ragged decode /
                 window (suffix prefill and speculative verify) /
                 copy-on-write programs over one explicit weight namespace,
                 plus the dense oracle;
  * `engine`   — the continuous-batching scheduler, with prefix caching,
                 copy-on-write and speculative decoding (`ngram_draft`),
                 deadlines, admission control (`AdmissionRejected`), the
                 degradation ladder, supervised dispatch with recovery, and
                 the immutable `EngineConfig` snapshot;
  * `control`  — the learned controller over the engine's knobs (regime
                 featurizer, knob space, ridge-tier policy, actuator);
  * `fleet`    — N engine replicas behind one router: heartbeat health
                 checking, prefix-affinity placement, failover replay with
                 exactly-once token delivery, drain-and-retire, and
                 disaggregated prefill/decode over KV leases;
  * `sampling` — per-request temperature/top-k/top-p on the host;
  * `weights`  — carrying parameters in from numpy (e.g. the JAX engine's).
"""
from . import control, fleet
from .engine import (AdmissionRejected, ContinuousBatchingScheduler,
                     EngineConfig, GenRequest, ServingEngine, ngram_draft)
from .fleet import (EngineReplica, FleetRequest, FleetRouter,
                    HandoffManager, KVLease, NoHealthyReplica,
                    disagg_fleet_factory)
from .kv_cache import (OwnedPoolView, PagedKVPool, PrefixCache,
                       create_device_pools, pool_var_names)
from .model import (DecoderConfig, build_cow_program, build_decode_program,
                    build_full_forward_program, build_prefill_program,
                    build_window_program, decoder_tiny)
from .sampling import SamplingParams, sample_token
from .weights import load_params

__all__ = [
    "EngineReplica", "FleetRouter", "FleetRequest", "NoHealthyReplica",
    "HandoffManager", "KVLease", "disagg_fleet_factory",
    "ServingEngine", "GenRequest", "ContinuousBatchingScheduler",
    "AdmissionRejected", "EngineConfig", "OwnedPoolView",
    "PagedKVPool", "PrefixCache", "pool_var_names", "create_device_pools",
    "DecoderConfig", "decoder_tiny", "build_prefill_program",
    "build_decode_program", "build_window_program", "build_cow_program",
    "build_full_forward_program", "SamplingParams", "sample_token",
    "ngram_draft", "load_params", "control", "fleet",
]
