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
