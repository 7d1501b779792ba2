"""LLM serving runtime of the port: paged KV cache + continuous batching +
ragged paged decode attention.

  * `kv_cache` — fixed-size pages over a preallocated device pool (device
                 side: persistable pool tensors the programs update in
                 place; host side: refcounted free list + page tables, and
                 the page-granular prefix cache);
  * `model`    — the served decoder as bucketed prefill / ragged decode /
                 window (suffix prefill and speculative verify) /
                 copy-on-write programs over one explicit weight namespace,
                 plus the dense oracle;
  * `engine`   — the continuous-batching scheduler, with prefix caching,
                 copy-on-write and speculative decoding (`ngram_draft`);
  * `sampling` — per-request temperature/top-k/top-p on the host;
  * `weights`  — carrying parameters in from numpy (e.g. the JAX engine's).
"""
from .engine import (ContinuousBatchingScheduler, GenRequest, ServingEngine,
                     ngram_draft)
from .kv_cache import (PagedKVPool, PrefixCache, create_device_pools,
                       pool_var_names)
from .model import (DecoderConfig, build_cow_program, build_decode_program,
                    build_full_forward_program, build_prefill_program,
                    build_window_program, decoder_tiny)
from .sampling import SamplingParams, sample_token
from .weights import load_params

__all__ = [
    "ServingEngine", "GenRequest", "ContinuousBatchingScheduler",
    "ngram_draft", "PagedKVPool", "PrefixCache", "pool_var_names",
    "create_device_pools", "DecoderConfig", "decoder_tiny",
    "build_prefill_program", "build_decode_program", "build_window_program",
    "build_cow_program", "build_full_forward_program",
    "SamplingParams", "sample_token", "load_params",
]
