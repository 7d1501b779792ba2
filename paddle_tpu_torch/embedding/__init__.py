"""Tiered giant embeddings (the JAX package's embedding/).

Tables above FLAGS_emb_hbm_budget_mb become two-tier at minimize() time
(passes.rewrite_tiered_embeddings): the full table lives in host-memory
shards (host_tier.HostShardedTable) behind a device-resident hot-ID cache —
a `[slots+1, dim]` persistable scope var the step gathers from,
scatter-adds slot gradients into, and installs prefetched rows into. Miss
resolution and eviction write-back run OFF the step on the feed pipeline
(engine.TieredEmbeddingEngine); checkpointing streams base + dirty-row
deltas through the CheckpointManager manifest (checkpoint.py).
"""
from .engine import TICKET_KEY, TieredEmbeddingEngine
from .checkpoint import EmbeddingStateProvider
from .host_tier import HostShardedTable

__all__ = ["TieredEmbeddingEngine", "EmbeddingStateProvider",
           "HostShardedTable", "TICKET_KEY"]
