"""The autotuner of the port: a persistent per-(op, shape, dtype,
device_kind) decision cache, the JAX package's `tuning/` in torch.

Every per-shape lever resolves through one policy (policy.py):

    exact swept-DB hit  ->  learned cost model  ->  analytic prior
    ->  conservative default

Levers wired through it in the port: the attention route of
`fused_attention` (K2/K4, decision "pallas_short", or the flash pair
K10/K11, "flash_bundled"; the values keep the JAX package's names so DB
files, store rows and learned models are interchangeable), the paged
decode key (K1 only: recorded and validated), conv+BN fusion per pair
(passes.fuse_conv_bn_stats), the tiered embeddings' slot count, AMP
gray-list membership and feed-bucket boundaries. Decisions resolve at
minimize() (the passes, the AMP lists), at a feed (buckets), or at an op's
first run in a prepared program (attention) under FLAGS_tuning_mode
consult or explore; explore mode also measures one recorded candidate
every FLAGS_tuning_explore_every `Executor.run_async` steps on the device
(learned/explore.py) and promotes an out-of-band verdict to a swept entry.
A DB written by either package loads in the other; its keys carry the
device's name (`torch.cuda.get_device_name` on a card, "cpu").
"""
from .db import (DB_SCHEMA, TuningDB, amp_key, attention_key, bucket_key,
                 canonical_key, collective_key, conv_key, embedding_key,
                 epilogue_key, evidence, xent_key)
from .policy import (consult_enabled, decide, device_kind, get_db,
                     invalidate_db_cache, mode, on_minimize,
                     provenance_snapshot, reset_provenance, sweep_enabled)
from . import learned
from .learned import maybe_explore

__all__ = [
    "DB_SCHEMA", "TuningDB", "canonical_key", "conv_key", "attention_key",
    "bucket_key", "amp_key", "collective_key", "epilogue_key", "xent_key",
    "embedding_key", "evidence",
    "decide", "mode", "consult_enabled",
    "sweep_enabled", "get_db", "invalidate_db_cache", "device_kind",
    "provenance_snapshot", "reset_provenance", "on_minimize",
    "learned", "maybe_explore",
]
