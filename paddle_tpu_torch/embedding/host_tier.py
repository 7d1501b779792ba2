"""Host-memory tier of a tiered giant-embedding table (the JAX package's
embedding/host_tier.py, copied: numpy, and the same per-shard seeds, so
both packages' host tiers come out equal bit for bit).

A production sparse table (10^8..10^9 rows) does not fit one chip's HBM; the
full table lives here, in process host memory, split into contiguous row
shards (numpy, one allocation per shard — the in-process analogue of the
per-pserver row partition the transpiler computes, and the unit a future
multi-host tier would place one-per-host). The device only ever holds the
hot-ID cache (engine.py); this tier serves the cache's misses (`gather`) and
absorbs its evictions (`scatter`).

Checkpointing is delta-based (checkpoint.py): `scatter`/`load_rows` track the
dirty-row set since the last full base snapshot, so the periodic checkpoint
of a 10 GB table writes only the rows training actually touched.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["HostShardedTable"]

# numpy RNG mixing constant for per-table seeds (any odd 64-bit prime works;
# this one is splitmix64's)
_SEED_MIX = 0x9E3779B97F4A7C15


class HostShardedTable:
    """One table's host tier: [vocab, dim] rows in contiguous shards.

    init: ("uniform", low, high) | ("gaussian", mean, std) |
          ("constant", value) — the numpy rendering of the startup-program
    init op the tiered rewrite removed (passes.rewrite_tiered_embeddings).
    Deterministic in (seed): a rebuilt table re-draws identical rows.
    """

    def __init__(self, name: str, vocab: int, dim: int,
                 dtype=np.float32, num_shards: int = 1,
                 init: tuple = ("constant", 0.0), seed: int = 0):
        self.name = name
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.num_shards = max(1, min(int(num_shards), self.vocab or 1))
        self.init = tuple(init)
        self.seed = int(seed)
        self._lock = threading.Lock()
        # contiguous row ranges: shard s covers [bounds[s], bounds[s+1])
        base = self.vocab // self.num_shards
        rem = self.vocab % self.num_shards
        sizes = [base + (1 if s < rem else 0) for s in range(self.num_shards)]
        self.bounds = np.zeros(self.num_shards + 1, np.int64)
        np.cumsum(sizes, out=self.bounds[1:])
        self.shards = [self._init_shard(s, sizes[s])
                       for s in range(self.num_shards)]
        # dirty-row tracking for delta checkpoints: rows changed since the
        # last BASE snapshot (cumulative — a delta is restorable against its
        # base alone, so a crash between delta saves never loses rows)
        self._dirty: set[int] = set()

    # -- construction --------------------------------------------------------
    def _init_shard(self, s: int, rows: int) -> np.ndarray:
        kind = self.init[0]
        if kind == "constant":
            return np.full((rows, self.dim), self.init[1], self.dtype)
        rng = np.random.default_rng((self.seed ^ _SEED_MIX) + s)
        if kind == "uniform":
            lo, hi = self.init[1], self.init[2]
            return rng.uniform(lo, hi, (rows, self.dim)).astype(self.dtype)
        if kind == "gaussian":
            mean, std = self.init[1], self.init[2]
            return (rng.standard_normal((rows, self.dim)) * std
                    + mean).astype(self.dtype)
        raise ValueError(f"unknown host-tier init kind {kind!r}")

    # -- geometry ------------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return sum(sh.nbytes for sh in self.shards)

    def _locate(self, rows: np.ndarray):
        """(shard index, local row) per global row id."""
        sidx = np.searchsorted(self.bounds, rows, side="right") - 1
        return sidx, rows - self.bounds[sidx]

    # -- the cache's two verbs ----------------------------------------------
    def gather(self, rows) -> np.ndarray:
        """Fetch rows [n] -> [n, dim] (miss resolution / prefetch fill)."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if rows.size == 0:
            return np.zeros((0, self.dim), self.dtype)
        if (rows < 0).any() or (rows >= self.vocab).any():
            bad = rows[(rows < 0) | (rows >= self.vocab)][:8]
            raise IndexError(
                f"host tier '{self.name}': row ids {bad.tolist()} outside "
                f"[0, {self.vocab})")
        out = np.empty((rows.size, self.dim), self.dtype)
        sidx, local = self._locate(rows)
        with self._lock:
            for s in np.unique(sidx):
                m = sidx == s
                out[m] = self.shards[s][local[m]]
        return out

    def scatter(self, rows, values) -> None:
        """Write rows back (eviction write-back / cache flush); marks dirty."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if rows.size == 0:
            return
        values = np.asarray(values, self.dtype).reshape(rows.size, self.dim)
        sidx, local = self._locate(rows)
        with self._lock:
            for s in np.unique(sidx):
                m = sidx == s
                self.shards[s][local[m]] = values[m]
            self._dirty.update(int(r) for r in rows)

    # an explicit alias for bulk loads (parity harnesses, restore)
    load_rows = scatter

    def to_dense(self) -> np.ndarray:
        """Full [vocab, dim] materialization — small-scale oracles only."""
        with self._lock:
            return np.concatenate(self.shards, axis=0) if self.shards else \
                np.zeros((0, self.dim), self.dtype)

    # -- delta-checkpoint bookkeeping ---------------------------------------
    def dirty_rows(self) -> np.ndarray:
        with self._lock:
            return np.fromiter(self._dirty, np.int64, len(self._dirty))

    def clear_dirty(self) -> None:
        """Called when a BASE snapshot commits (the delta chain restarts)."""
        with self._lock:
            self._dirty.clear()

    def set_dirty(self, rows) -> None:
        """Restore-time reset: exactly the rows the applied delta carried
        differ from the base, so the NEXT delta must re-include them."""
        with self._lock:
            self._dirty = {int(r) for r in np.asarray(rows).reshape(-1)}
