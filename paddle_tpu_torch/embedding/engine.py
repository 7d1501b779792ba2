"""Tiered-embedding engine: the host-side half of the device hot-ID cache
(the JAX package's embedding/engine.py; the resolver, admission and
eviction are its host numpy, copied).

The step only ever sees a `[slots+1, dim]` cache scope var, a batch of
cache-slot indices, and a fixed-width prefetch buffer (ops
`emb_cache_install` / `tiered_lookup`, rewritten in at minimize() time by
passes.rewrite_tiered_embeddings). Everything that involves host memory
happens HERE, off the step:

  * resolve — the DeviceLoader's background thread (or Executor.run,
    synchronously, when a feed arrives unresolved) extracts the batch's
    unique-ID set, maps hits through the slot table, assigns slots to misses
    (free list, then frequency-based eviction with LRU tie-break), gathers
    the missed rows from the host tier, and attaches three derived feeds —
    per-ids slot indices, prefetch rows, prefetch slots — so the step
    gathers straight from device memory;
  * write-back — `emb_cache_install` emits the PRE-install contents of the
    slots it overwrites as a fresh `Evicted` tensor. Because steps execute
    in dispatch order on one stream, those values carry every optimizer
    update the evicted rows ever received, regardless of how many batches
    the resolver ran ahead. The engine holds the step's `Evicted` tensor
    and a CUDA event recorded after the step was dispatched (where the JAX
    package holds an immutable device array and asks `is_ready()`): the
    opportunistic flush lands a record whose event `query()`s complete, the
    forced one `synchronize()`s the event; either copies the rows into
    pinned host memory on a side stream of the engine, so neither waits on
    later steps. A row
    re-missed while its write-back is in flight blocks the resolver on
    exactly that one record: the only synchronization point in the design,
    and it only fires when a row bounces out and back within the in-flight
    window.

Resolution order IS dispatch order (single producer feeding a single
consumer), which is what makes the slot-map bookkeeping correct without any
device synchronization.
"""
from __future__ import annotations

import collections
import threading
import warnings

import numpy as np
import torch

from .. import flags, profiler
from .. import observability as obs
from .host_tier import HostShardedTable

__all__ = ["TieredEmbeddingEngine", "TICKET_KEY"]

# reserved feed key carrying the resolution ticket from the resolver thread
# to the dispatching executor; never staged to the device
TICKET_KEY = "<emb_ticket>"

# how long a forced write-back flush waits for its step to be dispatched +
# complete before giving up (stale host rows beat a deadlocked trainer)
_WB_TIMEOUT_S = 120.0


def _host(v) -> np.ndarray:
    """A feed value as a host array (a tensor fed by the caller is copied
    to the host: the resolver reads ids on the host)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class _Landing:
    """One step's evicted rows on their way to the host tier: the step's
    `Evicted` tensor, held until it lands, and on CUDA an event recorded
    after the step was dispatched."""

    __slots__ = ("rows", "event")

    def __init__(self, rows):
        self.rows = rows
        self.event = None
        if isinstance(rows, torch.Tensor) and rows.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(rows.device))

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def host(self, streams: dict) -> np.ndarray:
        """The rows on the host: waits for the step's event only, then
        copies into pinned memory on a side stream of the engine and waits
        for that stream alone (the current stream may hold later steps; a
        copy to pageable memory would wait for them)."""
        t = self.rows
        if not isinstance(t, torch.Tensor):
            return np.asarray(t)
        if self.event is None:
            return t.detach().numpy()
        self.event.synchronize()
        side = streams.get(t.device)
        if side is None:
            side = streams.setdefault(t.device, torch.cuda.Stream(t.device))
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            out.copy_(t.detach(), non_blocking=True)
        side.synchronize()
        return out.numpy()


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class _Record:
    """One batch's resolution: which slots were installed, and which evicted
    rows the step's `@EVICTED` output must be written back to."""

    __slots__ = ("ticket", "tables", "event", "flushed", "flush_lock")

    def __init__(self, ticket: int):
        self.ticket = ticket
        # table name -> {"evict_pairs": [(install_idx, old_row)],
        #                "evict_var": str, "handle": _Landing|None}
        self.tables: dict[str, dict] = {}
        self.event = threading.Event()  # set when the step is dispatched
        self.flushed = False
        # the resolver (conflict flush) and the dispatch thread
        # (opportunistic flush) can race to land the same record
        self.flush_lock = threading.Lock()


class _TableState:
    """Slot-map + frequency bookkeeping for one tiered table."""

    def __init__(self, name: str, host: HostShardedTable, slots: int,
                 cache_var: str, rows_var: str, slots_var: str,
                 evict_var: str, prefetch_rows: int = 0):
        self.name = name
        self.host = host
        self.slots = int(slots)
        self.scratch = int(slots)  # cache row [slots] is the masked scratch
        self.cache_var = cache_var
        self.rows_var = rows_var
        self.slots_var = slots_var
        self.evict_var = evict_var
        # ids feed name -> (slot feed name, padding_idx or None)
        self.ids_feeds: dict[str, tuple[str, int | None]] = {}
        self.prefetch_rows = int(prefetch_rows)  # 0 = auto from first batch
        self.lock = threading.RLock()
        self.slot2row = np.full(self.slots, -1, np.int64)
        self.row2slot: dict[int, int] = {}
        self.slot_freq = np.zeros(self.slots, np.float64)
        self.slot_used = np.zeros(self.slots, np.int64)
        self.free: list[int] = list(range(self.slots - 1, -1, -1))
        self.seen: dict[int, int] = {}  # admission counter (hot-ID history)
        self.pending_wb: dict[int, _Record] = {}  # evicted row -> its record
        self.tick = 0
        self.stats = collections.Counter()


class TieredEmbeddingEngine:
    """Per-program engine (stored as `program._tiered_engine`); one instance
    owns every tiered table of that program."""

    def __init__(self, program=None):
        self._program = program
        self.tables: dict[str, _TableState] = {}
        self._records: dict[int, _Record] = {}
        self._dispatched: collections.deque[_Record] = collections.deque()
        self._next_ticket = 0
        self._lock = threading.Lock()
        self._streams: dict = {}  # device -> the write-back copy stream

    # -- registration (passes.rewrite_tiered_embeddings) ---------------------
    def add_table(self, name: str, host: HostShardedTable, slots: int,
                  cache_var: str, rows_var: str, slots_var: str,
                  evict_var: str, prefetch_rows: int = 0) -> _TableState:
        ts = _TableState(name, host, slots, cache_var, rows_var, slots_var,
                         evict_var, prefetch_rows)
        self.tables[name] = ts
        return ts

    def add_lookup(self, table: str, ids_feed: str, slot_feed: str,
                   padding_idx: int | None) -> None:
        pad = None if padding_idx is None or padding_idx < 0 else int(
            padding_idx)
        self.tables[table].ids_feeds[ids_feed] = (slot_feed, pad)

    # -- the resolver (producer thread / inline) ------------------------------
    def resolve_feed(self, feed: dict) -> dict:
        """Return a NEW feed dict with the derived tiered feeds (+ ticket)
        attached. Pure host work — safe on the DeviceLoader thread."""
        from ..resilience.faults import InjectedFault, fault_point

        try:
            fault_point("emb_host_stall")
        except InjectedFault:
            # simulated host-tier wedge (hung remote shard / page-in storm):
            # the resolver parks forever so the consumer-side stall watchdog
            # must surface it with queue depths; the parked daemon thread
            # dies with the process
            threading.Event().wait()
        with self._lock:
            self._next_ticket += 1
            ticket = self._next_ticket
        rec = _Record(ticket)
        out = dict(feed)
        resolved = False
        for ts in self.tables.values():
            resolved |= self._resolve_table(ts, out, rec)
        if resolved:
            with self._lock:
                self._records[ticket] = rec
            out[TICKET_KEY] = ticket
        return out

    def _resolve_table(self, ts: _TableState, feed: dict,
                       rec: _Record) -> bool:
        ids_arrays = {n: _host(feed[n])
                      for n in ts.ids_feeds if n in feed}
        if not ids_arrays:
            return False
        # conflict pre-pass: a missed row whose write-back is still in
        # flight must not be refetched from the (stale) host tier — block
        # on exactly those records first, outside the table lock
        while True:
            with ts.lock:
                flat_all = np.concatenate(
                    [a.reshape(-1).astype(np.int64)
                     for a in ids_arrays.values()])
                conflicts = {ts.pending_wb[int(r)]
                             for r in np.unique(flat_all)
                             if int(r) in ts.pending_wb}
            if not conflicts:
                break
            for crec in conflicts:
                self._flush_record(crec, wait=True)

        with ts.lock:
            ts.tick += 1
            tick = ts.tick
            parts = []
            for name, arr in ids_arrays.items():
                pad = ts.ids_feeds[name][1]
                f = arr.reshape(-1).astype(np.int64)
                parts.append(f[f != pad] if pad is not None else f)
            union = np.concatenate(parts) if parts else \
                np.zeros(0, np.int64)
            uniq, counts = np.unique(union, return_counts=True)
            if uniq.size and (uniq[0] < 0 or uniq[-1] >= ts.host.vocab):
                bad = uniq[(uniq < 0) | (uniq >= ts.host.vocab)][:8]
                raise IndexError(
                    f"tiered table '{ts.name}': ids {bad.tolist()} outside "
                    f"[0, {ts.host.vocab})")
            uslots = np.empty(uniq.size, np.int64)
            miss_idx = []
            for i in range(uniq.size):
                uid = int(uniq[i])
                slot = ts.row2slot.get(uid)
                if slot is None:
                    miss_idx.append(i)
                else:
                    uslots[i] = slot
                    ts.slot_freq[slot] += counts[i]
                    ts.slot_used[slot] = tick
            n_miss = len(miss_idx)
            hit_occ = int(counts.sum()) - int(counts[miss_idx].sum())
            ts.stats["hit_ids"] += hit_occ
            ts.stats["miss_ids"] += int(counts[miss_idx].sum())
            ts.stats["batches"] += 1
            obs.counter_inc("emb.hit_ids", hit_occ,
                            labels={"table": ts.name})
            obs.counter_inc("emb.miss_ids", int(counts[miss_idx].sum()),
                            labels={"table": ts.name})

            # victims for misses beyond the free list: lowest frequency
            # first, LRU tie-break; slots referenced THIS batch are pinned
            need = n_miss - len(ts.free)
            victims: list[int] = []
            if need > 0:
                cand = np.nonzero((ts.slot2row >= 0)
                                  & (ts.slot_used < tick))[0]
                if cand.size < need:
                    raise RuntimeError(
                        f"tiered table '{ts.name}': cache of {ts.slots} "
                        f"slots cannot hold one batch's working set "
                        f"({n_miss} new + pinned ids) — raise "
                        f"FLAGS_emb_cache_slots / FLAGS_emb_hbm_budget_mb")
                order = np.lexsort((ts.slot_used[cand], ts.slot_freq[cand]))
                victims = [int(s) for s in cand[order[:need]]]

            admit_min = int(flags.get_flag("emb_admit_min_freq"))
            evict_pairs: list[tuple[int, int]] = []
            install_slots = np.empty(n_miss, np.int64)
            vq = collections.deque(victims)
            for j, i in enumerate(miss_idx):
                uid = int(uniq[i])
                if ts.free:
                    slot = ts.free.pop()
                else:
                    slot = vq.popleft()
                    old = int(ts.slot2row[slot])
                    ts.row2slot.pop(old, None)
                    evict_pairs.append((j, old))
                    ts.pending_wb[old] = rec
                    ts.stats["evictions"] += 1
                    obs.counter_inc("emb.evictions",
                                    labels={"table": ts.name})
                seen = ts.seen.get(uid, 0) + int(counts[i])
                ts.seen[uid] = seen
                ts.row2slot[uid] = slot
                ts.slot2row[slot] = uid
                # probation admission: an id still below the hot threshold
                # enters with zero accumulated frequency, so it is the first
                # eviction candidate until it proves itself
                ts.slot_freq[slot] = float(counts[i]) if seen >= admit_min \
                    else 0.0
                ts.slot_used[slot] = tick
                install_slots[j] = slot
                uslots[i] = slot
            if len(ts.seen) > 8 * ts.slots:
                # bound the admission history: keep the hotter half
                keep = sorted(ts.seen.items(), key=lambda kv: -kv[1])
                ts.seen = dict(keep[:4 * ts.slots])

            # fixed-width prefetch buffer (the JAX package's compile
            # signature must not change per batch; the port keeps the same
            # widths, so the feeds match it bit for bit): pad to the
            # configured (or auto, growing) capacity — padding installs zero
            # rows into the masked scratch
            cap = ts.prefetch_rows
            if cap <= 0 or n_miss > cap:
                cap = _pow2(max(1, n_miss))
                if ts.prefetch_rows and n_miss > ts.prefetch_rows:
                    ts.stats["prefetch_grows"] += 1
                ts.prefetch_rows = max(ts.prefetch_rows, cap)
                cap = ts.prefetch_rows
            miss_rows = ts.host.gather(uniq[miss_idx])
            rows_buf = np.zeros((cap, ts.host.dim), ts.host.dtype)
            rows_buf[:n_miss] = miss_rows
            slots_buf = np.full(cap, ts.scratch, np.int32)
            slots_buf[:n_miss] = install_slots

            # per-ids-feed slot indices (padding positions -> scratch)
            for name, arr in ids_arrays.items():
                slot_feed, pad = ts.ids_feeds[name]
                flat = arr.reshape(-1).astype(np.int64)
                if uniq.size:
                    idx = np.searchsorted(uniq, flat)
                    idxc = np.clip(idx, 0, uniq.size - 1)
                    valid = uniq[idxc] == flat
                    sl = np.where(valid, uslots[idxc], ts.scratch)
                else:
                    sl = np.full(flat.shape, ts.scratch, np.int64)
                feed[slot_feed] = sl.reshape(arr.shape).astype(np.int32)
            feed[ts.rows_var] = rows_buf
            feed[ts.slots_var] = slots_buf
            if evict_pairs:
                rec.tables[ts.name] = {"evict_pairs": evict_pairs,
                                       "evict_var": ts.evict_var,
                                       "handle": None}
        profiler.bump("emb.resolved_batches")
        return True

    # -- the executor side ----------------------------------------------------
    def prepare_feed(self, feed: dict):
        """Called by Executor.run before the feeds are placed: pop the
        ticket (it is no feed of the program) or resolve inline when the
        feed arrived raw. Returns (feed, ticket|None)."""
        if TICKET_KEY in feed:
            ticket = int(np.asarray(feed.pop(TICKET_KEY)))
            with self._lock:
                known = ticket in self._records
            if known:
                return feed, ticket
            # stale ticket (a resolved dict reused across runs): the slot
            # map has moved on — re-resolve against current state
        if not any(n in feed for ts in self.tables.values()
                   for n in ts.ids_feeds):
            return feed, None
        out = self.resolve_feed(feed)
        ticket = out.pop(TICKET_KEY, None)
        return out, ticket

    def note_dispatched(self, ticket: int, scope) -> None:
        """Called by the executor right after the step is dispatched: hold
        the step's `@EVICTED` tensors with an event recorded after the step
        (no sync) and opportunistically land any write-backs whose step has
        completed."""
        with self._lock:
            rec = self._records.pop(ticket, None)
        if rec is None:
            return
        for tname, t in rec.tables.items():
            t["handle"] = _Landing(scope.find_var(t["evict_var"]))
        rec.event.set()
        if rec.tables:
            with self._lock:
                self._dispatched.append(rec)
        self._flush_ready()

    def _flush_ready(self) -> None:
        while True:
            with self._lock:
                if not self._dispatched:
                    return
                rec = self._dispatched[0]
                ready = all(t["handle"].ready()
                            for t in rec.tables.values())
                deep = len(self._dispatched)
            if not ready and deep <= 64:
                return
            # head ready (or the backlog is deep enough to force the point)
            self._flush_record(rec, wait=True)

    def _flush_record(self, rec: _Record, wait: bool) -> None:
        if rec.flushed:
            return
        if not rec.event.wait(_WB_TIMEOUT_S if wait else 0):
            if wait:
                warnings.warn(
                    f"tiered embedding: write-back record {rec.ticket} was "
                    f"never dispatched within {_WB_TIMEOUT_S}s — dropping it "
                    f"(the evicted rows keep their last host-tier values)",
                    stacklevel=3)
                rec.flushed = True
            return
        with rec.flush_lock:
            if rec.flushed:
                return
            for tname, t in rec.tables.items():
                ts = self.tables[tname]
                arr = t["handle"].host(self._streams)  # its step completed
                idxs = [j for j, _ in t["evict_pairs"]]
                rows = [r for _, r in t["evict_pairs"]]
                with ts.lock:
                    ts.host.scatter(rows, arr[idxs])
                    ts.stats["writebacks"] += len(rows)
                    obs.counter_inc("emb.writebacks", len(rows),
                                    labels={"table": ts.name})
                    for r in rows:
                        if ts.pending_wb.get(r) is rec:
                            del ts.pending_wb[r]
            rec.flushed = True
        with self._lock:
            try:
                self._dispatched.remove(rec)
            except ValueError:
                pass

    # -- lifecycle ------------------------------------------------------------
    def flush_all(self) -> None:
        """Land every dispatched write-back (blocking). Records resolved but
        never dispatched (abandoned prefetch) are dropped."""
        while True:
            with self._lock:
                rec = self._dispatched[0] if self._dispatched else None
                if rec is None:
                    stale = list(self._records.values())
                    self._records.clear()
                    break
            self._flush_record(rec, wait=True)
        for rec in stale:
            for tname, t in rec.tables.items():
                ts = self.tables[tname]
                with ts.lock:
                    for _, r in t["evict_pairs"]:
                        if ts.pending_wb.get(r) is rec:
                            del ts.pending_wb[r]

    def flush_cache(self, scope) -> None:
        """Write every resident row's CURRENT device value back to the host
        tier (checkpoint/export time; the caller must have drained in-flight
        steps — Executor.wait())."""
        self.flush_all()
        for ts in self.tables.values():
            v = scope.find_var(ts.cache_var)
            if v is None:
                continue
            arr = _host(v)
            with ts.lock:
                occ = np.nonzero(ts.slot2row >= 0)[0]
                if occ.size:
                    ts.host.scatter(ts.slot2row[occ], arr[occ])

    def reset_cache(self) -> None:
        """Cold-start the device cache mapping (checkpoint restore: the host
        tier is authoritative, every slot refills on first touch)."""
        with self._lock:
            self._records.clear()
            self._dispatched.clear()
        for ts in self.tables.values():
            with ts.lock:
                ts.slot2row[:] = -1
                ts.row2slot.clear()
                ts.slot_freq[:] = 0.0
                ts.slot_used[:] = 0
                ts.free = list(range(ts.slots - 1, -1, -1))
                ts.pending_wb.clear()
                ts.tick = 0

    def export_dense(self, table: str, scope=None) -> np.ndarray:
        """Full [vocab, dim] table (host tier + current cache contents) —
        the small-scale parity oracle's view."""
        if scope is not None:
            self.flush_cache(scope)
        return self.tables[table].host.to_dense()

    def stats(self, table: str | None = None) -> dict:
        def one(ts: _TableState) -> dict:
            with ts.lock:
                s = dict(ts.stats)
                total = s.get("hit_ids", 0) + s.get("miss_ids", 0)
                s["hit_rate"] = round(s.get("hit_ids", 0) / total, 4) \
                    if total else None
                s["resident_rows"] = int((ts.slot2row >= 0).sum())
                s["slots"] = ts.slots
                s["prefetch_rows"] = ts.prefetch_rows
                s["host_bytes"] = ts.host.nbytes
            return s

        if table is not None:
            return one(self.tables[table])
        return {name: one(ts) for name, ts in self.tables.items()}
