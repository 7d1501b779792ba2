"""Paged KV cache: fixed-size pages over a preallocated device pool.

  * The DEVICE side is one pool per layer, [num_pages, page_size, num_heads,
    head_dim] for K and V each, held in the serving scope as persistable
    tensors that the prefill and decode programs write in place.
  * The HOST side (this module) is bookkeeping: a free list of page ids, a
    refcount per page, and per-request page tables kept by the engine.
    Nothing here touches the device.

Requests that share a system prompt map the SAME physical pages (`share`:
a refcount bump, not a copy), and the `PrefixCache` keeps prompt pages
alive past their request so later arrivals reuse them. A page returns to
the free list only when its last holder releases it; a holder that wants to
write a shared page copies it first (copy-on-write, engine.py).

Disaggregated serving adds two more pieces of bookkeeping:

  * LEASES: a page can be pinned by a named lease (`lease_grant`), the
    in-transit holder class of the prefill->decode KV handoff. The pin
    keeps the pages alive while neither engine's request table maps them,
    `lease_transfer` hands the refcount to the adopting side with no
    release/share window, and `check_consistency` counts leases as
    holders, so a mid-handoff audit neither false-flags nor misses them;
  * `OwnedPoolView`: a per-engine facade over ONE shared pool with the
    allocator's API and the owner's own holder ledger. The ledger belongs
    to the pool layer, so when a replica dies the router reclaims its pins
    through `forfeit()` without touching the dead engine.
"""
from __future__ import annotations

import heapq

import torch

from ..core.types import torch_dtype

__all__ = ["PagedKVPool", "PrefixCache", "OwnedPoolView",
           "pool_var_names", "create_device_pools", "declare_pool_vars"]


def pool_var_names(num_layers: int) -> list[tuple[str, str]]:
    """The (K, V) pool var names per layer."""
    return [(f"kv_cache.k{i}", f"kv_cache.v{i}") for i in range(num_layers)]


def declare_pool_vars(block, num_layers: int, num_pages: int, page_size: int,
                      num_heads: int, head_dim: int, dtype: str = "float32"):
    """Declare the pool vars in a program block (persistable, so the
    executor writes the updated pools back to the scope)."""
    for kn, vn in pool_var_names(num_layers):
        for name in (kn, vn):
            block.create_var(name=name,
                             shape=[num_pages, page_size, num_heads, head_dim],
                             dtype=dtype, persistable=True, stop_gradient=True)


def create_device_pools(scope, num_layers: int, num_pages: int,
                        page_size: int, num_heads: int, head_dim: int,
                        dtype: str = "float32", device=None) -> None:
    """Preallocate the zeroed pools into `scope` on `device` (once, at
    engine construction — the only allocation the cache ever does)."""
    for kn, vn in pool_var_names(num_layers):
        for name in (kn, vn):
            scope.set_var(name, torch.zeros(
                (num_pages, page_size, num_heads, head_dim),
                dtype=torch_dtype(dtype), device=device))


class PagedKVPool:
    """Refcounted free-list allocator over `num_pages` page ids. Not
    thread-safe: one scheduler loop owns it."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(
                f"pool needs positive pages/page_size, got {num_pages}/"
                f"{page_size} (FLAGS_serving_pool_pages / "
                f"FLAGS_serving_page_size)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently freed pages are reused first
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        self._refs: list[int] = [0] * self.num_pages
        # the in-transit holder class: lease id -> pinned page table
        self._leases: dict[str, list[int]] = {}

    def pages_for(self, n_tokens: int) -> int:
        """Pages a context of `n_tokens` slots needs (ceil, at least 1)."""
        return max(1, -(-int(n_tokens) // self.page_size))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def occupancy(self) -> float:
        return self.pages_in_use / self.num_pages

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def allocate(self, n: int) -> list[int] | None:
        """Pop `n` page ids at refcount 1, or None (backpressure — never a
        partial grab)."""
        if n > len(self._free):
            return None
        got = self._free[len(self._free) - n:]
        del self._free[len(self._free) - n:]
        for p in got:
            self._refs[p] = 1
        return got

    def share(self, pages: list[int]) -> None:
        """Add one holder to each page (prefix reuse: a refcount bump, not a
        copy). Only live pages can be shared; sharing a free page would
        resurrect garbage."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"sharing page {p} outside pool "
                                 f"[0, {self.num_pages})")
            if self._refs[p] <= 0:
                raise ValueError(f"sharing free page {p} (refcount 0)")
        for p in pages:
            self._refs[p] += 1

    def release(self, pages: list[int]) -> int:
        """Drop one holder from each page; pages whose refcount reaches zero
        return to the free list. A double free raises before any change.
        Returns how many pages were freed."""
        counts: dict[int, int] = {}
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"freeing page {p} outside pool "
                                 f"[0, {self.num_pages})")
            counts[p] = counts.get(p, 0) + 1
        for p, c in counts.items():
            if c > self._refs[p]:
                raise ValueError(f"double-free of page {p} (releasing {c} "
                                 f"holders, refcount {self._refs[p]})")
        freed = 0
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    def free(self, pages: list[int]) -> None:
        """Single-holder spelling of `release`."""
        self.release(pages)

    # -- leases: the in-transit holder class -------------------------------
    def lease_grant(self, lease_id: str, pages: list[int]) -> None:
        """Pin `pages` under a named lease (one extra holder a page, via
        `share`: only live pages can be leased). The lease keeps the pages
        alive even if both the granting and the adopting engine die
        mid-transfer."""
        if lease_id in self._leases:
            raise ValueError(f"lease {lease_id!r} already granted")
        self.share(pages)
        self._leases[lease_id] = list(pages)

    def lease_transfer(self, lease_id: str) -> list[int]:
        """Commit a lease: drop the record WITHOUT releasing the refcount —
        the pin moves to the adopting holder (its page table and owner
        ledger), a pure metadata move with no window where the pages could
        be freed."""
        if lease_id not in self._leases:
            raise KeyError(f"lease {lease_id!r} not held")
        return self._leases.pop(lease_id)

    def lease_release(self, lease_id: str) -> int:
        """Reap a lease: drop the record AND its pin (the orphaned-prepare
        path: the commit never arrived). Returns pages freed."""
        if lease_id not in self._leases:
            raise KeyError(f"lease {lease_id!r} not held")
        return self.release(self._leases.pop(lease_id))

    def lease_pages(self, lease_id: str) -> list[int]:
        return list(self._leases[lease_id])

    @property
    def leased_page_count(self) -> int:
        return sum(len(p) for p in self._leases.values())

    # -- invariant audit ----------------------------------------------------
    def check_consistency(self, holders: "dict[int, int] | None" = None
                          ) -> list[str]:
        """Audit the pool's invariants; returns the violations found ([] =
        clean). The free list and the mapped pages partition the pool: every
        page is on the free list with refcount 0 or off it with refcount >
        0, exactly once. With `holders` (page id -> how many live page-table
        and cache entries map it), each page's refcount equals its holder
        count plus its lease pins: a page mid-handoff (leased, mapped by no
        table) audits clean, and a lease record the refcount never backed
        (forged or duplicate) audits dirty. A pure read."""
        problems: list[str] = []
        free_set = set(self._free)
        lease_holds: dict[int, int] = {}
        for lid, pages in self._leases.items():
            for p in pages:
                if not 0 <= p < self.num_pages:
                    problems.append(f"lease {lid!r} pins page {p} outside "
                                    f"the pool [0, {self.num_pages})")
                    continue
                lease_holds[p] = lease_holds.get(p, 0) + 1
        for p, c in sorted(lease_holds.items()):
            if self._refs[p] < c:
                problems.append(
                    f"page {p} carries {c} lease pins but refcount "
                    f"{self._refs[p]} (forged or duplicate lease)")
        if len(free_set) != len(self._free):
            dupes = sorted({p for p in self._free if self._free.count(p) > 1})
            problems.append(f"free list holds duplicate entries {dupes[:8]}")
        for p in sorted(free_set):
            if not 0 <= p < self.num_pages:
                problems.append(f"free list holds page {p} outside the pool "
                                f"[0, {self.num_pages})")
            elif self._refs[p] != 0:
                problems.append(f"page {p} is on the free list with "
                                f"refcount {self._refs[p]}")
        for p in range(self.num_pages):
            r = self._refs[p]
            if r < 0:
                problems.append(f"page {p} has negative refcount {r}")
            elif r == 0 and p not in free_set:
                problems.append(f"page {p} has refcount 0 but is missing "
                                f"from the free list")
        if holders is not None:
            for p in range(self.num_pages):
                leased = lease_holds.get(p, 0)
                h = holders.get(p, 0) + leased
                if self._refs[p] > 0 and self._refs[p] != h:
                    suffix = f" (of which {leased} leased)" if leased else ""
                    problems.append(f"page {p} refcount {self._refs[p]} != "
                                    f"{h} live holders{suffix}")
                elif self._refs[p] == 0 and h:
                    problems.append(f"page {p} is free but {h} live holders "
                                    f"still map it")
        return problems

    def reset(self) -> None:
        """Rebuild the pristine state, every page free at refcount 0: the
        recovery pass's pool rebuild. The caller drops every page table and
        prefix-cache entry first (their page ids are garbage after this);
        the device pools need no touch, replayed prefills overwrite them."""
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._refs = [0] * self.num_pages
        self._leases = {}


class OwnedPoolView:
    """Per-engine facade over ONE shared `PagedKVPool` (disaggregated
    serving).

    It has the allocator surface the engine and its PrefixCache use
    (allocate/share/release/free/refcount/can_allocate/pages_for) and keeps
    an OWNER LEDGER: how many holders this owner has on each page. The
    ledger gives a per-engine audit (`check_consistency`, scoped to the
    engine's own holdings), per-engine leak accounting
    (`owned_pages_in_use`, while occupancy and backpressure read the global
    pool), and dead-replica reclamation (`forfeit`: the router returns a
    dead replica's pins without touching the dead engine).

    `adopt_transferred` records pins whose refcount arrived by
    `PagedKVPool.lease_transfer` (the commit half of the KV handoff). Not
    thread-safe, like the pool: disaggregated fleets pump inline."""

    def __init__(self, pool: PagedKVPool, owner: str):
        self.pool = pool
        self.owner = str(owner)
        self._held: dict[int, int] = {}

    # -- sizing and pressure, global: backpressure must be honest -----------
    @property
    def num_pages(self) -> int:
        return self.pool.num_pages

    @property
    def page_size(self) -> int:
        return self.pool.page_size

    @property
    def free_count(self) -> int:
        return self.pool.free_count

    @property
    def pages_in_use(self) -> int:
        return self.pool.pages_in_use

    @property
    def owned_pages_in_use(self) -> int:
        """Distinct pages this owner holds (the per-engine leak base)."""
        return len(self._held)

    # the serving_pool_corrupt fault's payload vandalizes these directly
    @property
    def _refs(self):
        return self.pool._refs

    @property
    def _free(self):
        return self.pool._free

    def occupancy(self) -> float:
        return self.pool.occupancy()

    def pages_for(self, n_tokens: int) -> int:
        return self.pool.pages_for(n_tokens)

    def refcount(self, page: int) -> int:
        return self.pool.refcount(page)

    def can_allocate(self, n: int) -> bool:
        return self.pool.can_allocate(n)

    # -- ledgered mutations -------------------------------------------------
    def _note(self, pages, d: int) -> None:
        for p in pages:
            c = self._held.get(p, 0) + d
            if c > 0:
                self._held[p] = c
            else:
                self._held.pop(p, None)

    def allocate(self, n: int) -> list[int] | None:
        got = self.pool.allocate(n)
        if got is not None:
            self._note(got, +1)
        return got

    def share(self, pages: list[int]) -> None:
        self.pool.share(pages)
        self._note(pages, +1)

    def release(self, pages: list[int]) -> int:
        freed = self.pool.release(pages)
        self._note(pages, -1)
        return freed

    def free(self, pages: list[int]) -> None:
        self.release(pages)

    def adopt_transferred(self, pages: list[int]) -> None:
        """Record pins whose refcount `lease_transfer` moved here (the
        handoff's commit): ledger only — the pool's refcount already counts
        them."""
        for p in pages:
            if self.pool.refcount(p) <= 0:
                raise ValueError(f"adopting free page {p} (refcount 0)")
        self._note(pages, +1)

    def forfeit(self) -> int:
        """Return every pin this owner holds to the shared pool (the owner
        died: its requests, admission pins and prefix-cache references will
        never release themselves). Lease pins are the HandoffManager's, so
        in-transit pages survive. Returns pages freed."""
        freed = 0
        for p, c in list(self._held.items()):
            freed += self.pool.release([p] * c)
        self._held.clear()
        return freed

    def reset(self) -> None:
        """The engine recovery pass's pool rebuild, owner-scoped: drop this
        owner's pins only (resetting the shared pool would wreck every
        other engine's live state)."""
        self.forfeit()

    def check_consistency(self, holders: "dict[int, int] | None" = None
                          ) -> list[str]:
        """The shared pool's partition and lease invariants, plus the
        owner-scoped holder check: `holders` (built by THIS engine) equals
        the owner ledger exactly, and the ledger never exceeds the global
        refcount."""
        problems = list(self.pool.check_consistency(None))
        if holders is not None:
            for p, c in sorted(self._held.items()):
                h = holders.get(p, 0)
                if h != c:
                    problems.append(
                        f"[{self.owner}] page {p}: owner ledger holds {c} "
                        f"but {h} live holders map it")
                if self.pool.refcount(p) < c:
                    problems.append(
                        f"[{self.owner}] page {p}: owner ledger holds {c} "
                        f"exceeding pool refcount {self.pool.refcount(p)}")
            for p, h in sorted(holders.items()):
                if h and p not in self._held:
                    problems.append(
                        f"[{self.owner}] page {p} mapped by {h} live "
                        f"holders but absent from the owner ledger")
        return problems


class _PrefixNode:
    __slots__ = ("nid", "page", "key", "parent_id", "children", "last_use")

    def __init__(self, nid, page, key, parent_id):
        self.nid = nid
        self.page = page
        self.key = key              # (parent_id, token_block): exact match
        self.parent_id = parent_id
        self.children = 0
        self.last_use = 0


class PrefixCache:
    """Prefix index at PAGE granularity: a trie over full token blocks, node
    (parent id, tuple of page_size tokens) -> the physical page holding
    exactly that block's KV. The cache holds one refcount on every indexed
    page, so prompt pages survive their request and later requests with the
    same prompt map them with a `share` instead of re-prefilling
    (copy-on-write in engine.py keeps them immutable). Keys are exact token
    tuples chained through parent ids, so a hash collision can never map
    the wrong page.

    Eviction is LRU over leaves whose page nobody else holds (refcount 1:
    the cache's own): evicting a shared page would free nothing, and an
    interior node cannot go before its children. The LRU order lives in a
    lazy min-heap of (last_use, nid) stamps: every touch pushes a fresh
    stamp, pops discard stale ones."""

    def __init__(self, pool: PagedKVPool):
        self.pool = pool
        self.page_size = pool.page_size
        self._nodes: dict[tuple, _PrefixNode] = {}
        self._by_id: dict[int, _PrefixNode] = {}
        self._heap: list[tuple[int, int]] = []   # (last_use, nid), lazy
        self._next_id = 1
        self._clock = 0
        self.lookups = 0
        self.hit_pages = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    def _touch(self, node: _PrefixNode) -> None:
        self._clock += 1
        node.last_use = self._clock
        heapq.heappush(self._heap, (node.last_use, node.nid))

    @property
    def pages_held(self) -> int:
        return len(self._nodes)

    def _blocks(self, tokens):
        ps = self.page_size
        for i in range(len(tokens) // ps):
            yield i, tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def match(self, tokens) -> list[int]:
        """The longest chain of cached pages covering a prefix of `tokens`
        (full blocks only). Bumps the LRU stamps on the path."""
        self.lookups += 1
        pages: list[int] = []
        pid = 0
        for _, block in self._blocks(tokens):
            node = self._nodes.get((pid, block))
            if node is None:
                break
            self._touch(node)
            pages.append(node.page)
            pid = node.nid
        self.hit_pages += len(pages)
        return pages

    def insert(self, tokens, pages: list[int]) -> int:
        """Index `tokens`' full blocks onto `pages` (pages[i] holds block
        i's KV, already written). New nodes take a cache refcount through
        pool.share; a block already indexed keeps its page (first writer
        wins: both copies hold the same KV). Returns pages newly indexed."""
        pid = 0
        added = 0
        for i, block in self._blocks(tokens):
            key = (pid, block)
            node = self._nodes.get(key)
            if node is None:
                self.pool.share([pages[i]])
                node = _PrefixNode(self._next_id, pages[i], key, pid)
                self._next_id += 1
                self._nodes[key] = node
                self._by_id[node.nid] = node
                if pid:
                    self._by_id[pid].children += 1
                added += 1
                self.inserted_pages += 1
            self._touch(node)
            pid = node.nid
        return added

    def evict(self, need: int) -> int:
        """Release up to `need` pages to the free list, LRU-first over
        evictable leaves; returns pages freed (fewer than `need` when every
        remaining page is still mapped by a live request). Stale stamps are
        discarded; stamps of nodes not evictable now are set aside and put
        back afterwards, so a node that becomes evictable later is still
        reachable."""
        freed = 0
        skipped: list[tuple[int, int]] = []
        while freed < need and self._heap:
            stamp, nid = heapq.heappop(self._heap)
            node = self._by_id.get(nid)
            if node is None or node.last_use != stamp:
                continue                     # stale: dropped or re-touched
            if node.children or self.pool.refcount(node.page) != 1:
                skipped.append((stamp, nid))
                continue
            self._drop(node)
            freed += 1
        for entry in skipped:
            heapq.heappush(self._heap, entry)
        return freed

    def _drop(self, node: _PrefixNode) -> None:
        del self._nodes[node.key]
        del self._by_id[node.nid]
        if node.parent_id:
            parent = self._by_id[node.parent_id]
            parent.children -= 1
            if parent.children == 0:
                # the parent just became a leaf: restore its stamp so the
                # same evict pass can cascade up the chain
                heapq.heappush(self._heap, (parent.last_use, parent.nid))
        self.pool.release([node.page])
        self.evicted_pages += 1

    def clear(self) -> int:
        """Drop the whole index WITHOUT releasing any page (for a pool about
        to be rebuilt). Returns entries dropped; `flush` everywhere else."""
        n = len(self._nodes)
        self._nodes.clear()
        self._by_id.clear()
        self._heap.clear()
        return n

    def flush(self) -> int:
        """Evict every evictable entry: afterwards the only indexed pages
        left are ones a live request still maps. Returns pages freed."""
        total = 0
        while True:
            freed = self.evict(len(self._nodes) or 1)
            total += freed
            if freed == 0:
                return total
