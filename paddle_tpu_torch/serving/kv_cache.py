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
"""
from __future__ import annotations

import heapq

import torch

from ..core.types import torch_dtype

__all__ = ["PagedKVPool", "PrefixCache", "pool_var_names",
           "create_device_pools", "declare_pool_vars"]


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

    def check_consistency(self, holders: "dict[int, int] | None" = None
                          ) -> list[str]:
        """Audit the pool's invariants; returns the violations found ([] =
        clean). The free list and the mapped pages partition the pool: every
        page is on the free list with refcount 0 or off it with refcount >
        0, exactly once. With `holders` (page id -> how many live page-table
        and cache entries map it), each page's refcount equals its holder
        count. A pure read."""
        problems: list[str] = []
        free_set = set(self._free)
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
                h = holders.get(p, 0)
                if self._refs[p] > 0 and self._refs[p] != h:
                    problems.append(f"page {p} refcount {self._refs[p]} != "
                                    f"{h} live holders")
                elif self._refs[p] == 0 and h:
                    problems.append(f"page {p} is free but {h} live holders "
                                    f"still map it")
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
