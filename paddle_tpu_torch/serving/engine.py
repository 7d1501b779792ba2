"""Continuous-batching serving engine over the paged KV cache (the core of
the JAX package's serving/engine.py).

    step():  admit waiting requests while pages and inflight slots allow
             (prefix-cache hits map shared pages, then only the uncached
             suffix is prefilled, bucketed) -> make sure every running
             request owns, exclusively, every page its next write window
             touches (allocating, copying shared pages on write, preempting
             the youngest request on pool exhaustion) -> one ragged decode
             step over all running requests (a k-token draft-verify window
             when speculative decoding is on) -> retire finished rows.

  * PREFIX CACHING: prompts are indexed at page granularity
    (kv_cache.PrefixCache); a new request maps every cached full page of
    its prompt with a refcount bump and prefills only the suffix through
    the window program (model.build_window_program). Shared pages are
    immutable: the first write to one (e.g. a fully cached prompt's first
    decode step re-writing the last prompt slot) copies it first (one
    `kv_cache_copy_page` step, the writer's table repointed).
  * SPECULATIVE DECODING: with draft_k > 0 each decode step drafts k tokens
    a row (`ngram_draft`, the n-gram continuation of the row's own history)
    and verifies all k + 1 positions in one window step; the verify's
    greedy tokens are accepted up to the first draft mismatch, so the
    result is exactly the plain greedy sequence, 1..k+1 tokens a step.
    Rejected drafts' KV slots lie past the new context length and are
    overwritten before anything attends them.

Backpressure: a request whose context needs more private pages than the
free list holds (after evicting unshared prefix-cache pages, LRU first)
WAITS (head-of-line), so the pool is never oversubscribed. A running
request that crosses a page boundary with the pool dry preempts the
youngest running request back to the waiting queue (recompute on
re-admission past whatever the prefix cache still holds, exact under
greedy decoding). Abort releases a request's pages at once.

Not ported yet: tensor parallelism (tp > 1 raises NotImplementedError
naming its ROADMAP item). The observability, resilience, degradation
ladder, control, fleet and disaggregation layers are not part of this
engine yet either.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import flags, unique_name
from ..executor import Executor, Scope, resolve_device
from ..framework import Program, program_guard
from . import model as sv_model
from .kv_cache import PagedKVPool, PrefixCache, create_device_pools
from .sampling import SamplingParams, request_rng, sample_token

__all__ = ["GenRequest", "ContinuousBatchingScheduler", "ServingEngine",
           "ngram_draft"]

WAITING, RUNNING, FINISHED, ABORTED = "waiting", "running", "finished", "aborted"
_TERMINAL = frozenset({FINISHED, ABORTED})


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def ngram_draft(tokens, k: int, window: int = 128) -> list[int]:
    """Self-drafting proposer: continue `tokens` with the k tokens that
    followed the most recent earlier occurrence of its tail n-gram (longest
    of 3/2/1) within the last `window` tokens, else repeat the last token.
    No draft model: the request's own history is the draft distribution.
    Wrong drafts only cost their share of the verify window."""
    if k <= 0:
        return []
    toks = [int(t) for t in tokens]
    lo = max(0, len(toks) - window)
    for glen in (3, 2, 1):
        if len(toks) < glen + 1:
            continue
        tail = toks[-glen:]
        for i in range(len(toks) - glen - 1, lo - 1, -1):
            if toks[i:i + glen] == tail:
                cont = toks[i + glen:i + glen + k]
                if cont:
                    return (cont + [toks[-1]] * (k - len(cont)))[:k]
    return [toks[-1]] * k


class GenRequest:
    """One generate request's lifetime. `all_tokens` is prompt + generated;
    while RUNNING the cache holds len(all_tokens) - 1 slots (the newest
    token's KV is written by the decode step that consumes it)."""

    def __init__(self, rid: int, prompt, max_new_tokens: int, eos_id=None,
                 sampling: "SamplingParams | None" = None):
        if not len(prompt):
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.rid = rid
        self.prompt_len = len(prompt)
        self.all_tokens: list[int] = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.sampling = sampling or SamplingParams()
        self.state = WAITING
        self.pages: list[int] = []
        self.cached_len = 0      # slots mapped from the prefix cache
        self.admit_seq = -1      # admission order; preemption evicts the newest
        self.preemptions = 0
        self.arrival_t = time.perf_counter()
        self.t_first_token: float | None = None
        self.t_done: float | None = None

    @property
    def n_generated(self) -> int:
        return len(self.all_tokens) - self.prompt_len

    @property
    def out_tokens(self) -> list[int]:
        return self.all_tokens[self.prompt_len:]

    @property
    def cache_len(self) -> int:
        """Valid KV slots while RUNNING (last token not yet appended)."""
        return len(self.all_tokens) - 1

    def is_done(self) -> bool:
        return (self.n_generated >= self.max_new_tokens
                or (self.eos_id is not None and self.n_generated > 0
                    and self.all_tokens[-1] == self.eos_id))


class ContinuousBatchingScheduler:
    """Admission ordering policy over the waiting queue."""

    def __init__(self, policy: str):
        if policy not in ("fcfs", "sjf"):
            raise ValueError(f"unknown FLAGS_serving_sched_policy "
                             f"'{policy}' (fcfs | sjf)")
        self.policy = policy

    def order(self, waiting: list[GenRequest]) -> list[GenRequest]:
        if self.policy == "sjf":
            return sorted(waiting, key=lambda r: len(r.all_tokens))
        return list(waiting)


class ServingEngine:
    """Paged-KV continuous-batching runtime for one decoder model on one
    device (CUDA unless `device` names another; with none named and no CUDA
    present, construction raises). Single-threaded: one scheduler loop owns
    the pool and the scope."""

    def __init__(self, cfg: "sv_model.DecoderConfig | None" = None,
                 page_size: int | None = None,
                 pool_pages: int | None = None,
                 max_inflight: int | None = None,
                 policy: str | None = None,
                 seed: int = 0,
                 prefix_cache: bool | None = None,
                 draft_k: int | None = None,
                 tp: int | None = None,
                 device=None):
        if prefix_cache is None:
            prefix_cache = bool(flags.get_flag("serving_prefix_cache"))
        self.draft_k = int(draft_k if draft_k is not None
                           else flags.get_flag("serving_draft_k"))
        if self.draft_k < 0:
            raise ValueError(f"draft_k must be >= 0, got {self.draft_k}")
        self.tp = int(tp if tp is not None else flags.get_flag("serving_tp"))
        if self.tp > 1:
            raise NotImplementedError(
                "tp > 1 is not ported yet (ROADMAP Queue 1, parallel and "
                "distributed: tensor-parallel serving)")
        self.device = resolve_device(device)
        # the served model is fp32: matmuls (and convolutions) run in full
        # fp32, never TF32, so the card computes what the CPU tests check
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg or sv_model.decoder_tiny()
        self.page_size = int(page_size or flags.get_flag("serving_page_size"))
        self.pool_pages = int(pool_pages or flags.get_flag("serving_pool_pages"))
        self.max_inflight = int(max_inflight
                                or flags.get_flag("serving_max_inflight"))
        self.scheduler = ContinuousBatchingScheduler(
            policy or str(flags.get_flag("serving_sched_policy")))
        self.seed = int(seed)
        self.pool = PagedKVPool(self.pool_pages, self.page_size)
        self.prefix_cache = PrefixCache(self.pool) if prefix_cache else None
        self._exe = Executor(place=self.device)
        self._scope = Scope()

        self._prefill_prog = Program()
        self._decode_prog = Program()
        self._window_prog = Program()
        self._cow_prog = Program()
        startup = Program()
        decoy_startup = Program()  # the others re-declare the weights; unused
        self._prefill_prog.random_seed = startup.random_seed = self.seed
        with program_guard(self._prefill_prog, startup), unique_name.guard():
            self._prefill_io = sv_model.build_prefill_program(
                self.cfg, self.pool_pages, self.page_size)
        with program_guard(self._decode_prog, decoy_startup), \
                unique_name.guard():
            self._decode_io = sv_model.build_decode_program(
                self.cfg, self.pool_pages, self.page_size)
        with program_guard(self._window_prog, decoy_startup), \
                unique_name.guard():
            self._window_io = sv_model.build_window_program(
                self.cfg, self.pool_pages, self.page_size)
        with program_guard(self._cow_prog, decoy_startup), \
                unique_name.guard():
            self._cow_io = sv_model.build_cow_program(
                self.cfg, self.pool_pages, self.page_size)
        self._exe.run(startup, scope=self._scope, rng_counter=1)
        create_device_pools(self._scope, self.cfg.num_layers, self.pool_pages,
                            self.page_size, self.cfg.num_heads,
                            self.cfg.head_dim, self.cfg.dtype,
                            device=self.device)

        self.requests: dict[int, GenRequest] = {}
        self._waiting: list[GenRequest] = []
        self._running: list[GenRequest] = []
        self._next_rid = 0
        self._admit_seq = 0
        self.stats = {
            "prefills": 0, "decode_steps": 0, "decode_tokens": 0,
            "preemptions": 0, "aborts": 0,
            "prefill_signatures": set(), "decode_signatures": set(),
            "peak_pages_in_use": 0,
            # prefix caching
            "prefill_tokens_computed": 0, "prefix_hit_tokens": 0,
            "prefix_lookups": 0, "prefix_full_hits": 0, "cow_copies": 0,
            # speculative decoding
            "spec_steps": 0, "spec_proposed": 0, "spec_accepted": 0,
        }

    def parameter_names(self) -> list[str]:
        """Names of the model's parameters (the persistable weights that
        `serving.weights.load_params` writes)."""
        return [p.name for p in self._prefill_prog.all_parameters()]

    # -- client API ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, eos_id=None,
               sampling: "SamplingParams | dict | None" = None) -> int:
        """Queue one request; returns its id."""
        if len(prompt) + max_new_tokens > self.cfg.max_position:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_position {self.cfg.max_position}")
        if isinstance(sampling, dict):
            sampling = SamplingParams(**sampling)
        rid = self._next_rid
        self._next_rid += 1
        req = GenRequest(rid, prompt, max_new_tokens, eos_id, sampling)
        self.requests[rid] = req
        self._waiting.append(req)
        return rid

    def abort(self, rid: int) -> None:
        """Drop a request wherever it is; its page refcounts release at once
        (a waiting request's too: the prefix-cache pages a failed admission
        left pinned on it), and pages nobody else maps return to the free
        list."""
        req = self.requests.get(rid)
        if req is None or req.state in _TERMINAL:
            return
        if req in self._waiting:
            self._waiting.remove(req)
        if req in self._running:
            self._running.remove(req)
        self._release(req)
        req.state = ABORTED
        req.t_done = time.perf_counter()
        self.stats["aborts"] += 1

    def has_work(self) -> bool:
        return bool(self._waiting or self._running)

    def result(self, rid: int) -> list[int]:
        return list(self.requests[rid].out_tokens)

    def pop_result(self, rid: int) -> list[int]:
        """Return a terminal request's generated tokens and drop its record."""
        req = self.requests[rid]
        if req.state not in _TERMINAL:
            raise ValueError(f"request {rid} is {req.state}; only terminal "
                             f"(finished/aborted) results can be popped")
        del self.requests[rid]
        return list(req.out_tokens)

    def leaked_pages(self) -> int:
        """Pages in use that no live request and no prefix-cache entry
        accounts for — zero at every quiescent point."""
        mapped: set[int] = set()
        for r in self.requests.values():
            mapped.update(r.pages)
        if self.prefix_cache is not None:
            mapped.update(n.page for n in self.prefix_cache._nodes.values())
        return self.pool.pages_in_use - len(mapped)

    def flush_prefix_cache(self) -> int:
        """Evict every prefix-cache entry no live request still maps (frees
        their pages). Returns pages freed."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.flush()

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"serving loop made no exit after {max_steps} steps "
                    f"(waiting={len(self._waiting)} "
                    f"running={len(self._running)})")

    # -- the scheduler iteration --------------------------------------------
    def step(self) -> bool:
        """One continuous-batching iteration; True if any request made
        progress (was admitted or decoded a token)."""
        admitted = self._admit()
        decoded = self._decode_once() if self._running else False
        if not decoded and not admitted and self._waiting:
            need = min(self.pool.pages_for(len(r.all_tokens) + 1)
                       for r in self._waiting)
            if need > self.pool.num_pages:
                raise RuntimeError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.pool.num_pages} (FLAGS_serving_pool_pages / "
                    f"FLAGS_serving_page_size)")
            if not self._running:
                raise RuntimeError(
                    "admission stuck: no running requests to free pages, "
                    f"yet {len(self._waiting)} waiting (free "
                    f"{self.pool.free_count}/{self.pool.num_pages} pages)")
        self.stats["peak_pages_in_use"] = max(self.stats["peak_pages_in_use"],
                                              self.pool.pages_in_use)
        return bool(admitted or decoded)

    # -- internals ----------------------------------------------------------
    def _release(self, req: GenRequest) -> None:
        if req.pages:
            self.pool.release(req.pages)
            req.pages = []
        req.cached_len = 0

    def _allocate(self, n: int) -> list[int] | None:
        """allocate() with prefix-cache relief: when the free list runs dry,
        unshared cache entries are evicted (LRU first) before giving up;
        cached prompts are a bet on later hits, never a reason to queue
        live work."""
        if n <= 0:
            return []
        got = self.pool.allocate(n)
        if got is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.pool.free_count)
            got = self.pool.allocate(n)
        return got

    def _admit(self) -> int:
        """Admit waiting requests in policy order until pages or inflight
        slots run out; the first request that does not fit stops admission
        (no starvation of big requests by later small ones under fcfs).
        Prefix-cache hits cut the private page bill: the cached full pages
        of the prompt map with a refcount bump instead of an allocation."""
        admitted = 0
        for req in self.scheduler.order(self._waiting):
            if len(self._running) >= self.max_inflight:
                break
            if req.pages:
                # an earlier attempt pinned this prefix hit, and the pin
                # stayed so that eviction relief could not free the match
                matched = req.pages
            else:
                matched = []
                if self.prefix_cache is not None:
                    self.stats["prefix_lookups"] += 1
                    matched = self.prefix_cache.match(
                        req.all_tokens[:req.prompt_len])
                    # pin the hit BEFORE allocating: the cache's own ref may
                    # be these pages' only holder, and _allocate's eviction
                    # relief could otherwise free them and hand them back as
                    # this request's private pages (one physical page at two
                    # ordinals)
                    if matched:
                        self.pool.share(matched)
            # +1: the decode step after prefill writes one more slot (the
            # JAX engine's ladder drops this reservation at rung 2; the port
            # has no ladder and keeps rung 0)
            need = self.pool.pages_for(len(req.all_tokens) + 1)
            private = self._allocate(max(0, need - len(matched)))
            if private is None:
                # keep the pin on the request: abort releases it, and the
                # next attempt starts with the shared pages already held
                req.pages = matched
                req.cached_len = len(matched) * self.page_size
                break
            req.pages = matched + private
            req.cached_len = len(matched) * self.page_size
            self.stats["prefix_hit_tokens"] += req.cached_len
            self._waiting.remove(req)
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self._prefill(req)
            admitted += 1
        return admitted

    def _seq_bucket(self, n: int) -> int:
        return min(self.cfg.max_position, max(8, _round_up_pow2(n)))

    def _first_token(self, req: GenRequest, outs) -> int:
        """The prompt's first generated token: the program's argmax for a
        greedy request, the host-side seeded sampler otherwise."""
        if req.sampling.is_greedy:
            return int(outs[0].reshape(-1)[0])
        rng = request_rng(self.seed, req.rid, req.n_generated)
        return sample_token(outs[1][0], req.sampling, rng)

    def _prefill(self, req: GenRequest) -> None:
        """Write one request's context KV and (unless the whole prompt was
        cached) take its first token. Three regimes by prefix-cache depth:
        cold (the whole-prompt prefill program), suffix (cached_len slots
        mapped shared; only the suffix runs, through the window program) and
        full hit (every prompt page mapped: no prefill at all; the next
        decode step re-derives the last prompt slot under copy-on-write and
        emits token one)."""
        n = len(req.all_tokens)
        req.state = RUNNING
        self._running.append(req)
        if req.cached_len >= n:
            self.stats["prefix_full_hits"] += 1
            self._register_prefix(req)
            return
        # the logits leave the device only for a sampling request
        if req.cached_len > 0:
            suf = n - req.cached_len
            sb = self._seq_bucket(suf)
            pb = _round_up_pow2(max(len(req.pages),
                                    self.pool.pages_for(req.cached_len + sb)))
            tok = np.zeros((1, sb), np.int32)
            tok[0, :suf] = req.all_tokens[req.cached_len:]
            pos = np.minimum(req.cached_len + np.arange(sb, dtype=np.int32),
                             self.cfg.max_position - 1)[None, :]
            pages = np.zeros((1, pb), np.int32)
            pages[0, :len(req.pages)] = req.pages
            feed = {sv_model.TOK_FEED: tok, sv_model.POS_FEED: pos,
                    sv_model.PAGES_FEED: pages,
                    sv_model.START_FEED: np.asarray([req.cached_len],
                                                    np.int32),
                    sv_model.LEN_FEED: np.asarray([suf], np.int32)}
            prog, io, computed = self._window_prog, self._window_io, suf
            self.stats["prefill_signatures"].add(("suffix", sb, pb))
        else:
            sb = self._seq_bucket(n)
            pb = max(len(req.pages), self.pool.pages_for(sb))
            tok = np.zeros((1, sb), np.int32)
            tok[0, :n] = req.all_tokens
            pos = np.minimum(np.arange(sb, dtype=np.int32)[None, :],
                             self.cfg.max_position - 1)
            pages = np.zeros((1, pb), np.int32)
            pages[0, :len(req.pages)] = req.pages
            feed = {sv_model.TOK_FEED: tok, sv_model.POS_FEED: pos,
                    sv_model.PAGES_FEED: pages,
                    sv_model.LEN_FEED: np.asarray([n], np.int32)}
            prog, io, computed = self._prefill_prog, self._prefill_io, n
            self.stats["prefill_signatures"].add((sb, pb))
        fetch = [io["next_token"]]
        if not req.sampling.is_greedy:
            fetch.append(io["last_logits"])
        outs = self._exe.run(prog, feed=feed, scope=self._scope,
                             fetch_list=fetch)
        self.stats["prefill_tokens_computed"] += computed
        self.stats["prefills"] += 1
        self._register_prefix(req)
        self._accept_token(req, self._first_token(req, outs))

    def _register_prefix(self, req: GenRequest) -> None:
        """Index the request's full prompt pages so later arrivals sharing
        the prompt map them instead of recomputing; the cache takes its own
        refcount a page, so the entries outlive the request."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.all_tokens[:req.prompt_len],
                                     req.pages)

    def _accept_token(self, req: GenRequest, tok: int) -> None:
        req.all_tokens.append(tok)
        now = time.perf_counter()
        if req.t_first_token is None:
            req.t_first_token = now
        if req.is_done() or len(req.all_tokens) >= self.cfg.max_position:
            if req in self._running:
                self._running.remove(req)
            self._release(req)
            req.state = FINISHED
            req.t_done = now

    def _make_room(self, req: GenRequest, what: str) -> bool:
        """Preempt the youngest running request because `req` needs a page
        the pool cannot give; False when that was `req` itself."""
        victim = max(self._running, key=lambda r: r.admit_seq)
        if victim is req and len(self._running) == 1:
            raise RuntimeError(
                f"request {req.rid} needs {what} but the pool "
                f"({self.pool.num_pages} pages) is exhausted with nothing "
                f"left to preempt")
        self._preempt(victim)
        return victim is not req

    def _cow(self, req: GenRequest, ordinal: int) -> bool:
        """Copy-on-write req's page `ordinal`: a fresh page, one in-place
        copy across every layer's K/V pools, the table repointed, the old
        refcount released (other holders untouched). False when the pool
        pressure this made preempted `req` itself."""
        new = self._allocate(1)
        while new is None:
            if not self._make_room(req, "a copy-on-write page"):
                return False
            new = self._allocate(1)
        old = req.pages[ordinal]
        self._exe.run(self._cow_prog, scope=self._scope, fetch_list=[], feed={
            sv_model.COW_SRC_FEED: np.asarray([old], np.int32),
            sv_model.COW_DST_FEED: np.asarray([new[0]], np.int32)})
        self.pool.release([old])
        req.pages[ordinal] = new[0]
        self.stats["cow_copies"] += 1
        return True

    def _ensure_writable(self, lookahead: int = 0) -> dict[int, int]:
        """Every running request must own every page its next write window
        [cache_len, cache_len + lookahead] touches, exclusively (refcount 1:
        shared pages are copied on write first). On pool exhaustion the
        lookahead shrinks before anyone is preempted (speculative slots are
        optional; cache_len's is not). Returns the lookahead granted, by
        rid."""
        ps = self.page_size
        granted: dict[int, int] = {}
        for req in list(self._running):
            if req.state != RUNNING:
                continue
            extra = lookahead
            while (req.cache_len + extra) // ps >= len(req.pages):
                got = self._allocate(1)
                if got is not None:
                    req.pages.extend(got)
                    continue
                if extra > 0:
                    extra -= 1
                    continue
                if not self._make_room(req, f"page {len(req.pages) + 1}"):
                    break
            if req.state != RUNNING:
                continue
            top = min(req.cache_len + extra, len(req.pages) * ps - 1)
            ok = True
            for o in range(req.cache_len // ps, top // ps + 1):
                if self.pool.refcount(req.pages[o]) > 1 \
                        and not self._cow(req, o):
                    ok = False
                    break
            if ok and req.state == RUNNING:
                granted[req.rid] = extra
        return granted

    def _preempt(self, req: GenRequest) -> None:
        self._running.remove(req)
        self._release(req)
        req.state = WAITING
        req.preemptions += 1
        self.stats["preemptions"] += 1
        # head of the waiting queue: a preempted request lost work
        self._waiting.insert(0, req)

    def _decode_once(self) -> bool:
        # the JAX engine's degradation ladder turns speculation off from
        # rung 1; the port has no ladder and keeps rung 0
        if self.draft_k > 0:
            return self._decode_spec()
        self._ensure_writable(0)
        rows = [r for r in self._running if r.state == RUNNING]
        if not rows:
            return False
        bb = min(_round_up_pow2(len(rows)), _round_up_pow2(self.max_inflight))
        pb = _round_up_pow2(max(len(r.pages) for r in rows))
        # [bb, 1] ids: lookup_table squeezes the trailing 1 to [bb] (a flat
        # [bb] feed would squeeze to a scalar id at bb == 1)
        tok = np.zeros((bb, 1), np.int32)
        pos = np.zeros((bb,), np.int32)
        pages = np.zeros((bb, pb), np.int32)
        mask = np.zeros((bb, 1), np.float32)
        for i, r in enumerate(rows):
            tok[i, 0] = r.all_tokens[-1]
            pos[i] = r.cache_len
            pages[i, :len(r.pages)] = r.pages
            mask[i, 0] = 1.0
        feed = {sv_model.TOK_FEED: tok, sv_model.POS_FEED: pos,
                sv_model.PAGES_FEED: pages, sv_model.MASK_FEED: mask}
        fetch = [self._decode_io["next_token"]]
        if not all(r.sampling.is_greedy for r in rows):
            fetch.append(self._decode_io["logits"])
        outs = self._exe.run(self._decode_prog, feed=feed, scope=self._scope,
                             fetch_list=fetch)
        nxt = outs[0].reshape(-1)
        self.stats["decode_steps"] += 1
        self.stats["decode_signatures"].add((bb, pb))
        for i, r in enumerate(rows):
            if r.sampling.is_greedy:
                t = int(nxt[i])
            else:
                rng = request_rng(self.seed, r.rid, r.n_generated)
                t = sample_token(outs[1][i], r.sampling, rng)
            self.stats["decode_tokens"] += 1
            self._accept_token(r, t)
        return True

    def _decode_spec(self) -> bool:
        """One draft-verify window step: propose k tokens a row
        (`ngram_draft` over the row's own history), run all k + 1 positions
        through the window program in one step, and accept the verify's
        greedy tokens up to the first draft mismatch: exactly the plain
        greedy sequence, 1..k+1 tokens a step."""
        k = self.draft_k
        S = k + 1
        granted = self._ensure_writable(k)
        rows = [r for r in self._running if r.state == RUNNING
                and r.rid in granted]
        if not rows:
            return False
        plans = []
        for r in rows:
            n_valid = min(S, self.cfg.max_position - len(r.all_tokens),
                          r.max_new_tokens - r.n_generated,
                          granted[r.rid] + 1)
            plans.append((r, max(1, n_valid), ngram_draft(r.all_tokens, k)))
        bb = min(_round_up_pow2(len(rows)), _round_up_pow2(self.max_inflight))
        pb = _round_up_pow2(max(len(r.pages) for r in rows))
        tok = np.zeros((bb, S), np.int32)
        pos = np.zeros((bb, S), np.int32)
        pages = np.zeros((bb, pb), np.int32)
        start = np.zeros((bb,), np.int32)
        lens = np.zeros((bb,), np.int32)
        for i, (r, n_valid, drafts) in enumerate(plans):
            tok[i, 0] = r.all_tokens[-1]
            tok[i, 1:] = drafts
            pos[i] = np.minimum(r.cache_len + np.arange(S),
                                self.cfg.max_position - 1)
            pages[i, :len(r.pages)] = r.pages
            start[i] = r.cache_len
            lens[i] = n_valid
        feed = {sv_model.TOK_FEED: tok, sv_model.POS_FEED: pos,
                sv_model.PAGES_FEED: pages, sv_model.START_FEED: start,
                sv_model.LEN_FEED: lens}
        fetch = [self._window_io["tokens"]]
        if not all(r.sampling.is_greedy for r in rows):
            fetch.append(self._window_io["logits"])
        outs = self._exe.run(self._window_prog, feed=feed, scope=self._scope,
                             fetch_list=fetch)
        toks = outs[0]
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        self.stats["decode_signatures"].add((bb, pb))
        for i, (r, n_valid, drafts) in enumerate(plans):
            if not r.sampling.is_greedy:
                # a sampling row takes exactly one (seeded) token a step;
                # draft acceptance is a greedy-only contract
                rng = request_rng(self.seed, r.rid, r.n_generated)
                self.stats["decode_tokens"] += 1
                self._accept_token(r, sample_token(outs[1][i, 0], r.sampling,
                                                   rng))
                continue
            m = 0
            while m < n_valid - 1 and int(drafts[m]) == int(toks[i, m]):
                m += 1
            self.stats["spec_proposed"] += n_valid - 1
            self.stats["spec_accepted"] += m
            for j in range(m + 1):
                if r.state != RUNNING:
                    break
                self.stats["decode_tokens"] += 1
                self._accept_token(r, int(toks[i, j]))
        return True
