"""Continuous-batching serving engine over the paged KV cache (the JAX
package's serving/engine.py).

    step():  (maybe) inject a chaos fault -> expire deadlines -> audit the
             pool every `audit_every` steps -> climb or descend the
             degradation ladder -> admit waiting requests while pages and
             inflight slots allow (prefix-cache hits map shared pages, then
             only the uncached suffix is prefilled, bucketed) -> make sure
             every running request owns, exclusively, every page its next
             write window touches (allocating, copying shared pages on
             write, preempting the youngest request on pool exhaustion) ->
             one ragged decode step over all running requests (a k-token
             draft-verify window when speculative decoding is on) -> retire
             finished rows.

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

Resilience:
  * DEADLINES: a per-request TTL checked at admission and between decode
    steps; an expired request keeps its partial tokens, returns every page
    and ends in the `deadline_exceeded` state;
  * ADMISSION CONTROL: when pool occupancy, queue depth or p99 TTFT (read
    through the SloMonitor) cross the FLAGS_serving_shed_* floors, submit()
    sheds lower-priority WAITING requests and then rejects with
    `AdmissionRejected` (a retry-after hint) instead of queueing without
    bound;
  * the DEGRADATION LADDER under sustained pressure: speculative decode off
    -> no decode-lookahead page at admission -> prefix-cache LRU eviction
    -> shedding, one rung per FLAGS_serving_degrade_after pressured steps,
    descending when calm;
  * SUPERVISION: every dispatch runs under the serving RetryPolicy (the
    `serving_step_fail` site injects there). The programs write the KV
    pools in place, op by op, so an attempt that fails inside a program
    has already written some layers' slots; the retry is exact because it
    rewrites exactly those slots with the same values from the same feed
    (each layer's K/V is a function of the feed, the weights and slots
    that attempt itself rewrites first). Retry exhaustion or a dirty
    `check_consistency` audit (`serving_pool_corrupt` injects the damage)
    runs the recovery pass: quarantine poisoned requests, rebuild the pool,
    replay survivors from their prompts, token for token a fault-free
    greedy run.

Runtime knobs resolve once into an immutable `EngineConfig`; a controller
(serving/control/) or an operator stages a replacement with
`propose_config`, adopted whole at an idle boundary. `warmup_decode` runs
every decode (batch bucket, page bucket) once; a decode signature that a
serving step runs after a warmup and that the warmup did not run is
recorded in `stats["cold_decode_signatures"]` (the port's counterpart of
the JAX package's zero-compiles-after-warmup contract).

Disaggregated serving: engines built over one shared `PagedKVPool` (each
through an `OwnedPoolView`) and one shared scope hand prefilled requests
over (`extract_for_handoff`, `adopt_request`, `release_handoff`);
`prefill_only` engines stop at the prompt boundary.

Tensor parallelism (tp > 1), SPMD over the `tp` ranks of the world: every
rank builds the engine with the same arguments; the programs run under
`with_data_parallel` over a tp mesh, so the tensor-parallel rewrite splits
the attention heads, the FFN and the KV pools ([pages, ps, nh / tp, dh] a
rank) over the ranks (model.apply_tp_annotations). Rank 0 schedules: the
page allocator, the prefix cache and copy-on-write run there, and before
each program run it broadcasts the run's feed (tokens, positions, page
tables with their global page ids, masks, copy-on-write ids) over the tp
group; ranks > 0 run the same programs on those feeds in `follow()` until
rank 0's `stop_followers()`. The logits are replicated, so every rank
computes the same tokens. A wait on the channel longer than
TP_FOLLOW_TIMEOUT_S raises.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import flags, unique_name
from .. import observability as obs
from ..executor import Executor, Scope, resolve_device
from ..framework import OpError, Program, program_guard
from ..observability.slo import hist_p99_above
from ..resilience.faults import InjectedFault, fault_point
from ..resilience.retry import serving_policy
from . import model as sv_model
from .kv_cache import (OwnedPoolView, PagedKVPool, PrefixCache,
                       create_device_pools, pool_var_names)
from .sampling import SamplingParams, request_rng, sample_token

__all__ = ["GenRequest", "ContinuousBatchingScheduler", "ServingEngine",
           "EngineConfig", "AdmissionRejected", "ngram_draft"]

WAITING, RUNNING, FINISHED, ABORTED = "waiting", "running", "finished", "aborted"
DEADLINE_EXCEEDED, SHED = "deadline_exceeded", "shed"
# disaggregated serving: the request left this engine through a KV handoff
# (not terminal); its pages stay pinned (the prefill pin) until the adopting
# side commits and the router sends release_handoff
HANDED_OFF = "handed_off"
# the states a request never leaves; pop_result/prune accept any of them
_TERMINAL = frozenset({FINISHED, ABORTED, DEADLINE_EXCEEDED, SHED})
# degradation-ladder rungs, mildest first (see _update_ladder)
_LADDER_RUNGS = {1: "spec_off", 2: "lookahead_shrink",
                 3: "cache_evict", 4: "shed"}


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class AdmissionRejected(RuntimeError):
    """submit() refused the request under overload: an explicit shed with a
    retry-after hint instead of unbounded queueing. `signals` carries the
    tripped triggers (occupancy / queue_depth / ttft_p99_s)."""

    def __init__(self, reason: str, retry_after_s: float, signals: dict):
        super().__init__(f"admission rejected ({reason}); retry after "
                         f"~{retry_after_s}s")
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.signals = dict(signals)


class _StepFailure(RuntimeError):
    """A dispatch failed past its retry budget; step() turns it into a
    recovery pass instead of letting it poison the batch."""

    def __init__(self, kind: str, cause: BaseException):
        super().__init__(f"{kind} dispatch failed after retries: {cause}")
        self.kind = kind
        self.cause = cause


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One immutable snapshot of every runtime knob the engine consults
    while scheduling. The constructor resolves the flags into one of these
    and every hot-path read goes through it, so a flag flipped mid-request,
    or a controller's actuation, never tears a request's config: a knob
    changes only when `propose_config` stages a replacement snapshot that
    `maybe_adopt_config` swaps in whole at a safe boundary (no work in
    flight). Construction-only knobs (page and pool geometry, scheduler
    policy, the prefix cache) stay plain attributes."""

    max_inflight: int
    draft_k: int
    deadline_s: float
    priority_default: int
    shed_occupancy: float
    shed_queue_depth: int
    shed_ttft_p99_ms: float
    degrade_after: int
    audit_every: int

    def bucket_geometry(self) -> tuple:
        """What the decode-signature lattice depends on: the batch-bucket
        ceiling and the window program's draft width. A pending config
        with another geometry re-runs warmup_decode on adoption."""
        return (_round_up_pow2(max(1, self.max_inflight)), self.draft_k)


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
                 sampling: "SamplingParams | None" = None,
                 deadline_s: float | None = None, priority: int = 1):
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
        self.priority = int(priority)  # higher = more important to keep
        # wall-clock TTL: an expired request keeps its partial tokens but
        # releases every page (the deadline_exceeded terminal state)
        self.deadline_t = (self.arrival_t + float(deadline_s)
                           if deadline_s and deadline_s > 0 else None)
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


# how long a tensor-parallel follower waits for rank 0's next run (or its
# stop) before it raises: the leader fell out of step
TP_FOLLOW_TIMEOUT_S = 600.0


class _TPChannel:
    """Rank 0's broadcast of each program run to the other ranks of a
    tensor-parallel engine: a gloo group of the tp ranks with its own
    timeout, so that a follower whose leader fell out of step raises
    instead of waiting for ever. Made with `new_group`, which every rank
    of the world calls alike (every rank builds its engine)."""

    def __init__(self, group):
        import datetime

        import torch.distributed as dist

        self.src = group.ranks[0]
        self.is_leader = group.index == 0
        self.pg = dist.new_group(
            group.ranks,
            timeout=datetime.timedelta(seconds=TP_FOLLOW_TIMEOUT_S),
            backend="gloo")

    def send(self, msg) -> None:
        import torch.distributed as dist

        dist.broadcast_object_list([msg], src=self.src, group=self.pg)

    def recv(self):
        import torch.distributed as dist

        buf = [None]
        dist.broadcast_object_list(buf, src=self.src, group=self.pg)
        return buf[0]


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
                 deadline_s: float | None = None,
                 priority_default: int | None = None,
                 shed_occupancy: float | None = None,
                 shed_queue_depth: int | None = None,
                 shed_ttft_p99_ms: float | None = None,
                 degrade_after: int | None = None,
                 step_retries: int | None = None,
                 audit_every: int | None = None,
                 shared_pool: "PagedKVPool | None" = None,
                 shared_scope: "Scope | None" = None,
                 pool_owner: str | None = None,
                 prefill_only: bool = False,
                 device=None):
        """Disaggregated serving: pass `shared_pool` (ONE `PagedKVPool`
        spanning the fleet, seen here through an `OwnedPoolView` tagged
        `pool_owner`) and `shared_scope` (the device pools and weights every
        role reads and writes) to build a role-split engine.
        `prefill_only=True` skips the decode stage of every step: requests
        prefill, then sit RUNNING until `extract_for_handoff` publishes
        them to a decode engine."""
        if prefix_cache is None:
            prefix_cache = bool(flags.get_flag("serving_prefix_cache"))
        self.tp = int(tp if tp is not None else flags.get_flag("serving_tp"))
        self.device = resolve_device(device)
        # the served model is fp32: matmuls (and convolutions) run in full
        # fp32, never TF32, so the card computes what the CPU tests check
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg or sv_model.decoder_tiny()
        self._mesh = self._ctl = None
        if self.tp > 1:
            from ..parallel.mesh import make_tp_mesh

            if self.cfg.num_heads % self.tp:
                raise ValueError(
                    f"serving tp degree {self.tp} must divide num_heads "
                    f"{self.cfg.num_heads} (head-sharded decode)")
            self._mesh = make_tp_mesh(self.tp)
            self._ctl = _TPChannel(self._mesh.group("tp"))
        self._targets: dict = {}
        # a list to record every program run's fetches in (rank 0 and the
        # followers alike: a check that the ranks compute the same tokens)
        self.tp_record = None
        self.page_size = int(page_size or flags.get_flag("serving_page_size"))
        self.pool_pages = int(pool_pages or flags.get_flag("serving_pool_pages"))
        self.scheduler = ContinuousBatchingScheduler(
            policy or str(flags.get_flag("serving_sched_policy")))
        self.seed = int(seed)

        def knob(value, name, cast):
            return cast(value if value is not None else flags.get_flag(name))

        # runtime knobs resolve ONCE into an immutable EngineConfig: the
        # scheduling loop reads self._ecfg, never the flags
        self._ecfg = EngineConfig(
            max_inflight=int(max_inflight
                             or flags.get_flag("serving_max_inflight")),
            draft_k=knob(draft_k, "serving_draft_k", int),
            deadline_s=knob(deadline_s, "serving_deadline_s", float),
            priority_default=knob(priority_default,
                                  "serving_priority_default", int),
            shed_occupancy=knob(shed_occupancy, "serving_shed_occupancy",
                                float),
            shed_queue_depth=knob(shed_queue_depth,
                                  "serving_shed_queue_depth", int),
            shed_ttft_p99_ms=knob(shed_ttft_p99_ms,
                                  "serving_shed_ttft_p99_ms", float),
            degrade_after=max(1, knob(degrade_after, "serving_degrade_after",
                                      int)),
            audit_every=knob(audit_every, "serving_audit_every", int))
        self._pending_ecfg: EngineConfig | None = None
        self._warm_ctx: int | None = None
        self._warm_sigs: set = set()
        if self.draft_k < 0:
            raise ValueError(f"draft_k must be >= 0, got {self.draft_k}")
        retries = knob(step_retries, "serving_step_retries", int)
        self._retry = serving_policy(max_attempts=max(1, retries),
                                     seed=self.seed)
        self._slo = None
        if self.shed_ttft_p99_ms > 0:
            # a private monitor over the default registry with muted
            # callbacks: the breach still lands on the slo.* series, the
            # engine reads it as one more overload signal
            self._slo = obs.SloMonitor(
                window_s=30.0, alert_after=1,
                on_warn=lambda b: None, on_alert=lambda b: None)
            self._slo.add_rule(
                "serving_ttft_p99",
                hist_p99_above("serving.ttft_s", self.shed_ttft_p99_ms / 1e3),
                self.shed_ttft_p99_ms / 1e3, "p99 TTFT above the shed floor")
        self._ladder_rung = 0
        self._pressure_steps = 0
        self._calm_steps = 0
        self._step_i = 0
        self.prefill_only = bool(prefill_only)
        self._shared_pool = shared_pool is not None
        if shared_pool is not None:
            if (shared_pool.num_pages != self.pool_pages
                    or shared_pool.page_size != self.page_size):
                raise ValueError(
                    f"shared pool is {shared_pool.num_pages}x"
                    f"{shared_pool.page_size} but this engine asked for "
                    f"{self.pool_pages}x{self.page_size}")
            self.pool = OwnedPoolView(shared_pool,
                                      pool_owner or f"engine@{id(self)}")
        else:
            self.pool = PagedKVPool(self.pool_pages, self.page_size)
        self.prefix_cache = PrefixCache(self.pool) if prefix_cache else None
        self._exe = Executor(place=self.device)
        self._scope = shared_scope if shared_scope is not None else Scope()

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
                self.cfg, self.pool_pages, self.page_size, tp=self.tp)
        with program_guard(self._window_prog, decoy_startup), \
                unique_name.guard():
            self._window_io = sv_model.build_window_program(
                self.cfg, self.pool_pages, self.page_size, tp=self.tp)
        with program_guard(self._cow_prog, decoy_startup), \
                unique_name.guard():
            self._cow_io = sv_model.build_cow_program(
                self.cfg, self.pool_pages, self.page_size)
        # rng_counter pinned to what a fresh scope's first run uses: on a
        # shared scope the run counter has moved on, and letting it into
        # the init's generator would give every later engine other weights
        self._exe.run(startup, scope=self._scope, rng_counter=1)
        # a shared scope may already hold live KV (an engine added to a
        # running disaggregated fleet): zeroing the pools again would wreck
        # every peer's context, so only the first engine creates them.
        # Identically seeded startup runs make the weight re-init above a
        # bitwise no-op on a shared scope.
        if not self._scope.has_var(pool_var_names(self.cfg.num_layers)[0][0]):
            # under tp each rank holds its nh / tp heads of every pool
            create_device_pools(self._scope, self.cfg.num_layers,
                                self.pool_pages, self.page_size,
                                self.cfg.num_heads // self.tp,
                                self.cfg.head_dim,
                                self.cfg.dtype, device=self.device)

        self.requests: dict[int, GenRequest] = {}
        self._waiting: list[GenRequest] = []
        self._running: list[GenRequest] = []
        self._next_rid = 0
        self._admit_seq = 0
        self.stats = {
            "prefills": 0, "decode_steps": 0, "decode_tokens": 0,
            "preemptions": 0, "aborts": 0,
            "prefill_signatures": set(), "decode_signatures": set(),
            "peak_pages_in_use": 0, "occupancy_sum": 0.0, "occupancy_n": 0,
            # decode signatures a serving step ran after a warmup that the
            # warmup did not run (the port's zero-new-signatures contract)
            "cold_decode_signatures": set(),
            # prefix caching
            "prefill_tokens_computed": 0, "prefix_hit_tokens": 0,
            "prefix_lookups": 0, "prefix_full_hits": 0, "cow_copies": 0,
            # speculative decoding
            "spec_steps": 0, "spec_proposed": 0, "spec_accepted": 0,
            # resilience: dotted keys mirror to the registry verbatim
            # through _count ("serving." + key)
            "deadline_exceeded": 0, "shed": 0, "rejects": 0,
            # disaggregated handoff
            "adopts": 0, "handoff_extracts": 0,
            "step_retries": 0, "recovery.passes": 0,
            "recovery.replayed": 0, "recovery.quarantined": 0,
            "ladder.spec_off": 0, "ladder.lookahead_shrink": 0,
            "ladder.cache_evict": 0, "ladder.shed": 0,
            # learned serving control
            "control.applies": 0, "control.rewarmups": 0,
        }
        # the learned controller's per-engine epoch hook: shadow by default,
        # one perf_counter read a step until an epoch is due
        from . import control as sv_control

        self._ctrl = sv_control.Controller()

    def parameter_names(self) -> list[str]:
        """Names of the model's parameters (the persistable weights that
        `serving.weights.load_params` writes)."""
        return [p.name for p in self._prefill_prog.all_parameters()]

    # -- runtime knobs: the EngineConfig snapshot ---------------------------
    @property
    def engine_config(self) -> EngineConfig:
        return self._ecfg

    @property
    def max_inflight(self) -> int:
        return self._ecfg.max_inflight

    @property
    def draft_k(self) -> int:
        return self._ecfg.draft_k

    @property
    def deadline_s(self) -> float:
        return self._ecfg.deadline_s

    @property
    def priority_default(self) -> int:
        return self._ecfg.priority_default

    @property
    def shed_occupancy(self) -> float:
        return self._ecfg.shed_occupancy

    @property
    def shed_queue_depth(self) -> int:
        return self._ecfg.shed_queue_depth

    @property
    def shed_ttft_p99_ms(self) -> float:
        return self._ecfg.shed_ttft_p99_ms

    @property
    def degrade_after(self) -> int:
        return self._ecfg.degrade_after

    @property
    def audit_every(self) -> int:
        return self._ecfg.audit_every

    def propose_config(self, knobs: dict, source: str = "controller") -> bool:
        """Stage a knob change (a controller's proposal or an operator's)
        as a PENDING EngineConfig; nothing changes until
        `maybe_adopt_config` at a safe boundary. Only the online-actuatable
        knobs are honoured (mi/dk/sq/so/da, control/knobs.py). True when a
        pending config was staged (the proposal differs from the current
        snapshot)."""
        cur = self._ecfg
        cand = dataclasses.replace(
            cur,
            max_inflight=max(1, int(knobs.get("mi", cur.max_inflight))),
            draft_k=max(0, int(knobs.get("dk", cur.draft_k))),
            shed_queue_depth=max(0, int(knobs.get("sq",
                                                  cur.shed_queue_depth))),
            shed_occupancy=min(1.0, max(0.0, float(
                knobs.get("so", cur.shed_occupancy * 100)) / 100.0)),
            degrade_after=max(1, int(knobs.get("da", cur.degrade_after))),
        )
        if cand == cur:
            self._pending_ecfg = None
            return False
        self._pending_ecfg = cand
        obs.event("serving.control.actuation",
                  {"phase": "staged", "source": source,
                   "geometry_change": cand.bucket_geometry()
                   != cur.bucket_geometry()})
        return True

    def maybe_adopt_config(self) -> bool:
        """Adopt the pending EngineConfig, but only at a safe boundary: no
        waiting and no running requests (submit(), step() and the fleet
        replica's pump all call this). When the decode bucket geometry
        changed, `warmup_decode` runs again over the context range warmed
        before, so no decode signature is new on the serving path."""
        pend = self._pending_ecfg
        if pend is None or self.has_work():
            return False
        old = self._ecfg
        self._ecfg = pend
        self._pending_ecfg = None
        self._count("control.applies")
        rewarmed = False
        if (pend.bucket_geometry() != old.bucket_geometry()
                and self._warm_ctx is not None):
            self.warmup_decode(self._warm_ctx)
            self._count("control.rewarmups")
            rewarmed = True
        obs.event("serving.control.actuation",
                  {"phase": "adopted", "rewarmed": rewarmed,
                   "max_inflight": pend.max_inflight,
                   "draft_k": pend.draft_k})
        return True

    def warmup_decode(self, max_context: int | None = None) -> int:
        """Run every decode (batch bucket, page bucket) signature for
        contexts up to `max_context` (default max_position) once, so that
        the first time a serving step meets a signature it pays no
        first-use cost (cuBLAS's choice for a new GEMM shape, the caching
        allocator's first blocks, a kernel library's load): which signature
        a step hits depends on how many requests happen to be running.
        Every row is masked (zero valid lengths): writes drop, outputs are
        ignored, no engine state moves. Returns the signature count."""
        max_context = min(int(max_context or self.cfg.max_position),
                          self.cfg.max_position)
        # remembered so an actuation that changes the bucket geometry can
        # warm the same context range again before serving
        self._warm_ctx = max_context
        pbs = sorted({_round_up_pow2(self.pool.pages_for(c))
                      for c in range(1, max_context + 2)})
        bbs = sorted({_round_up_pow2(b)
                      for b in range(1, self.max_inflight + 1)})
        self._warm_sigs = set()
        for bb in bbs:
            for pb in pbs:
                pages = np.zeros((bb, pb), np.int32)
                if self.draft_k > 0:
                    S = self.draft_k + 1
                    feed = {sv_model.TOK_FEED: np.zeros((bb, S), np.int32),
                            sv_model.POS_FEED: np.zeros((bb, S), np.int32),
                            sv_model.PAGES_FEED: pages,
                            sv_model.START_FEED: np.zeros((bb,), np.int32),
                            sv_model.LEN_FEED: np.zeros((bb,), np.int32)}
                    self._run(self._window_prog, feed,
                              [self._window_io["tokens"]])
                else:
                    feed = {sv_model.TOK_FEED: np.zeros((bb, 1), np.int32),
                            sv_model.POS_FEED: np.zeros((bb,), np.int32),
                            sv_model.PAGES_FEED: pages,
                            sv_model.MASK_FEED: np.zeros((bb, 1),
                                                         np.float32)}
                    self._run(self._decode_prog, feed,
                              [self._decode_io["next_token"]])
                self._warm_sigs.add((bb, pb))
        self.stats["cold_decode_signatures"].clear()
        return len(self._warm_sigs)

    def reset_stats(self) -> None:
        """Zero the counters (and the signature sets) without touching the
        pool or the prefix cache: the steady-state measurement boundary.
        The registry's `serving.` series reset with it."""
        for k, v in self.stats.items():
            if isinstance(v, set):
                v.clear()
            elif isinstance(v, float):
                self.stats[k] = 0.0
            else:
                self.stats[k] = 0
        obs.reset("serving.")

    def _count(self, key: str, n: int = 1) -> None:
        """Bump a stats counter AND its registry mirror (`serving.<key>`)."""
        self.stats[key] += n
        obs.counter_inc("serving." + key, n)

    def stats_snapshot(self) -> dict:
        """The stats dict plus derived rates, every divide guarded (0.0
        before any step). Signature sets become counts, so the result is
        JSON-clean."""
        st = self.stats
        out = {k: (len(v) if isinstance(v, set) else v)
               for k, v in st.items()}
        out["spec_accept_rate"] = (
            st["spec_accepted"] / st["spec_proposed"]
            if st["spec_proposed"] else 0.0)
        out["tokens_per_decode_step"] = (
            st["decode_tokens"] / st["decode_steps"]
            if st["decode_steps"] else 0.0)
        denom = st["prefix_hit_tokens"] + st["prefill_tokens_computed"]
        out["prefix_cache_hit_rate"] = (
            st["prefix_hit_tokens"] / denom if denom else 0.0)
        out["occupancy_mean"] = (
            st["occupancy_sum"] / st["occupancy_n"]
            if st["occupancy_n"] else 0.0)
        out["leaked_pages"] = self.leaked_pages()
        return out

    # -- client API ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, eos_id=None,
               sampling: "SamplingParams | dict | None" = None,
               deadline_s: float | None = None,
               priority: int | None = None) -> int:
        """Queue one request; returns its id. `deadline_s` and `priority`
        default to the engine's knobs. Under overload (any
        FLAGS_serving_shed_* floor tripped) this sheds WAITING requests of
        strictly lower priority to make room, and raises AdmissionRejected
        with a retry-after hint when that is not enough."""
        # the admit boundary is a safe boundary: a staged config swaps in
        # before this request's admission reads any knob
        self.maybe_adopt_config()
        if len(prompt) + max_new_tokens > self.cfg.max_position:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_position {self.cfg.max_position}")
        if isinstance(sampling, dict):
            sampling = SamplingParams(**sampling)
        if priority is None:
            priority = self.priority_default
        if deadline_s is None:
            deadline_s = self.deadline_s
        sig = self._overload_signals()
        if "occupancy" in sig and self.prefix_cache is not None:
            # evictable prefix-cache pages are reclaimable memory, not
            # pressure: free enough of the LRU tail to get under the floor
            # before refusing (an idle engine whose cache filled the pool
            # would otherwise shed every submit, with no step to evict)
            floor_pages = int(self.shed_occupancy * self.pool.num_pages)
            need = self.pool.pages_in_use - floor_pages + 1
            if need > 0:
                self.prefix_cache.evict(need)
            sig = self._overload_signals()
        while sig and self._shed_one(max_priority=int(priority)):
            sig = self._overload_signals()
        if sig:
            retry_after = round(
                0.05 * max(1, len(self._waiting) + len(self._running)), 3)
            self._count("rejects")
            obs.event("serving.request",
                      {"rid": -1, "phase": "rejected", "signals": sig,
                       "retry_after_s": retry_after}, level="warning")
            raise AdmissionRejected(",".join(sorted(sig)), retry_after, sig)
        rid = self._next_rid
        self._next_rid += 1
        req = GenRequest(rid, prompt, max_new_tokens, eos_id, sampling,
                         deadline_s=deadline_s, priority=int(priority))
        self.requests[rid] = req
        self._waiting.append(req)
        obs.event("serving.request", {"rid": rid, "phase": "queued",
                                      "prompt_len": req.prompt_len,
                                      "priority": req.priority,
                                      "max_new_tokens": req.max_new_tokens})
        return rid

    def abort(self, rid: int) -> None:
        """Drop a request wherever it is; its page refcounts release at once
        (a waiting request's too: the prefix-cache pages a failed admission
        left pinned on it), and pages nobody else maps return to the free
        list."""
        req = self.requests.get(rid)
        if req is None or req.state in _TERMINAL:
            return
        self._terminate(req, ABORTED, "aborts")

    def has_work(self) -> bool:
        return bool(self._waiting or self._running)

    @property
    def decode_slots_free(self) -> int:
        """RUNNING capacity left under max_inflight: what an adopting
        replica checks before committing a lease (an adopted request enters
        RUNNING directly)."""
        return max(0, self.max_inflight - len(self._running))

    # -- disaggregated KV handoff -------------------------------------------
    def extract_for_handoff(self, rid: int) -> dict:
        """PREPARE half of the prefill->decode handoff: take a freshly
        prefilled RUNNING request out of the scheduler and return its
        transfer state (token history and page table). The record stays,
        HANDED_OFF, with its pages still held (the PREFILL PIN, kept until
        the adopting side commits), so the audit and the leak accounting
        see it as a live holder throughout."""
        req = self.requests[rid]
        if req.state != RUNNING:
            raise ValueError(
                f"request {rid} is {req.state}; only RUNNING (prefilled) "
                f"requests can hand off")
        self._running.remove(req)
        req.state = HANDED_OFF
        self._count("handoff_extracts")
        obs.event("serving.request",
                  {"rid": rid, "phase": HANDED_OFF,
                   "n_generated": req.n_generated, "pages": len(req.pages)})
        return {"prompt_len": req.prompt_len,
                "all_tokens": list(req.all_tokens),
                "pages": list(req.pages),
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id, "sampling": req.sampling,
                "priority": req.priority, "deadline_t": req.deadline_t}

    def release_handoff(self, rid: int) -> None:
        """Drop the prefill pin of a HANDED_OFF request (the adopting side
        committed, or the handoff failed for good). Idempotent: a second
        release, or one after this engine recovered, does nothing."""
        req = self.requests.pop(rid, None)
        if req is None or req.state != HANDED_OFF:
            return
        if req.pages:
            self.pool.release(req.pages)
            req.pages = []

    def adopt_request(self, handoff: dict) -> int:
        """COMMIT half of the handoff: admit a request whose context KV
        another engine wrote into the shared pool. The page table moves,
        prefill is skipped; the pages' refcount arrived by lease transfer
        (the caller committed the lease first), so this only records the
        pins in the owner ledger and resumes decoding where the prefill
        side stopped (after its first token, or at a full prefix hit,
        whose first decode step derives token one under copy-on-write).
        Only the RUNNING cap re-runs here: the adopting replica checks
        `decode_slots_free` first and this guard backs it up (the caller
        returns the transferred refcount on rejection)."""
        adopt = getattr(self.pool, "adopt_transferred", None)
        if adopt is None:
            raise RuntimeError(
                "adopt_request needs a shared pool (OwnedPoolView): a "
                "private pool cannot receive a lease-transferred refcount")
        if len(self._running) >= self.max_inflight:
            raise AdmissionRejected(
                "adopt_no_decode_slot", 0.05,
                {"running": len(self._running),
                 "max_inflight": self.max_inflight})
        toks = [int(t) for t in handoff["all_tokens"]]
        pages = list(handoff["pages"])
        prompt_len = int(handoff["prompt_len"])
        if self.pool.pages_for(max(1, len(toks) - 1)) > len(pages):
            raise ValueError(
                f"adopted table has {len(pages)} pages for "
                f"{len(toks) - 1} KV slots")
        rid = self._next_rid
        self._next_rid += 1
        req = GenRequest(rid, toks[:prompt_len], handoff["max_new_tokens"],
                         handoff.get("eos_id"), handoff.get("sampling"),
                         priority=int(handoff.get("priority", 1)))
        req.all_tokens = toks
        req.pages = pages
        req.deadline_t = handoff.get("deadline_t")
        req.state = RUNNING
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        adopt(pages)
        self.requests[rid] = req
        self._running.append(req)
        self._count("adopts")
        obs.event("serving.request",
                  {"rid": rid, "phase": "adopted",
                   "n_generated": req.n_generated, "pages": len(pages)})
        return rid

    def result(self, rid: int) -> list[int]:
        return list(self.requests[rid].out_tokens)

    def pop_result(self, rid: int) -> list[int]:
        """Return a terminal request's generated tokens and drop its record
        (`requests` otherwise keeps every completed request)."""
        req = self.requests[rid]
        if req.state not in _TERMINAL:
            raise ValueError(
                f"request {rid} is {req.state}; only terminal "
                f"(finished/aborted/deadline_exceeded/shed) results can "
                f"be popped")
        del self.requests[rid]
        return list(req.out_tokens)

    def prune_finished(self) -> int:
        """Drop every terminal request record. Returns records dropped."""
        done = [rid for rid, r in self.requests.items()
                if r.state in _TERMINAL]
        for rid in done:
            del self.requests[rid]
        return len(done)

    def leaked_pages(self) -> int:
        """Pages in use that no live request and no prefix-cache entry
        accounts for — zero at every quiescent point. Over a shared pool
        the base is this owner's pages (the OwnedPoolView ledger)."""
        mapped: set[int] = set()
        for r in self.requests.values():
            mapped.update(r.pages)
        if self.prefix_cache is not None:
            mapped.update(n.page for n in self.prefix_cache._nodes.values())
        in_use = getattr(self.pool, "owned_pages_in_use",
                         self.pool.pages_in_use)
        return in_use - len(mapped)

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
        progress (was admitted or decoded a token). A dispatch that
        exhausts its retry budget becomes a recovery pass (quarantine, pool
        rebuild, prompt replay) instead of a poisoned batch."""
        self._step_i += 1
        self.maybe_adopt_config()
        try:
            progressed = self._step_inner()
        except _StepFailure as e:
            self._recover(f"step_fail:{e.kind}")
            progressed = True
        # the controller's epoch hook: one perf_counter read and a compare
        # a step until an epoch is due
        self._ctrl.tick(self)
        return progressed

    def _step_inner(self) -> bool:
        try:
            fault_point("serving_deadline")
        except InjectedFault:
            # chaos: the oldest live request's deadline collapses to the past
            victim = self._running[0] if self._running else (
                self._waiting[0] if self._waiting else None)
            if victim is not None:
                victim.deadline_t = time.perf_counter() - 1e-9
        try:
            fault_point("serving_pool_corrupt")
        except InjectedFault as e:
            self._corrupt_pool(e.hit)
        try:
            fault_point("serving_abort")
        except InjectedFault:
            # chaos: the oldest running request's client vanished mid-decode
            victim = self._running[0] if self._running else (
                self._waiting[0] if self._waiting else None)
            if victim is not None:
                self.abort(victim.rid)
        self._expire_deadlines(time.perf_counter())
        if self.audit_every > 0 and self._step_i % self.audit_every == 0:
            problems, poisoned = self.audit_pool()
            if problems:
                self._recover("pool_corrupt", poisoned=poisoned,
                              problems=problems)
                return True
        self._update_ladder()
        admitted = self._admit()
        if self._running and not self.prefill_only:
            with obs.span("serving.decode"):
                decoded = self._decode_once()
        else:
            # prefill-only engines stop at the prompt boundary: prefilled
            # rows sit RUNNING until extract_for_handoff moves them on
            decoded = False
        # a TTL crossed inside the prefill/decode above is caught here, and
        # its pages come back this step
        self._expire_deadlines(time.perf_counter())
        if not decoded and not admitted and self._waiting:
            need = min(self.pool.pages_for(len(r.all_tokens) + 1)
                       for r in self._waiting)
            if need > self.pool.num_pages:
                raise RuntimeError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.pool.num_pages} (FLAGS_serving_pool_pages / "
                    f"FLAGS_serving_page_size)")
            if not self._running and not self._shared_pool:
                # over a SHARED pool a starved engine is not stuck: peers
                # (or the lease reaper) free pages it never could
                raise RuntimeError(
                    "admission stuck: no running requests to free pages, "
                    f"yet {len(self._waiting)} waiting (free "
                    f"{self.pool.free_count}/{self.pool.num_pages} pages)")
        self._note_occupancy()
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

    def _note_occupancy(self) -> None:
        used = self.pool.pages_in_use
        self.stats["peak_pages_in_use"] = max(
            self.stats["peak_pages_in_use"], used)
        self.stats["occupancy_sum"] += used / self.pool.num_pages
        self.stats["occupancy_n"] += 1
        obs.gauge_set("serving.pages_in_use", used)
        obs.gauge_set("serving.pool_occupancy", used / self.pool.num_pages)

    # -- resilience: deadlines, shedding, the degradation ladder ------------
    def _terminate(self, req: GenRequest, state: str, counter: str,
                   extra: dict | None = None,
                   level: str = "warning") -> None:
        """The shared terminal transition: drop the request from its queue,
        release every page it maps (a WAITING request's pinned prefix-cache
        pages included), stamp the state, count and event it."""
        if req in self._waiting:
            self._waiting.remove(req)
        if req in self._running:
            self._running.remove(req)
        self._release(req)
        req.state = state
        req.t_done = time.perf_counter()
        self._count(counter)
        payload = {"rid": req.rid, "phase": state,
                   "n_generated": req.n_generated}
        if extra:
            payload.update(extra)
        obs.event("serving.request", payload, level=level)

    def _expire_deadlines(self, now: float) -> int:
        """Expire every live request past its TTL (checked between steps
        and at admission, never inside a program): partial tokens are
        kept, every page returns, and the state is distinct from abort.
        Returns requests expired."""
        expired = [r for r in self._running + self._waiting
                   if r.deadline_t is not None and now > r.deadline_t]
        for req in expired:
            self._terminate(req, DEADLINE_EXCEEDED, "deadline_exceeded",
                            extra={"overrun_s":
                                   round(now - req.deadline_t, 6)})
        return len(expired)

    def _overload_signals(self) -> dict:
        """The overload triggers tripped now ({} = healthy): pool occupancy
        and waiting-queue depth read directly, p99 TTFT through the
        SloMonitor. Disabled floors (<= 0) never trip."""
        sig: dict = {}
        if self.shed_occupancy > 0:
            occ = self.pool.pages_in_use / self.pool.num_pages
            if occ >= self.shed_occupancy:
                sig["occupancy"] = round(occ, 4)
        if (self.shed_queue_depth > 0
                and len(self._waiting) >= self.shed_queue_depth):
            sig["queue_depth"] = len(self._waiting)
        if self._slo is not None:
            for b in self._slo.observe():
                if b["rule"] == "serving_ttft_p99":
                    sig["ttft_p99_s"] = round(float(b["value"]), 6)
        return sig

    def _shed_one(self, max_priority: int | None = None) -> bool:
        """Shed ONE waiting request: the lowest priority class, youngest
        arrival within it. `max_priority` restricts victims to classes
        strictly below it (a submit never sheds its own class)."""
        cands = (self._waiting if max_priority is None
                 else [r for r in self._waiting
                       if r.priority < max_priority])
        if not cands:
            return False
        victim = min(cands, key=lambda r: (r.priority, -r.arrival_t))
        self._terminate(victim, SHED, "shed",
                        extra={"priority": victim.priority})
        return True

    def _update_ladder(self) -> None:
        """Graceful degradation under sustained pressure: one rung up per
        `degrade_after` consecutive overloaded steps, one rung down per
        equally long calm streak. Rungs: 1 speculative decode off, 2
        admission stops reserving the decode-lookahead page, 3 the
        prefix-cache LRU tail is evicted each pressured step, 4
        lowest-priority waiters are shed."""
        sig = self._overload_signals()
        if sig:
            self._pressure_steps += 1
            self._calm_steps = 0
            if (self._ladder_rung < 4
                    and self._pressure_steps >= self.degrade_after):
                self._pressure_steps = 0
                self._ladder_rung += 1
                name = _LADDER_RUNGS[self._ladder_rung]
                self._count("ladder." + name)
                obs.gauge_set("serving.ladder_rung", self._ladder_rung)
                obs.event("serving.degrade",
                          {"rung": self._ladder_rung, "name": name,
                           "direction": "up", "signals": sig},
                          level="warning")
        else:
            self._calm_steps += 1
            self._pressure_steps = 0
            if (self._ladder_rung > 0
                    and self._calm_steps >= self.degrade_after):
                self._calm_steps = 0
                self._ladder_rung -= 1
                obs.gauge_set("serving.ladder_rung", self._ladder_rung)
                obs.event("serving.degrade",
                          {"rung": self._ladder_rung, "direction": "down"})
        if sig and self._ladder_rung >= 3 and self.prefix_cache is not None:
            self.prefix_cache.evict(1)
        if sig and self._ladder_rung >= 4:
            self._shed_one()

    # -- supervision: retried dispatch, invariant audit, recovery -----------
    def _dispatch(self, kind: str, prog, feed, fetch_list):
        """Every prefill/decode/window/COW step dispatches here: the
        serving_step_fail site, then the executor, under the serving
        RetryPolicy. An op that fails on a transient error inside a
        program counts as the step's transient failure. The programs write
        the pools in place, so a failed attempt may have written some
        layers' slots; attempt N+1 runs the same feed and rewrites exactly
        those slots with the same values before anything reads them. Exhaustion raises _StepFailure, which
        step() turns into the recovery pass."""
        def attempt():
            fault_point("serving_step_fail")
            try:
                return self._run(prog, feed, fetch_list)
            except OpError as e:
                # the executor names the op that failed; a transient cause
                # (a lost transport) is still the step's transient failure
                if isinstance(e.__cause__, self._retry.retryable):
                    raise e.__cause__ from e
                raise

        def on_retry(n, exc):
            self._count("step_retries")
            obs.event("serving.step_retry",
                      {"kind": kind, "attempt": n, "error": repr(exc)},
                      level="warning")

        try:
            return self._retry.call(attempt, on_retry=on_retry)
        except self._retry.retryable as e:
            raise _StepFailure(kind, e) from e

    def _programs(self) -> dict:
        return {"prefill": self._prefill_prog, "decode": self._decode_prog,
                "window": self._window_prog, "cow": self._cow_prog}

    def _exec_target(self, prog):
        """The executor target for `prog`: the program at tp = 1, under tp
        a CompiledProgram over the tp mesh (built once a program, so the
        executor's clone of it is made once)."""
        if self._mesh is None:
            return prog
        if id(prog) not in self._targets:
            from ..compiler import CompiledProgram

            sv_model.apply_tp_annotations(prog, self.cfg, self.tp)
            self._targets[id(prog)] = CompiledProgram(prog) \
                .with_data_parallel(mesh=self._mesh)
        return self._targets[id(prog)]

    def _run(self, prog, feed, fetch_list):
        """Run one of the engine's programs; under tp, rank 0 broadcasts
        the run to the followers first."""
        if self._ctl is not None:
            key = next(k for k, p in self._programs().items() if p is prog)
            self._ctl.send(("run", key, feed,
                            [getattr(f, "name", f) for f in fetch_list]))
        outs = self._exe.run(self._exec_target(prog), feed=feed,
                             fetch_list=fetch_list, scope=self._scope)
        if self.tp_record is not None:
            self.tp_record.append([np.asarray(o) for o in outs])
        return outs

    def follow(self) -> int:
        """The loop of a tensor-parallel engine's ranks > 0: run each
        program rank 0 runs, on the feed it broadcasts, until rank 0's
        `stop_followers()`. Returns the runs. A wait longer than the
        channel's timeout raises (a leader that fell out of step)."""
        if self._ctl is None or self._ctl.is_leader:
            raise RuntimeError("follow() is for ranks > 0 of an engine "
                               "with tp > 1")
        runs = 0
        while True:
            msg = self._ctl.recv()
            if msg[0] == "stop":
                return runs
            _, key, feed, fetch = msg
            outs = self._exe.run(self._exec_target(self._programs()[key]),
                                 feed=feed, fetch_list=fetch,
                                 scope=self._scope)
            if self.tp_record is not None:
                self.tp_record.append([np.asarray(o) for o in outs])
            runs += 1

    def stop_followers(self) -> None:
        """Rank 0 of a tensor-parallel engine: end the followers' loops."""
        if self._ctl is not None and self._ctl.is_leader:
            self._ctl.send(("stop",))

    def _corrupt_pool(self, hit: int) -> None:
        """The serving_pool_corrupt payload: damage ONE piece of host-side
        bookkeeping so the audit has something real to catch — a phantom
        refcount holder, a live page pushed back on the free list, or a
        duplicate ordinal in the newest running request's table (that
        request is poisoned and must be quarantined). The kind cycles with
        the fault's hit index; nothing happens when nothing is live."""
        in_use = [p for p in range(self.pool.num_pages)
                  if self.pool.refcount(p) > 0]
        kind = hit % 3
        if kind == 0 and in_use:
            self.pool._refs[in_use[0]] += 1
        elif kind == 1 and in_use:
            self.pool._free.append(in_use[0])
        elif kind == 2:
            live = [r for r in self._running if r.pages]
            if live:
                victim = max(live, key=lambda r: r.admit_seq)
                victim.pages.append(victim.pages[0])

    def audit_pool(self) -> tuple[list[str], list[int]]:
        """Cross-check every live page table and the prefix cache against
        the pool invariants (free list and mapped ordinals partition the
        pool; refcounts equal live holder counts). Returns (problems,
        poisoned_rids): a request whose own table is malformed (an ordinal
        out of range or twice) is poisoned, and recovery quarantines it
        instead of replaying it."""
        problems: list[str] = []
        poisoned: list[int] = []
        holders: dict[int, int] = {}
        for r in self.requests.values():
            if not r.pages or r.state in _TERMINAL:
                continue
            bad = False
            seen: set[int] = set()
            for p in r.pages:
                if not 0 <= p < self.pool.num_pages:
                    problems.append(f"request {r.rid} maps page {p} "
                                    f"outside the pool")
                    bad = True
                    continue
                if p in seen:
                    problems.append(f"request {r.rid} maps page {p} twice")
                    bad = True
                seen.add(p)
                holders[p] = holders.get(p, 0) + 1
            if bad:
                poisoned.append(r.rid)
        if self.prefix_cache is not None:
            for node in self.prefix_cache._nodes.values():
                holders[node.page] = holders.get(node.page, 0) + 1
        problems.extend(self.pool.check_consistency(holders))
        return problems, poisoned

    def _recover(self, reason: str, poisoned=(), problems=()) -> None:
        """The recovery pass: quarantine poisoned requests (their tables
        are garbage), drop every page table and the prefix-cache index,
        rebuild the pool and replay every survivor from its PROMPT. Greedy
        decoding is deterministic, so the replayed outputs equal a
        fault-free run's; sampled requests draw the same tokens again
        through the per-(seed, rid, position) generator."""
        self._count("recovery.passes")
        obs.event("serving.recovery",
                  {"reason": reason, "problems": list(problems)[:8],
                   "quarantined": list(poisoned),
                   "running": len(self._running),
                   "waiting": len(self._waiting)}, level="error")
        for rid in poisoned:
            req = self.requests.get(rid)
            if req is None or req.state in _TERMINAL:
                continue
            if req in self._waiting:
                self._waiting.remove(req)
            if req in self._running:
                self._running.remove(req)
            req.pages = []  # a garbage table; the pool rebuild reclaims it
            req.cached_len = 0
            req.state = ABORTED
            req.t_done = time.perf_counter()
            self._count("recovery.quarantined")
            obs.event("serving.request",
                      {"rid": req.rid, "phase": "quarantined",
                       "n_generated": req.n_generated}, level="error")
        survivors = sorted(self._running, key=lambda r: r.admit_seq)
        self._running = []
        for req in survivors:
            del req.all_tokens[req.prompt_len:]  # replay from the prompt
            req.pages = []
            req.cached_len = 0
            req.state = WAITING
            req.admit_seq = -1
            self._count("recovery.replayed")
        for req in self._waiting:
            req.pages = []  # admission pins die with the pool rebuild
            req.cached_len = 0
        for req in self.requests.values():
            if req.state == HANDED_OFF:
                # the rebuild forfeits the prefill pin with everything
                # else; a late release_handoff must not release it twice
                # (the LEASE keeps the pages alive for the adopter)
                req.pages = []
        self._waiting[:0] = survivors
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self.pool.reset()
        post, _ = self.audit_pool()
        if post:
            raise RuntimeError(
                f"recovery left the pool inconsistent: {post[:4]}")

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
            if req.deadline_t is not None \
                    and time.perf_counter() > req.deadline_t:
                # expired while WAITING: never admit, return any pin
                self._terminate(req, DEADLINE_EXCEEDED, "deadline_exceeded")
                continue
            if req.pages:
                # an earlier attempt pinned this prefix hit, and the pin
                # stayed so that eviction relief could not free the match
                matched = req.pages
            else:
                matched = []
                if self.prefix_cache is not None:
                    self._count("prefix_lookups")
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
            # ladder's lookahead-shrink rung drops the reservation to the
            # bare context; _ensure_writable then allocates on demand)
            lookahead = 0 if self._ladder_rung >= 2 else 1
            need = self.pool.pages_for(len(req.all_tokens) + lookahead)
            private = self._allocate(max(0, need - len(matched)))
            if private is None:
                # keep the pin on the request: abort, shedding and expiry
                # release it, and the next attempt starts with it held
                req.pages = matched
                req.cached_len = len(matched) * self.page_size
                break
            req.pages = matched + private
            req.cached_len = len(matched) * self.page_size
            self._count("prefix_hit_tokens", req.cached_len)
            self._waiting.remove(req)
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            obs.histogram_observe("serving.queue_s",
                                  time.perf_counter() - req.arrival_t)
            obs.event("serving.request", {"rid": req.rid, "phase": "admitted",
                                          "cached_len": req.cached_len,
                                          "pages": len(req.pages)})
            # no rid label: span labels flow into the histogram series key,
            # and a label a request would mint series without bound
            with obs.span("serving.prefill"):
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
            self._count("prefix_full_hits")
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
            kind, prog, io, computed = ("suffix_prefill", self._window_prog,
                                        self._window_io, suf)
            sig = ("suffix", sb, pb)
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
            kind, prog, io, computed = ("prefill", self._prefill_prog,
                                        self._prefill_io, n)
            sig = (sb, pb)
        fetch = [io["next_token"]]
        if not req.sampling.is_greedy:
            fetch.append(io["last_logits"])
        outs = self._dispatch(kind, prog, feed, fetch)
        self.stats["prefill_signatures"].add(sig)
        self._count("prefill_tokens_computed", computed)
        self._count("prefills")
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
            obs.histogram_observe("serving.ttft_s", now - req.arrival_t)
            obs.event("serving.request",
                      {"rid": req.rid, "phase": "first_token",
                       "ttft_s": round(now - req.arrival_t, 9)})
        if req.is_done() or len(req.all_tokens) >= self.cfg.max_position:
            if req in self._running:
                self._running.remove(req)
            self._release(req)
            req.state = FINISHED
            req.t_done = now
            obs.histogram_observe("serving.request_s", now - req.arrival_t)
            obs.event("serving.request",
                      {"rid": req.rid, "phase": "finished",
                       "n_generated": req.n_generated,
                       "preemptions": req.preemptions,
                       "request_s": round(now - req.arrival_t, 9)})

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
        self._dispatch("cow", self._cow_prog, {
            sv_model.COW_SRC_FEED: np.asarray([old], np.int32),
            sv_model.COW_DST_FEED: np.asarray([new[0]], np.int32)}, [])
        self.pool.release([old])
        req.pages[ordinal] = new[0]
        self._count("cow_copies")
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
        self._count("preemptions")
        # head of the waiting queue: a preempted request lost work
        self._waiting.insert(0, req)

    def _note_decode_signature(self, sig: tuple) -> None:
        self.stats["decode_signatures"].add(sig)
        if self._warm_ctx is not None and sig not in self._warm_sigs:
            self.stats["cold_decode_signatures"].add(sig)

    def _decode_once(self) -> bool:
        # ladder rung 1+ falls back to plain one-token decode: the verify
        # window is the most speculative compute in the engine, so it is
        # the first thing sustained overload switches off
        if self.draft_k > 0 and self._ladder_rung < 1:
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
        outs = self._dispatch("decode", self._decode_prog, feed, fetch)
        nxt = outs[0].reshape(-1)
        self._count("decode_steps")
        self._note_decode_signature((bb, pb))
        for i, r in enumerate(rows):
            if r.sampling.is_greedy:
                t = int(nxt[i])
            else:
                rng = request_rng(self.seed, r.rid, r.n_generated)
                t = sample_token(outs[1][i], r.sampling, rng)
            self._count("decode_tokens")
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
        outs = self._dispatch("verify_window", self._window_prog, feed, fetch)
        toks = outs[0]
        self._count("decode_steps")
        self._count("spec_steps")
        self._note_decode_signature((bb, pb))
        for i, (r, n_valid, drafts) in enumerate(plans):
            if not r.sampling.is_greedy:
                # a sampling row takes exactly one (seeded) token a step;
                # draft acceptance is a greedy-only contract
                rng = request_rng(self.seed, r.rid, r.n_generated)
                self._count("decode_tokens")
                self._accept_token(r, sample_token(outs[1][i, 0], r.sampling,
                                                   rng))
                continue
            m = 0
            while m < n_valid - 1 and int(drafts[m]) == int(toks[i, m]):
                m += 1
            self._count("spec_proposed", n_valid - 1)
            self._count("spec_accepted", m)
            for j in range(m + 1):
                if r.state != RUNNING:
                    break
                self._count("decode_tokens")
                self._accept_token(r, int(toks[i, j]))
        return True
