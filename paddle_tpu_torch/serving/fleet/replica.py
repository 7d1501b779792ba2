"""One engine replica as a failure domain.

`EngineReplica` owns one `ServingEngine` (its own KV pool, prefix cache,
executor) plus the thin shell the router needs around it: a
thread-safe inbox of placement jobs, an outbox of streamed results, a
heartbeat, and a lifecycle. EVERYTHING that touches the engine happens
inside `pump_once()` — the engine stays single-threaded by construction,
whether the pump runs inline on the router's thread or on the replica's
own worker thread (`FleetRouter(pump="threads")`).

Lifecycle (three states, plus the clean exit):

    HEALTHY  --drain()-->  DRAINING  --(no work left)-->  RETIRED
       |                      |
       +----- kill / hang / crash: beats stop ----->      DEAD
                     (discovered by the router's HeartbeatMonitor)

A DRAINING replica admits nothing: jobs still in its inbox bounce back
("handoff") and engine requests still WAITING (admitted to the engine's
queue but not yet prefilled — including requests the engine preempted
mid-drain) are aborted engine-side and handed off; RUNNING decodes finish
in place. When the engine drains empty the replica RETIRES and stamps its
drain duration — elastic scale-down with zero shed requests.

Death is never announced. The `fleet_replica_kill` site stops the pump
cold (SIGKILL: the engine is never touched again), `fleet_replica_hang`
wedges it (pumps keep arriving, nothing progresses), an engine exception
freezes it (the OOM-kill stand-in) — in every case the only symptom is a
heartbeat that stops, exactly like a preempted host, and the router
must notice via missed beats and replay the replica's in-flight work.

Outbox event shapes (consumed by FleetRouter.poll):
    ("tokens",  fid, start_index, [tok, ...])   streamed generation delta
    ("done",    fid, terminal_engine_state)     request left the engine
    ("reject",  fid, retry_after_s)             engine admission refused
    ("handoff", fid)                            draining replica gave it up
    ("prepared", fid, lease_id)                 prefill published a lease
    ("adopted",  fid, lease_id)                 decode committed + adopted
    ("commit_failed", fid, lease_id, why)       commit bounced; replay me

Disaggregation: a `role="prefill"` replica never decodes —
after each step it extracts every freshly prefilled RUNNING request,
publishes it under a TTL'd lease (`HandoffManager.prepare`) and emits
"prepared"; the request sits HANDED_OFF (pages pinned) in `_pinned` until
the router's {"release": fid} job confirms the adopting side committed.
A decode-capable replica receives {"commit": lease_id, "fid": fid} jobs:
commit transfers the lease refcount, `engine.adopt_request` resumes the
decode mid-request, and every token streams from here (`_sent` starts at
0, so the prefill-produced first token is delivered by the ADOPTER — the
prefill side streams nothing for handed-off requests). The
`disagg_prefill_kill` fault site SIGKILLs a prefill replica exactly like
`fleet_replica_kill` does a generic one.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ... import observability as obs
from ...resilience.faults import InjectedFault, fault_point

__all__ = ["EngineReplica", "HEALTHY", "DRAINING", "DEAD", "RETIRED",
           "STATE_ORDINAL"]

HEALTHY, DRAINING, DEAD, RETIRED = "healthy", "draining", "dead", "retired"
# gauge encoding for the per-replica fleet.replica_state series
STATE_ORDINAL = {HEALTHY: 0, DRAINING: 1, RETIRED: 2, DEAD: 3}

# engine terminal states (mirrors serving.engine._TERMINAL without reaching
# into the engine module's privates)
_ENGINE_TERMINAL = frozenset(
    {"finished", "aborted", "deadline_exceeded", "shed"})


class EngineReplica:
    """One engine + inbox/outbox/heartbeat shell. See the module docstring
    for the lifecycle; the router is the only writer of `state` except for
    the DRAINING->RETIRED transition, which the pump takes itself (only it
    knows when the engine is empty)."""

    def __init__(self, rid: int, engine, monitor, name: str | None = None,
                 role: str = "mixed", handoff=None):
        self.rid = int(rid)
        self.engine = engine
        self.monitor = monitor
        self.role = str(role)  # "mixed" | "prefill" | "decode"
        self.handoff = handoff  # shared HandoffManager (disagg fleets only)
        self.name = name or f"replica{rid}"
        self.state = HEALTHY
        self._inbox: deque = deque()
        self._outbox: deque = deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._hung = False
        self.crash: BaseException | None = None
        self.t_drain_start: float | None = None
        # stamped at every pump ENTRY: the router's health check compares it
        # to the last beat, so "pumped since the beat yet never beat again"
        # (kill/hang/crash) reads as death while "beat stale because the
        # shared inline thread sat in a neighbor's long first step" does not
        self.t_last_pump = time.monotonic()
        # pump-side maps: engine rid -> (fid, tokens already streamed out)
        self._fid_of: dict[int, int] = {}
        self._sent: dict[int, int] = {}
        # prefill-side: fid -> engine rid of a HANDED_OFF request whose
        # prefill pin awaits the router's post-commit {"release": fid}
        self._pinned: dict[int, int] = {}
        monitor.register(self.name)

    # -- router-side API (thread-safe) --------------------------------------
    @property
    def alive(self) -> bool:
        return self.state in (HEALTHY, DRAINING)

    def enqueue(self, job: dict) -> None:
        """Queue one placement job ({fid, prompt, max_new_tokens, eos_id,
        sampling, priority, deadline_s}) or control ({abort: fid})."""
        with self._lock:
            self._inbox.append(job)

    def drain_events(self) -> list[tuple]:
        with self._lock:
            out = list(self._outbox)
            self._outbox.clear()
        return out

    def load(self) -> int:
        """Jobs this replica holds that the router still waits on — the
        router-visible placement load (inbox + streamed-but-unfinished)."""
        with self._lock:
            return len(self._inbox) + len(self._fid_of)

    def begin_drain(self) -> None:
        if self.state == HEALTHY:
            self.state = DRAINING
            self.t_drain_start = time.perf_counter()

    def mark_dead(self) -> None:
        self.state = DEAD
        self._stop.set()
        self.monitor.deregister(self.name)

    def sigkill(self) -> None:
        """SIGKILL-equivalent silent death (the chaos trigger): the
        pump stops cold, the engine is never touched again, NOTHING is
        announced — the router must discover it by missed heartbeats. The
        `fleet_replica_kill` fault site lands here too."""
        self._hung = True
        if self.crash is None:
            self.crash = RuntimeError("sigkill")

    # -- worker thread (FleetRouter pump="threads") -------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._worker, name=self.name, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def _worker(self) -> None:
        while not self._stop.is_set() and self.alive:
            if not self.pump_once():
                # idle (or wedged): yield without burning the core
                time.sleep(0.001)

    # -- the pump (the ONLY code that touches the engine) -------------------
    def pump_once(self) -> bool:
        """One replica iteration: fault sites -> admit inbox -> one engine
        step -> stream deltas -> retire check -> heartbeat. Returns True if
        anything progressed."""
        if not self.alive:
            return False
        self.t_last_pump = time.monotonic()
        try:
            fault_point("fleet_replica_kill")
        except InjectedFault as e:
            # SIGKILL: no cleanup, no announcement — the heartbeat just
            # stops and the router must discover the death by missed beats
            self.crash = e
            self.sigkill()
            return False
        if self.role == "prefill":
            try:
                # targeted SIGKILL of the prefill stage: any lease this
                # replica already published survives in the SHARED pool and
                # still commits; anything pre-PREPARE replays on a
                # surviving prefill replica
                fault_point("disagg_prefill_kill")
            except InjectedFault as e:
                self.crash = e
                self.sigkill()
                return False
        try:
            fault_point("fleet_replica_hang")
        except InjectedFault:
            self._hung = True  # wedged host: pumps arrive, nothing moves
        if self._hung:
            return False
        try:
            progressed = self._pump_inner()
        except Exception as e:  # noqa: BLE001 — a crashed engine IS a death
            self.crash = e
            self._hung = True
            obs.event("fleet.replica",
                      {"rid": self.rid, "state": "crashed",
                       "error": repr(e)}, level="error")
            return False
        # the beat says "this replica made a scheduling decision", even an
        # idle one; the slow-heartbeat site drops ONE stamp (a loaded host)
        try:
            fault_point("fleet_heartbeat_slow")
            self.monitor.beat(self.name)
        except InjectedFault:
            pass
        return progressed

    def _pump_inner(self) -> bool:
        # the replica's idle gap is a safe actuation boundary:
        # before admitting new arrivals, let a staged controller config
        # swap in while nothing is in flight (no-op without one pending)
        self.engine.maybe_adopt_config()
        progressed = self._admit_inbox()
        if self.state == DRAINING:
            self._handoff_waiting()
        if self.engine.has_work():
            self.engine.step()
            progressed = True
        if self.role == "prefill" and self.handoff is not None:
            # BEFORE streaming: extraction removes the request from
            # `_fid_of`, so the prefill-produced first token never streams
            # from here — the adopter delivers it (exactly-once by
            # construction, not by dedup)
            self._extract_prepared()
        self._stream_deltas()
        if (self.state == DRAINING and not self.engine.has_work()
                and not self._inbox):
            self.state = RETIRED
            self._stop.set()
            self.monitor.deregister(self.name)
        return progressed

    def _admit_inbox(self) -> bool:
        with self._lock:
            jobs, self._inbox = list(self._inbox), deque()
        moved = False
        deferred: list[dict] = []
        for job in jobs:
            if "abort" in job:
                fid = job["abort"]
                erids = [e for e, f in self._fid_of.items() if f == fid]
                for erid in erids:
                    self.engine.abort(erid)
                moved = True
                continue
            if "release" in job:
                # post-commit confirmation: the adopter's ledger carries
                # the pages now, drop the prefill pin (idempotent)
                erid = self._pinned.pop(job["release"], None)
                if erid is not None:
                    self.engine.release_handoff(erid)
                moved = True
                continue
            if "commit" in job:
                # backpressure: an adopted request enters RUNNING directly,
                # so the commit waits for a decode slot rather than consume
                # the lease into an overfull batch. The lease keeps aging —
                # if this replica stays saturated past the TTL, the reaper
                # replays the request elsewhere.
                if self.state != DRAINING \
                        and not self.engine.decode_slots_free:
                    deferred.append(job)
                    continue
                self._commit_job(job["commit"], job["fid"])
                moved = True
                continue
            fid = job["fid"]
            if self.state == DRAINING:
                self._emit("handoff", fid)
                continue
            try:
                erid = self.engine.submit(
                    job["prompt"], job["max_new_tokens"],
                    eos_id=job.get("eos_id"),
                    sampling=job.get("sampling"),
                    deadline_s=job.get("deadline_s"),
                    priority=job.get("priority"))
            except Exception as e:  # AdmissionRejected (or a bad request)
                self._emit("reject", fid,
                           getattr(e, "retry_after_s", 0.05))
                continue
            self._fid_of[erid] = fid
            self._sent[erid] = 0
            moved = True
        if deferred:  # retry next pump, ahead of newer jobs
            with self._lock:
                self._inbox.extendleft(reversed(deferred))
        return moved

    def _handoff_waiting(self) -> None:
        """A draining replica's engine-side WAITING requests (never
        prefilled, or preempted back mid-drain) abort locally and bounce to
        the router for re-placement; RUNNING decodes finish in place."""
        for erid, fid in list(self._fid_of.items()):
            req = self.engine.requests.get(erid)
            if req is not None and req.state == "waiting":
                self.engine.abort(erid)
                # pop ONLY this record — a blanket prune_finished() here
                # would swallow same-step terminals not yet streamed out
                self.engine.pop_result(erid)
                self._fid_of.pop(erid, None)
                self._sent.pop(erid, None)
                self._emit("handoff", fid)

    def _extract_prepared(self) -> None:
        """PREPARE: every request this prefill engine finished prefilling
        (state RUNNING — requests that went terminal AT prefill stream
        normally from here) leaves the scheduler HANDED_OFF and its
        transfer state is published under a TTL'd lease. From this emit on
        the request's fate is the lease's: commit adopts it elsewhere,
        reap replays it, and our pin waits for the router's release."""
        for erid, fid in list(self._fid_of.items()):
            req = self.engine.requests.get(erid)
            if req is None or req.state != "running":
                continue
            payload = self.engine.extract_for_handoff(erid)
            lid = self.handoff.prepare(fid, payload)
            self._pinned[fid] = erid
            self._fid_of.pop(erid, None)
            self._sent.pop(erid, None)
            self._emit("prepared", fid, lid)

    def _commit_job(self, lid: str, fid: int) -> None:
        """COMMIT: adopt one leased request into this engine. Every
        failure mode answers with "commit_failed" — silence would strand
        the request until the lease reaper noticed — and the commit/adopt
        pair never half-applies: a commit that throws left the pin with
        the lease; an adopt that throws hands the transferred refcount
        straight back to the shared pool."""
        from .handoff import HandoffError

        if self.state == DRAINING:
            self._emit("commit_failed", fid, lid, "draining")
            return
        try:
            lease = self.handoff.commit(lid)
        except HandoffError as e:
            self._emit("commit_failed", fid, lid, repr(e))
            return
        try:
            erid = self.engine.adopt_request(lease.payload)
        except Exception as e:  # noqa: BLE001 — refcount must not strand
            self.handoff.pool.release(lease.pages)
            self._emit("commit_failed", fid, lid, repr(e))
            return
        self._fid_of[erid] = fid
        self._sent[erid] = 0
        self._emit("adopted", fid, lid)

    def _stream_deltas(self) -> None:
        for erid, fid in list(self._fid_of.items()):
            req = self.engine.requests.get(erid)
            if req is None:  # record vanished underneath us: surface it as
                self._emit("done", fid, "aborted")  # lost, never go silent
                self._fid_of.pop(erid, None)
                self._sent.pop(erid, None)
                continue
            sent = self._sent[erid]
            out = req.out_tokens
            if len(out) > sent:
                self._emit("tokens", fid, sent, out[sent:])
                self._sent[erid] = len(out)
            if req.state in _ENGINE_TERMINAL:
                self._emit("done", fid, req.state)
                self.engine.pop_result(erid)
                self._fid_of.pop(erid, None)
                self._sent.pop(erid, None)

    def _emit(self, *event) -> None:
        with self._lock:
            self._outbox.append(tuple(event))
