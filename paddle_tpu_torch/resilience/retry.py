"""RetryPolicy: exponential backoff + deterministic jitter + deadline (the
JAX package's resilience/retry.py).

Retry is a first-class policy object; the port applies `io_policy` to its
checkpoint I/O (io.py save_sharded/load_sharded), `serving_policy` to the
serving engine's step dispatch and `fleet_policy` to the fleet router's
failover placement. The pserver RPC and first-connection policies of the
JAX package configure callers the port has not ported: each raises naming
its ROADMAP item.

Only *transient* errors retry: transport failures (ConnectionError — which
InjectedFault subclasses — EOFError, TimeoutError, OSError) by default.
Application errors (RuntimeError) are not transient and surface
immediately.

Jitter is deterministic — seeded from the attempt index — so a replayed
fault plan sees identical sleep sequences and the chaos tests stay
reproducible down to timing-dependent interleavings.
"""
from __future__ import annotations

import hashlib
import time
from typing import Callable, Iterable

__all__ = ["RetryPolicy", "rpc_policy", "io_policy", "serving_policy",
           "fleet_policy", "connect_policy"]

_TRANSIENT = (ConnectionError, EOFError, TimeoutError, OSError)


class RetryPolicy:
    def __init__(self, max_attempts: int = 4, base_delay: float = 0.05,
                 max_delay: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.5, deadline: float | None = 30.0,
                 retryable: Iterable[type[BaseException]] = _TRANSIENT,
                 seed: int = 0, sleep: Callable[[float], None] = time.sleep):
        """deadline: wall-clock budget in seconds for ALL attempts of one
        call (None = unbounded); jitter: fraction of the backoff delay drawn
        deterministically in [0, jitter)."""
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.retryable = tuple(retryable)
        self.seed = int(seed)
        self._sleep = sleep

    def delay(self, attempt: int) -> float:
        """Backoff before retry number `attempt` (1-based), jittered."""
        d = min(self.base_delay * self.multiplier ** (attempt - 1),
                self.max_delay)
        if self.jitter:
            h = hashlib.sha256(f"{self.seed}:{attempt}".encode()).digest()
            frac = int.from_bytes(h[:8], "big") / 2**64
            d *= 1.0 + self.jitter * frac
        return d

    def call(self, fn: Callable, *args, on_retry: Callable | None = None,
             **kwargs):
        """Run fn until success, a non-retryable error, attempts exhaust, or
        the deadline passes. on_retry(attempt, exc) fires before each retry —
        the hook RPC callers use to drop a broken connection."""
        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retryable as e:
                if attempt >= self.max_attempts:
                    raise
                d = self.delay(attempt)
                if (self.deadline is not None
                        and time.monotonic() + d - start > self.deadline):
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                self._sleep(d)

    def wrap(self, fn: Callable, on_retry: Callable | None = None) -> Callable:
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, on_retry=on_retry, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped

    def __repr__(self):
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"base_delay={self.base_delay}, max_delay={self.max_delay}, "
                f"deadline={self.deadline})")


def _from_flags(**overrides) -> RetryPolicy:
    from .. import flags

    kw = dict(
        max_attempts=flags.get_flag("retry_max_attempts"),
        base_delay=flags.get_flag("retry_base_delay_ms") / 1000.0,
        max_delay=flags.get_flag("retry_max_delay_ms") / 1000.0,
        deadline=flags.get_flag("retry_deadline_s") or None,
    )
    kw.update(overrides)
    return RetryPolicy(**kw)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} configures a caller that is not ported yet (ROADMAP "
        f"Queue 1, {item})")


def rpc_policy(**overrides) -> RetryPolicy:
    """Policy for pserver RPCs (FLAGS_retry_*): the PS client is not ported
    yet."""
    _not_ported("rpc_policy", "parallel and distributed")


def serving_policy(**overrides) -> RetryPolicy:
    """Policy for serving-engine step dispatch: fast, tightly bounded
    attempts with no wall-clock deadline — a decode step is milliseconds,
    so backoff at checkpoint-I/O scale would stall every request in the
    batch. Attempt count from FLAGS_serving_step_retries; exhaustion is
    the engine supervisor's signal to run the recovery pass."""
    from .. import flags

    kw = dict(
        max_attempts=max(1, flags.get_flag("serving_step_retries")),
        base_delay=0.001, max_delay=0.02, deadline=None)
    kw.update(overrides)
    return RetryPolicy(**kw)


def fleet_policy(**overrides) -> RetryPolicy:
    """Policy for fleet-router failover placement: max_attempts IS the
    per-request failover budget (FLAGS_fleet_failover_budget — one attempt
    per replica death), and the millisecond backoff paces re-placement
    when every survivor momentarily rejects. AdmissionRejected counts as
    transient here — a shedding replica is a full replica, and another one
    (or the same one a beat later) may admit. Disaggregated handoff
    failures (a reaped lease, a bounced commit, a death on either side of
    the prefill->decode transfer) ride this same budget, while planned
    drain handoffs stay free."""
    from .. import flags
    from ..serving.engine import AdmissionRejected

    kw = dict(
        max_attempts=max(1, flags.get_flag("fleet_failover_budget")),
        base_delay=0.002, max_delay=0.05, deadline=None,
        retryable=_TRANSIENT + (AdmissionRejected,))
    kw.update(overrides)
    return RetryPolicy(**kw)


def connect_policy(**overrides) -> RetryPolicy:
    """Policy for first-connection dials of the PS client: not ported
    yet."""
    _not_ported("connect_policy", "parallel and distributed")


def io_policy(**overrides) -> RetryPolicy:
    """Policy for checkpoint I/O: fewer, slower attempts — filesystem brown-
    outs recover on the order of seconds, not milliseconds."""
    from .. import flags

    kw = dict(
        max_attempts=max(2, flags.get_flag("retry_max_attempts") - 1),
        base_delay=flags.get_flag("retry_base_delay_ms") / 1000.0 * 4)
    kw.update(overrides)
    return _from_flags(**kw)
