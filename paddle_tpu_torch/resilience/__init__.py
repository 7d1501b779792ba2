"""Fault-tolerant training runtime (the JAX package's resilience/):

  * faults    — seeded, deterministic fault-injection registry; named sites
                raise on a reproducible schedule so every recovery path is
                testable on one host (`FLAGS_fault_plan` / `fault_scope`).
  * retry     — `RetryPolicy` (exponential backoff + deterministic jitter +
                deadline) applied to checkpoint I/O (`io_policy`).
  * checkpoint— `CheckpointManager`: atomic per-step versioned directories
                over save_sharded/load_sharded with a manifest (step,
                program hash, RNG counter), keep-last-k GC, corrupt-
                checkpoint rollback, `latest_step()` auto-resume and state
                providers (the tiered embeddings' delta checkpoints).
  * runner    — `CheckpointedRunner`: an Executor.run training loop with
                periodic save, restore-and-replay on fault, and escalation
                (the prepared-program record dropped, then a plain retry)
                before surfacing the error as `StepFailure`.
  * watchdog  — `Watchdog`/`StallError`: bounded host-side waits for the
                async executor drain and DeviceLoader; a wedged step dumps
                in-flight state instead of hanging forever
                (`FLAGS_watchdog_stall_s`).
  * guardrails— numeric-fault recovery: the health sentinel
                (`FLAGS_guard_numerics`, appended by minimize()) plus
                `StepGuard` — bad steps skip in-graph, budget overruns
                rewind via CheckpointManager with LR backoff, and the
                offending step replays on a cloned scope for an
                op-attributed blame report (`replay_blame`).
"""
from .faults import (  # noqa: F401
    FAULT_SITES,
    FaultPlan,
    InjectedFault,
    fault_point,
    fault_scope,
    fault_stats,
    install_plan,
)
from .retry import (  # noqa: F401
    RetryPolicy, connect_policy, fleet_policy, io_policy, rpc_policy,
    serving_policy)
from .checkpoint import CheckpointManager  # noqa: F401
from .runner import CheckpointedRunner, StepFailure  # noqa: F401
from .watchdog import (  # noqa: F401
    HeartbeatMonitor, StallError, Watchdog, runtime_state, stall_window_s,
    watchdog_scale)
from .guardrails import (  # noqa: F401
    GUARD_HEALTH_NAME,
    GUARD_STATE_NAME,
    GuardError,
    GuardRewind,
    StepGuard,
    replay_blame,
)

__all__ = [
    "FAULT_SITES", "FaultPlan", "InjectedFault", "fault_point",
    "fault_scope", "fault_stats", "install_plan",
    "RetryPolicy", "io_policy", "rpc_policy", "serving_policy",
    "fleet_policy", "connect_policy",
    "CheckpointManager", "CheckpointedRunner", "StepFailure",
    "StallError", "Watchdog", "HeartbeatMonitor", "stall_window_s",
    "watchdog_scale", "runtime_state",
    "GUARD_HEALTH_NAME", "GUARD_STATE_NAME", "GuardError", "GuardRewind",
    "StepGuard", "replay_blame",
]
