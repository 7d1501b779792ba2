"""Fault-tolerant training runtime (the JAX package's resilience/, the
parts the tiered embeddings and the data pipeline use):

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
  * watchdog  — `Watchdog`/`StallError`: bounded host-side waits for the
                async executor drain and DeviceLoader; a wedged step dumps
                in-flight state instead of hanging forever
                (`FLAGS_watchdog_stall_s`).

The JAX package's guardrails (`health_sentinel`, `StepGuard`,
`replay_blame`) and `CheckpointedRunner` are not ported yet (ROADMAP
Queue 1, the guardrails and the runner).
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
from .watchdog import (  # noqa: F401
    HeartbeatMonitor, StallError, Watchdog, runtime_state, stall_window_s,
    watchdog_scale)

__all__ = [
    "FAULT_SITES", "FaultPlan", "InjectedFault", "fault_point",
    "fault_scope", "fault_stats", "install_plan",
    "RetryPolicy", "io_policy", "rpc_policy", "serving_policy",
    "fleet_policy", "connect_policy",
    "CheckpointManager",
    "StallError", "Watchdog", "HeartbeatMonitor", "stall_window_s",
    "watchdog_scale", "runtime_state",
]
