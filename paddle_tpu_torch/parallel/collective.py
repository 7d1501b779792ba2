"""Collective program transpilers: GradAllReduce and LocalSGD.

The JAX package's parallel/collective.py, rewrite for rewrite: find the
gradients the optimizer ops consume and insert mean-allreduces between the
backward and the optimizer ops. GradAllReduce coalesces the gradients into
reverse-topological buckets of about FLAGS_allreduce_bucket_mb megabytes
and inserts each bucket's `c_allreduce_coalesced` where its last member is
final (backward.grad_ready_index: below AMP's unscale, the clip and the
guard's sentinel), so a finished bucket's reduce is queued while the
backward still produces the next. The bucket size resolves through the
port's tuner (`collective|mesh=..|payload=..` keys, the flag as the
analytic prior) unless tuning is off or the caller names it. With
FLAGS_zero1 the eligible gradients take the ZeRO-1 path
(parallel/sharding.apply_zero1) and the rest bucket here. The inserted ops
reduce over torch.distributed groups under
`CompiledProgram.with_collective` and are the identity elsewhere
(ops/collective_ops.py).
"""
from __future__ import annotations

import numpy as np

from ..framework import Program

__all__ = ["Collective", "GradAllReduce", "LocalSGD", "build_buckets",
           "resolve_bucket_mb"]

OPTIMIZER_OP_TYPES = {
    "sgd",
    "momentum",
    "lars_momentum",
    "adagrad",
    "adam",
    "adamax",
    "decayed_adagrad",
    "adadelta",
    "rmsprop",
    "ftrl",
    "lamb",
}


class Collective:
    def __init__(self, nrings: int = 1):
        self.nrings = nrings
        self.nranks = 1

    def transpile(self, startup_program: Program, main_program: Program, rank: int, endpoints=None, current_endpoint=None, wait_port=True, nranks: int | None = None):
        self.nranks = nranks if nranks is not None else (len(endpoints) if endpoints else 1)
        self.rank = rank
        self._transpile_main(main_program)
        self._transpile_startup(startup_program)

    def _transpile_startup(self, program: Program):
        pass  # mesh construction replaces comm-init ops (c_comm_init_all no-op)

    def _transpile_main(self, program: Program):
        raise NotImplementedError


def _grad_op_positions(block):
    """[(index, param_name, grad_name)] of optimizer ops' (param, grad)."""
    out = []
    for i, op in enumerate(block.ops):
        if op.type in OPTIMIZER_OP_TYPES:
            out.append((i, op.input("Param")[0], op.input("Grad")[0]))
    return out


def _grad_bytes(block, name: str) -> int:
    try:
        v = block.var(name)
    except KeyError:
        return 0
    shape = [abs(d) if d else 1 for d in v.shape] or [1]
    try:
        itemsize = np.dtype(v.np_dtype).itemsize
    except (TypeError, ValueError):
        itemsize = 4
    return int(np.prod(shape)) * itemsize


def resolve_bucket_mb(nranks: int, payload_bytes: int,
                      bucket_mb: float | None = None) -> tuple[float, str]:
    """Bucket size for this (mesh, payload), as (mb, provenance tier).

    Explicit `bucket_mb` (the transpiler/DistributedStrategy argument) wins
    outright. Otherwise under FLAGS_tuning_mode != off the decision routes
    through the three-tier tuner — `collective|mesh=..|payload=..` exact DB
    hit, else FLAGS_allreduce_bucket_mb as the analytic prior; with tuning
    off the flag applies directly."""
    from .. import flags

    if bucket_mb is not None:
        return float(bucket_mb), "explicit"
    flag_mb = float(flags.get_flag("allreduce_bucket_mb"))
    from .. import tuning
    from .mesh import axes_desc

    if tuning.mode() == "off":
        return flag_mb, "flag"
    key = tuning.canonical_key(
        "collective", tuning.collective_key(axes_desc(nranks), payload_bytes),
        "float32", tuning.device_kind())
    decision, tier = tuning.decide(
        "collective", key,
        prior=lambda: {"bucket_mb": flag_mb},
        default={"bucket_mb": flag_mb},
        validate=lambda d: "bucket_mb" in d)
    return float(decision.get("bucket_mb", flag_mb)), tier


def build_buckets(items, bucket_bytes: int):
    """Greedy reverse-topological bucketing: `items` is [(ready_index,
    grad_name, nbytes)] — grads in the order the backward FINISHES them
    (ascending last-writer index = descending layer depth, the DDP
    convention) — cut into consecutive groups of <= bucket_bytes (one
    oversized grad still gets its own bucket). bucket_bytes <= 0 degrades
    to one bucket per grad (the overlap-off arm)."""
    buckets: list[list] = []
    cur: list = []
    cur_bytes = 0
    for it in sorted(items, key=lambda t: (t[0], t[1])):
        if bucket_bytes <= 0:
            buckets.append([it])
            continue
        if cur and cur_bytes + it[2] > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(it)
        cur_bytes += it[2]
    if cur:
        buckets.append(cur)
    return buckets


class GradAllReduce(Collective):
    """Insert a mean-allreduce on every gradient an optimizer op consumes.
    The 1/nranks scale is the op's `avg` attr, so it applies only when the
    op reduces: a separate scale op would shrink the gradients where the
    op is the identity.

    bucket_mb: gradient-bucket size in MB (None = resolve through the tuner /
    FLAGS_allreduce_bucket_mb; <= 0 = per-gradient reduces inserted before
    the optimizer ops, the overlap-off arm). zero1: route eligible params
    through ZeRO-1 sharding (None = FLAGS_zero1)."""

    def __init__(self, nrings: int = 1, bucket_mb: float | None = None,
                 zero1: bool | None = None):
        super().__init__(nrings)
        self.bucket_mb = bucket_mb
        self.zero1 = zero1
        # introspection for tests: [(insert_pos, [grad names])] of the
        # last transpile, plus the resolved size and its provenance tier
        self.last_buckets: list[tuple[int, list[str]]] = []
        self.resolved_bucket_mb: float | None = None
        self.bucket_source: str = "none"
        self.zero1_params: list[str] = []

    def _transpile_main(self, program: Program):
        from .. import flags
        from ..backward import grad_ready_index

        block = program.global_block
        targets = _grad_op_positions(block)
        if not targets:
            return
        first_opt = targets[0][0]

        zero1 = (bool(flags.get_flag("zero1")) if self.zero1 is None
                 else bool(self.zero1))
        if zero1:
            from .sharding import _SHARD_SUFFIX, apply_zero1

            self.zero1_params = apply_zero1(program, self.nranks)
            # re-scan: zero1 rewrote its ops (Param/Grad now name shards) and
            # shifted indices; the shard-suffixed ops are already handled
            targets = [t for t in _grad_op_positions(block)
                       if not t[1].endswith(_SHARD_SUFFIX)]
            if not targets:
                self.last_buckets = []
                return
            first_opt = targets[0][0]

        items = []
        for _, _, g in targets:
            ready = grad_ready_index(block, g, first_opt)
            items.append((ready if ready >= 0 else first_opt - 1, g,
                          _grad_bytes(block, g)))
        payload = sum(b for _, _, b in items)
        self.last_payload_bytes = payload
        mb, tier = resolve_bucket_mb(self.nranks, payload, self.bucket_mb)
        self.resolved_bucket_mb, self.bucket_source = mb, tier
        buckets = build_buckets(items, int(mb * (1 << 20)))

        # per-bucket insert point: right after the bucket's LAST member is
        # final (overlap regime). bucket_mb <= 0 keeps the historical
        # placement — every per-grad reduce parked at the optimizer boundary,
        # i.e. serialized after the whole backward (the A/B baseline).
        inserts = []  # (position, [grad names])
        ring = 0
        for bucket in buckets:
            pos = (first_opt if mb <= 0
                   else max(r for r, _, _ in bucket) + 1)
            inserts.append((pos, [g for _, g, _ in bucket], ring))
            ring = (ring + 1) % self.nrings
        # insert bottom-up so earlier positions stay valid. Single-member
        # buckets keep the classic c_allreduce_sum spelling (same kernel,
        # and the fleet-regime assertions/tools that look for it still hold)
        self.last_buckets = []
        for pos, names, ring in sorted(inserts, key=lambda t: -t[0]):
            if len(names) == 1:
                block._insert_op(
                    pos, "c_allreduce_sum", {"X": names}, {"Out": names},
                    {"ring_id": ring, "avg": True})
            else:
                block._insert_op(
                    pos, "c_allreduce_coalesced", {"X": names},
                    {"Out": names}, {"ring_id": ring, "avg": True})
            self.last_buckets.append((pos, names))
        self.last_buckets.reverse()


class LocalSGD(Collective):
    """Local updates with periodic parameter averaging: snapshot the
    parameters, train k_steps local steps, then mean-allreduce the
    (param - snapshot) deltas and fold them back."""

    def __init__(self, nrings: int = 1, k_steps: int = 1):
        super().__init__(nrings)
        self.k_steps = k_steps

    def _transpile_main(self, program: Program):
        block = program.global_block
        params = [p.name for p in program.all_parameters()]
        if not params:
            return
        # persistable step counter, incremented each run
        step_name = "@LOCAL_SGD_STEP@"
        block.create_var(name=step_name, shape=[], dtype="int64",
                         persistable=True, stop_gradient=True)
        block.append_op("increment", {"X": [step_name]}, {"Out": [step_name]},
                        {"step": 1.0})
        for p in params:
            snap = p + "@SNAPSHOT"
            pv = block.var(p)
            block.create_var(name=snap, shape=pv.shape, dtype=pv.dtype,
                             persistable=True, stop_gradient=True)
            block.append_op(
                "local_sgd_sync",
                {"Param": [p], "Snapshot": [snap], "Step": [step_name]},
                {"ParamOut": [p], "SnapshotOut": [snap]},
                {"k_steps": self.k_steps, "ring_id": 0},
            )

    def _transpile_startup(self, program: Program):
        block = program.global_block
        block.create_var(name="@LOCAL_SGD_STEP@", shape=[], dtype="int64",
                         persistable=True)
        block.append_op("fill_constant", {}, {"Out": ["@LOCAL_SGD_STEP@"]},
                        {"shape": [], "dtype": "int64", "value": 0.0})
        # snapshot starts equal to the freshly-initialized params
        for p in program.all_parameters():
            snap = p.name + "@SNAPSHOT"
            block.create_var(name=snap, shape=p.shape, dtype=p.dtype,
                             persistable=True)
            block.append_op("assign", {"X": [p.name]}, {"Out": [snap]}, {})
