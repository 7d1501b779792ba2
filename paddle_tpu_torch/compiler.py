"""CompiledProgram: a Program with a mesh and a regime to run it under.

The JAX package's compiler.py records a jax Mesh and lets XLA partition
the program. Here a CompiledProgram records the port's Mesh (the world's
ranks and this rank's groups) and one of two regimes, which the Executor
runs:
  * `with_data_parallel` ("gspmd", the JAX package's name for it): global
    semantics. Each rank feeds its own rows of the global batch, and the
    Executor runs a private clone of the program that
    `parallel.sharding.data_parallel_rewrite` made for the mesh, so the
    step equals the one-device step on the whole batch. The user's program
    is not changed; `c_*` ops the program holds stay the identity. At
    world size 1 the clone is the program.
  * `with_collective` ("shard_map"): per-rank semantics. Each rank runs
    the program on its own rows, and the `c_*` ops a transpiler inserted
    (parallel.collective.GradAllReduce, LocalSGD, apply_zero1) reduce over
    the mesh's groups.
"""
from __future__ import annotations

from .framework import Program

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """The reference's knob surface. `sharded_optimizer_states` applies
    ZeRO-1 (parallel/sharding.apply_zero1) to the data-parallel clone; the
    other knobs are kept for API parity and change nothing."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_all_optimizer_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.num_trainers = 1
        self.trainer_id = 0
        self.use_hierarchical_allreduce = False
        self.sharded_optimizer_states = False


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = True


class CompiledProgram:
    def __init__(self, program_or_graph,
                 build_strategy: BuildStrategy | None = None):
        if isinstance(program_or_graph, CompiledProgram):
            program_or_graph = program_or_graph._program
        self._program: Program = program_or_graph
        self._mesh = None
        self._spmd_mode = "gspmd"
        self._build_strategy = build_strategy or BuildStrategy()
        self._loss_name = None

    def with_data_parallel(self, loss_name: str | None = None,
                           build_strategy: BuildStrategy | None = None,
                           exec_strategy: ExecutionStrategy | None = None,
                           share_vars_from=None, places=None,
                           mesh=None) -> "CompiledProgram":
        """Run the program data-parallel over `mesh` (default: every rank
        of the world on one `dp` axis) with the one-device program's
        semantics on the global batch."""
        from .parallel.mesh import make_mesh

        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._mesh = mesh if mesh is not None else make_mesh(places=places)
        self._spmd_mode = "gspmd"
        if self._build_strategy.sharded_optimizer_states:
            self._annotate_opt_state_shardings()
        return self

    def _annotate_opt_state_shardings(self):
        """The JAX package's ZeRO-1 annotation: every optimizer state whose
        leading dim divides over the dp axis is annotated as sharded on it
        (metadata; the port's ZeRO-1 is the rewrite on the clone)."""
        from .parallel.mesh import DATA_AXIS

        if DATA_AXIS not in self._mesh.axis_names:
            return
        dp = self._mesh.shape[DATA_AXIS]
        for v in self._program.global_block.vars.values():
            if (getattr(v, "is_opt_state", False) and v.sharding is None
                    and len(v.shape) >= 1 and v.shape[0] % dp == 0
                    and v.shape[0] >= dp):
                v.sharding = (DATA_AXIS,) + (None,) * (len(v.shape) - 1)

    def with_collective(self, mesh=None, places=None) -> "CompiledProgram":
        """Run the program per rank with its `c_*` ops bound to the mesh's
        groups (the fleet regime). Use after a GradAllReduce-style
        transpile."""
        from .parallel.mesh import make_mesh

        self._mesh = mesh if mesh is not None else make_mesh(places=places)
        self._spmd_mode = "shard_map"
        return self

    # pass-throughs so a CompiledProgram can stand in for its Program
    @property
    def global_block(self):
        return self._program.global_block

    def all_parameters(self):
        return self._program.all_parameters()
