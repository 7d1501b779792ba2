"""The fleet's collective mode: role makers and the `fleet` singleton.

The JAX package's incubate/fleet/base.py: `fleet.init(role_maker, mesh)`,
`fleet.distributed_optimizer(inner, strategy).minimize(loss)`, which
minimizes and then transpiles the program (GradAllReduce with buckets and
ZeRO-1, or LocalSGD), and `fleet.compiled_program()`, a CompiledProgram
under `with_collective`. A worker is one rank of the torch.distributed
world that distributed.init_parallel_env made; PaddleCloudRoleMaker reads
the launcher's env contract.
"""
from __future__ import annotations

import os

__all__ = [
    "Role",
    "UserDefinedRoleMaker",
    "PaddleCloudRoleMaker",
    "Fleet",
    "fleet",
]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role = Role.WORKER
        self._current_id = 0

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def generate_role(self):
        pass


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1, server_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = [f"127.0.0.1:{6170 + i}" for i in range(worker_num)]
        self._server_endpoints = server_endpoints or []


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-var driven: reads PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS /
    the pserver envs (and JAX_PROCESS_ID / JAX_NUM_PROCESSES, as the JAX
    package's does)."""

    def generate_role(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = eps.split(",") if eps else []
        self._server_endpoints = [
            e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e
        ]
        role = os.environ.get("TRAINING_ROLE", "TRAINER")
        if role == "PSERVER":
            self._role = Role.SERVER
            self._current_id = int(os.environ.get("PADDLE_PSERVER_ID", 0))
        else:
            self._role = Role.WORKER
            self._current_id = int(
                os.environ.get("PADDLE_TRAINER_ID", os.environ.get("JAX_PROCESS_ID", 0))
            )
        if not self._worker_endpoints:
            n = int(os.environ.get("PADDLE_TRAINERS_NUM", os.environ.get("JAX_NUM_PROCESSES", 1)))
            self._worker_endpoints = [f"127.0.0.1:{6170 + i}" for i in range(n)]


class Fleet:
    """The collective-mode fleet facade."""

    def __init__(self):
        self._role_maker: RoleMakerBase | None = None
        self._mesh = None
        self._nrings = 1

    def init(self, role_maker=None, mesh=None):
        self._role_maker = role_maker or UserDefinedRoleMaker()
        self._role_maker.generate_role()
        self._mesh = mesh

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    @property
    def worker_endpoints(self):
        return self._role_maker.get_trainer_endpoints()

    @property
    def server_endpoints(self):
        return self._role_maker.get_pserver_endpoints()

    def distributed_optimizer(self, optimizer, strategy=None):
        return CollectiveOptimizer(self, optimizer, strategy)

    def compiled_program(self, main_program=None, mesh=None):
        """A CompiledProgram under `with_collective` on the fleet's mesh."""
        from ...compiler import CompiledProgram
        from ...framework import default_main_program
        from ...parallel.mesh import make_mesh

        prog = main_program or default_main_program()
        return CompiledProgram(prog).with_collective(
            mesh=mesh or self._mesh or make_mesh()
        )

    def save_persistables(self, executor, dirname, main_program=None,
                          scope=None):
        from ... import io

        io.save_persistables(executor, dirname, main_program, scope=scope)

    def init_worker(self):
        pass

    def stop_worker(self):
        pass

    def barrier_worker(self):
        pass


class DistributedStrategy:
    """The collective mode's knobs."""

    def __init__(self):
        self.nrings = 1
        self.mode = "grad_allreduce"  # or "local_sgd"
        self.local_sgd_k = 1
        # parallel/collective.py's knobs: None defers to
        # FLAGS_allreduce_bucket_mb / the tuning DB and FLAGS_zero1
        self.allreduce_bucket_mb = None
        self.zero1 = None


class CollectiveOptimizer:
    """Wrap an Optimizer: minimize(), then transpile the program."""

    def __init__(self, fleet_obj: Fleet, inner, strategy: DistributedStrategy | None):
        self._fleet = fleet_obj
        self._inner = inner
        self._strategy = strategy or DistributedStrategy()

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        from ...framework import default_main_program, default_startup_program
        from ...parallel.collective import GradAllReduce, LocalSGD

        ops, pgs = self._inner.minimize(loss, startup_program, parameter_list, no_grad_set)
        nranks = self._fleet.worker_num()
        if self._fleet._mesh is not None:
            nranks = self._fleet._mesh.size
        if self._strategy.mode == "local_sgd":
            t = LocalSGD(self._strategy.nrings, self._strategy.local_sgd_k)
        else:
            t = GradAllReduce(self._strategy.nrings,
                              bucket_mb=self._strategy.allreduce_bucket_mb,
                              zero1=self._strategy.zero1)
        t.transpile(
            startup_program or default_startup_program(),
            loss.block.program,
            rank=self._fleet.worker_index(),
            nranks=nranks,
        )
        return ops, pgs


fleet = Fleet()
