"""Fleet parameter-server mode: its role views, and a
`distributed_optimizer` that raises until the PS stack is ported (the JAX
package's fleet/parameter_server.py rides its DistributeTranspiler and
host RPC service, neither of which the port has)."""
from __future__ import annotations

from .base import PaddleCloudRoleMaker, RoleMakerBase

__all__ = ["fleet", "ParameterServerFleet"]

_NOT_PORTED = ("fleet parameter-server mode needs the PS stack "
               "(DistributeTranspiler, the pserver RPC service), not ported "
               "yet (ROADMAP Queue 1, \"parallel and distributed\": the PS "
               "stack); use the collective fleet (incubate.fleet.fleet)")


class ParameterServerFleet:
    def __init__(self):
        self._role_maker: RoleMakerBase | None = None

    def init(self, role_maker=None):
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker.generate_role()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def server_index(self):
        return self._role_maker.server_index()

    @property
    def server_endpoints(self):
        return self._role_maker.get_pserver_endpoints()

    def distributed_optimizer(self, optimizer, strategy=None):
        raise NotImplementedError(_NOT_PORTED)

    def init_server(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)

    def run_server(self):
        raise NotImplementedError(_NOT_PORTED)

    def init_worker(self):
        raise NotImplementedError(_NOT_PORTED)


fleet = ParameterServerFleet()
