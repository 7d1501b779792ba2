"""Multi-process bootstrap: the launcher's env contract and
`torch.distributed.init_process_group`.

The JAX package joins the PjRt coordination service; the port makes one
process group over TCP rendezvous at the coordinator's address. The env
contract is the JAX package's (`python -m paddle_tpu_torch.distributed
.launch` sets it):

    PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM   rank / world size
    PADDLE_COORDINATOR                        rendezvous host:port
    PADDLE_DIST_BACKEND                       "nccl" or "gloo"
    PADDLE_LOCAL_RANK / PADDLE_NPROC_PER_NODE this node's ranks (launcher)

The backend is the caller's: `backend=`, else the env's, else nccl for a
CUDA device and gloo for the CPU. Nothing switches it afterwards. NCCL
cannot run two ranks on one device, so asking for nccl with more ranks on
a node than it has CUDA devices raises here, before NCCL would; two ranks
sharing one card run over gloo (`--backend gloo`), whose collectives stage
CUDA tensors through host memory (ops/collective_ops.py).
"""
from __future__ import annotations

import atexit
import os
import socket

__all__ = ["ParallelEnv", "init_parallel_env"]


class ParallelEnv:
    """Rank and world size: the process group's where there is one, else
    as the launcher's env contract gives them."""

    def __init__(self):
        import torch.distributed as dist

        self.nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.local_rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        if dist.is_available() and dist.is_initialized():
            self.nranks, self.local_rank = (dist.get_world_size(),
                                            dist.get_rank())
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints = eps.split(",") if eps else []

    @property
    def rank(self):
        return self.local_rank

    @property
    def world_size(self):
        return self.nranks


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _destroy_at_exit() -> None:
    """Tear the group down before the interpreter's own shutdown does.
    Left to it, a gloo group's threads can be destroyed while they still
    run, which aborts the process ("terminate called without an active
    exception") after its work succeeded. The collection frees the
    objects that still hold the group's store."""
    import gc

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def init_parallel_env(coordinator: str | None = None,
                      num_processes: int | None = None,
                      process_id: int | None = None,
                      backend: str | None = None,
                      device=None) -> ParallelEnv:
    """Make this process's group: rank `process_id` of `num_processes`,
    rendezvous at `coordinator` (host:port), over `backend`. Omitted
    arguments come from the env contract; a world of one with no
    coordinator rendezvouses on a free local port. `device` is the rank's
    device (CUDA unless the caller names the CPU): an nccl rank is bound to
    CUDA device PADDLE_LOCAL_RANK. Returns the ParallelEnv; a second call
    in a process that has a group returns it unchanged. The group is
    destroyed at exit if the caller has not destroyed it."""
    import torch
    import torch.distributed as dist

    from ..executor import resolve_device

    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("PADDLE_TRAINERS_NUM", "1"))
    if process_id is None:
        process_id = int(env.get("PADDLE_TRAINER_ID", "0"))
    coordinator = coordinator or env.get("PADDLE_COORDINATOR", "")
    dev = resolve_device(device)
    backend = (backend or env.get("PADDLE_DIST_BACKEND")
               or ("nccl" if dev.type == "cuda" else "gloo")).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend '{backend}': the port runs over 'nccl' "
                         f"or 'gloo'")
    if dist.is_initialized():
        return ParallelEnv()
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"backend 'nccl' carries CUDA tensors; this "
                             f"rank's device is {dev}: pass backend='gloo'")
        local_rank = int(env.get("PADDLE_LOCAL_RANK", process_id))
        per_node = int(env.get("PADDLE_NPROC_PER_NODE", num_processes))
        cards = torch.cuda.device_count()
        if per_node > cards:
            raise ValueError(
                f"backend 'nccl' with {per_node} ranks on a node of {cards} "
                f"CUDA device(s): NCCL cannot run two ranks on one device. "
                f"Run them over gloo (launch --backend gloo), or on a "
                f"machine with a device a rank")
        torch.cuda.set_device(local_rank)
    if not coordinator:
        if num_processes > 1:
            raise ValueError(
                "init_parallel_env: no coordinator address — pass one or run "
                "under `python -m paddle_tpu_torch.distributed.launch`")
        coordinator = f"127.0.0.1:{_free_port()}"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)
    atexit.unregister(_destroy_at_exit)
    atexit.register(_destroy_at_exit)
    return ParallelEnv()
