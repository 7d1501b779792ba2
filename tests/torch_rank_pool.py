"""A pool of spawned CPU ranks over gloo, for the port's multi-rank tests.

`RankPool(n)` starts n processes with the `spawn` start method, each with
one torch thread. `pool.run(world, fn, *args)` runs the module-level
function `fn` on ranks 0..world-1 of a gloo group of `world` ranks (made
through `paddle_tpu_torch.distributed.init_parallel_env`, again only when
the world changes) and returns their results in rank order. Every wait on
a rank has a timeout: past it, or when a rank raises, the pool is killed
(the next `run` starts a fresh one) and the test fails with the ranks'
tracebacks, so a hung collective costs one test, not the suite's clock.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(rank, tasks, results):
    import torch

    torch.set_num_threads(1)
    world = None
    while True:
        item = tasks.get()
        if item is None:
            return
        want, port, fn, args = item
        try:
            import torch.distributed as dist

            if (want, port) != world or (rank < want and
                                         not dist.is_initialized()):
                if dist.is_initialized():
                    dist.destroy_process_group()
                if rank < want:
                    from paddle_tpu_torch.distributed import init_parallel_env

                    init_parallel_env(coordinator=f"127.0.0.1:{port}",
                                      num_processes=want, process_id=rank,
                                      backend="gloo", device="cpu")
                world = (want, port)
            val = fn(*args) if rank < want else None
            results.put((rank, True, val))
        except BaseException:  # noqa: BLE001 - reported to the parent
            results.put((rank, False, traceback.format_exc()))


class RankPool:
    def __init__(self, n: int, timeout: float = 60.0):
        self.n, self.timeout = n, timeout
        self._procs = []
        self._world = None

    def _start(self):
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_worker,
                                   args=(r, self._tasks[r], self._results),
                                   daemon=True) for r in range(self.n)]
        for p in self._procs:
            p.start()
        self._world = None

    def run(self, world: int, fn, *args, timeout: float | None = None):
        if not self._procs:
            self._start()
        if self._world is None or self._world[0] != world:
            self._world = (world, _free_port())
        for q in self._tasks:
            q.put((world, self._world[1], fn, args))
        out, errors = [None] * self.n, []
        deadline = time.time() + (timeout or self.timeout)
        for _ in range(self.n):
            try:
                rank, ok, val = self._results.get(
                    timeout=max(0.1, deadline - time.time()))
            except queue.Empty:
                self.close()
                if errors:
                    break
                pytest.fail(f"{fn.__name__} on {world} ranks: no answer "
                            f"within {timeout or self.timeout} s; the pool "
                            f"was killed", pytrace=False)
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                # the other ranks may wait in a collective that will never
                # complete: give them a moment to fail too, no more
                deadline = min(deadline, time.time() + 3.0)
        if errors:
            self.close()
            raise AssertionError("\n".join(errors))
        return out[:world]

    def close(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(5)
        self._procs = []
        self._world = None
