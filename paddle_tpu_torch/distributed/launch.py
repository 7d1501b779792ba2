"""`python -m paddle_tpu_torch.distributed.launch` — the collective
launcher: one process a rank on this node.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \\
        --backend=gloo [--log_dir=log] [--timeout=600] train.py --args

Each rank is a fresh interpreter (nothing forked from the launcher) with
the env contract of distributed/parallel.py: PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_COORDINATOR, PADDLE_TRAINER_ENDPOINTS,
PADDLE_CURRENT_ENDPOINT, PADDLE_LOCAL_RANK, PADDLE_NPROC_PER_NODE and,
with --backend, PADDLE_DIST_BACKEND; the script calls
`paddle_tpu_torch.distributed.init_parallel_env()` before its first
collective. Two ranks on one GPU need `--backend gloo`: NCCL refuses them.
When a rank exits non-zero the launcher stops the others and returns its
code; past --timeout seconds it kills every rank and returns 124. The
parameter-server launcher (--server_num / --worker_num) raises: the PS
stack is not ported yet.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from .parallel import _free_port

__all__ = ["launch", "launch_ps", "main"]


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a multi-process collective job")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="ranks to start on this node")
    p.add_argument("--node_ip", default="127.0.0.1", help="this node's IP")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous host:port (default: node_ip with a "
                        "free port)")
    p.add_argument("--started_port", type=int, default=None,
                   help="base port for PADDLE_TRAINER_ENDPOINTS")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's backend (default: nccl on "
                        "CUDA, gloo on the CPU)")
    p.add_argument("--log_dir", default=None,
                   help="write each rank's output to LOG_DIR/workerlog.N")
    p.add_argument("--timeout", type=float, default=0.0,
                   help="kill every rank after this many seconds (0: no "
                        "limit)")
    p.add_argument("--server_num", type=int, default=0,
                   help="parameter-server mode (not ported)")
    p.add_argument("--worker_num", type=int, default=0,
                   help="parameter-server mode (not ported)")
    p.add_argument("training_script", help="the script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch_ps(args) -> int:
    """The parameter-server launcher of the JAX package (launch.py:80)."""
    raise NotImplementedError(
        "the parameter-server launcher (--server_num / --worker_num) needs "
        "the PS stack, not ported yet (ROADMAP Queue 1, \"parallel and "
        "distributed\": the PS stack)")


def _stop(procs, alive, grace=10.0):
    for j in alive:
        if procs[j].poll() is None:
            procs[j].send_signal(signal.SIGTERM)
    deadline = time.time() + grace
    for j in alive:
        try:
            procs[j].wait(max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            procs[j].kill()
            procs[j].wait()


def launch(args) -> int:
    """Start the ranks and wait for them; returns 0, the first failed
    rank's exit code, or 124 past the timeout."""
    if args.server_num or args.worker_num:
        return launch_ps(args)
    n = args.nproc_per_node
    coordinator = args.coordinator or f"{args.node_ip}:{_free_port()}"
    base_port = args.started_port or _free_port()
    endpoints = [f"{args.node_ip}:{base_port + i}" for i in range(n)]
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    procs, logs = [], []
    try:
        for rank in range(n):
            env = dict(os.environ)
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(n),
                "PADDLE_COORDINATOR": coordinator,
                "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
                "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
                "PADDLE_LOCAL_RANK": str(rank),
                "PADDLE_NPROC_PER_NODE": str(n),
                "TRAINING_ROLE": "TRAINER",
            })
            if args.backend:
                env["PADDLE_DIST_BACKEND"] = args.backend
            out = None
            if args.log_dir:
                out = open(os.path.join(args.log_dir, f"workerlog.{rank}"),
                           "w")
                logs.append(out)
            cmd = [sys.executable, "-u", args.training_script,
                   *args.training_script_args]
            procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                          stderr=out))
        rc = 0
        alive = set(range(n))
        t0 = time.time()
        while alive:
            for i in list(alive):
                r = procs[i].poll()
                if r is None:
                    continue
                alive.discard(i)
                if r != 0:
                    # the job's step can never complete: stop the rest
                    print(f"launch: rank {i} exited {r}; stopping the "
                          f"others", file=sys.stderr, flush=True)
                    rc = r
                    _stop(procs, alive)
                    alive.clear()
                    break
            if alive and args.timeout and time.time() - t0 > args.timeout:
                rc = 124
                _stop(procs, alive, grace=2.0)
                alive.clear()
            time.sleep(0.05)
        return rc
    finally:
        _stop(procs, range(len(procs)), grace=2.0)
        for f in logs:
            f.close()


def main(argv=None):
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    sys.exit(launch(args))


if __name__ == "__main__":
    main()
