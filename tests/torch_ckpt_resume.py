"""Kill-and-resume trainer for the port's CheckpointedRunner (the port's
counterpart of tests/dist_ckpt_resume.py): the MNIST-style MLP trains
under the runner with a checkpoint after every step, appending one
"step loss" line a step to a trajectory file. With KILL_AT >= 0 the
process SIGKILLs itself right after recording that step; a fresh
invocation on the same checkpoint root resumes from latest_step() and must
reproduce the remaining trajectory bit for bit.

usage: torch_ckpt_resume.py CKPT_ROOT LOSSES_FILE TOTAL_STEPS KILL_AT
       (KILL_AT = -1: run to completion)
"""
import os
import signal
import sys

import numpy as np

import paddle_tpu_torch as pt
from paddle_tpu_torch import layers as L
from paddle_tpu_torch.resilience import CheckpointManager, CheckpointedRunner


def build():
    img = L.data(name="img", shape=[64], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    h = L.fc(img, size=32, act="relu")
    logits = L.fc(h, size=10)
    return L.mean(L.softmax_with_cross_entropy(logits, label))


def feed_fn(step):
    # pure in the step index: a resumed process makes the batches the dead
    # one saw
    rng = np.random.default_rng(1000 + step)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    w = np.random.default_rng(77).standard_normal((64, 10)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int64)[:, None]
    return {"img": x, "label": y}


def main():
    root, losses_path, total_steps, kill_at = (
        sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    main_p, startup = pt.Program(), pt.Program()
    main_p.random_seed = startup.random_seed = 7
    with pt.program_guard(main_p, startup), pt.unique_name.guard():
        loss = build()
        pt.optimizer.SGD(0.1).minimize(loss)

    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)  # a resume() overwrites this init
    runner = CheckpointedRunner(
        exe, CheckpointManager(root, keep_last_k=3, main_program=main_p,
                               scope=scope),
        save_every=1, max_retries=5)

    f = open(losses_path, "a")

    def on_step(step, outs):
        f.write(f"{step} {float(np.asarray(outs[0]).reshape(-1)[0]):.17g}\n")
        f.flush()
        os.fsync(f.fileno())
        if step == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)  # preemption, uncatchable

    out = runner.run(feed_fn, total_steps, fetch_list=[loss],
                     on_step=on_step)
    f.close()
    print(f"done start={out['start_step']} retries={out['retries']}")


if __name__ == "__main__":
    main()
