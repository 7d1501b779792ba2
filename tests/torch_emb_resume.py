"""Kill-and-resume trainer for the port's tiered embeddings (the port's
counterpart of tests/dist_emb_resume.py): a 512-row table behind a
256-slot cache trains with a CheckpointManager save after every step,
whose saves stream base + dirty-row deltas through the manifest. With
KILL_AT >= 0 the process SIGKILLs itself right after recording that step;
a fresh invocation restores the latest checkpoint (base + delta, the cache
cold), and must reproduce the remaining loss trajectory bit for bit.

usage: torch_emb_resume.py CKPT_ROOT LOSSES_FILE TOTAL_STEPS KILL_AT
"""
import os
import signal
import sys

import numpy as np

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags
from paddle_tpu_torch import layers as L
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.resilience import CheckpointManager

VOCAB, DIM, FIELDS, BATCH = 512, 8, 6, 32

flags.set_flags({"emb_hbm_budget_mb": 0.001, "emb_cache_slots": 256,
                 "emb_ckpt_base_every": 3})


def build():
    ids = L.data(name="ids", shape=[FIELDS], dtype="int64")
    label = L.data(name="label", shape=[1], dtype="float32")
    emb = L.embedding(ids, size=[VOCAB, DIM], is_sparse=True,
                      param_attr=ParamAttr(name="tbl"))
    s = L.reduce_sum(emb, dim=1)
    logit = L.fc(s, size=1, param_attr=ParamAttr(name="w_out"),
                 bias_attr=ParamAttr(name="b_out"))
    return L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))


def feed_fn(step):
    rng = np.random.default_rng(1000 + step)
    return {"ids": rng.integers(0, VOCAB, (BATCH, FIELDS)).astype(np.int64),
            "label": rng.integers(0, 2, (BATCH, 1)).astype(np.float32)}


def main():
    root, losses_path, total_steps, kill_at = (
        sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    main_p, startup = pt.Program(), pt.Program()
    main_p.random_seed = startup.random_seed = 7
    with pt.program_guard(main_p, startup), pt.unique_name.guard():
        loss = build()
        pt.optimizer.SGD(0.1).minimize(loss)

    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    mgr = CheckpointManager(root, keep_last_k=3, main_program=main_p,
                            scope=scope)
    last = mgr.restore(executor=exe)
    start = 0 if last is None else last + 1
    with open(losses_path, "a") as f:
        for step in range(start, total_steps):
            (lv,) = exe.run(main_p, feed=feed_fn(step), fetch_list=[loss],
                            scope=scope)
            mgr.save(step, executor=exe)
            f.write(f"{step} {float(np.asarray(lv).reshape(-1)[0]):.17g}\n")
            f.flush()
            os.fsync(f.fileno())
            if step == kill_at:
                os.kill(os.getpid(), signal.SIGKILL)
    print(f"done start={start}")


if __name__ == "__main__":
    main()
