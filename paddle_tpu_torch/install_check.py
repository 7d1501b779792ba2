"""Post-install smoke check (the JAX package's install_check.py, after the
reference's install_check.py run_check): build a tiny two-fc regression
program, train two steps on the device, and print the reference's success
message; raise with a pointed hint on failure.

    python -m paddle_tpu_torch.install_check

The device is CUDA unless the caller names the CPU (`run_check("cpu")`).
In a process group of more than one rank (distributed.init_parallel_env,
e.g. under `python -m paddle_tpu_torch.distributed.launch`) the check
repeats the run data-parallel through `CompiledProgram.with_data_parallel`
over every rank, each feeding its rows of the batch, and holds the loss to
the one-device run's on the whole batch.
"""
from __future__ import annotations

import numpy as np

__all__ = ["run_check"]

_B = 8   # rows a rank


def _train_tiny(device, world: int = 1, parallel: bool = False) -> float:
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 1
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = layers.data(name="inp", shape=[2], dtype="float32")
        hidden = layers.fc(x, size=4)
        out = layers.fc(hidden, size=1)
        loss = layers.mean(layers.square(out))
        pt.optimizer.SGD(learning_rate=0.01).minimize(loss)
    exe, scope = pt.Executor(place=device), pt.Scope()
    rng = np.random.default_rng(0)
    exe.run(startup, scope=scope)
    prog = main
    if parallel:
        prog = pt.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    for _ in range(2):
        batch = rng.standard_normal((_B * world, 2)).astype(np.float32)
        if parallel:
            batch = prog._mesh.shard_rows(batch)
        (lv,) = exe.run(prog, feed={"inp": batch}, fetch_list=[loss],
                        scope=scope)
    return float(np.asarray(lv).reshape(-1)[0])


def run_check(device=None):
    """Train the tiny program on `device` (CUDA when None) and report; in a
    process group of several ranks, also data-parallel over them."""
    from .executor import resolve_device
    from .parallel.mesh import world

    dev = resolve_device(device)
    print("Running verify paddle_tpu_torch program ... ")
    _, n = world()
    lv = _train_tiny(dev, n)
    if not np.isfinite(lv):
        raise RuntimeError(
            f"the single-device check on {dev} gave a non-finite loss: check "
            f"the PyTorch build and the CUDA installation")
    if n > 1:
        dp = _train_tiny(dev, n, parallel=True)
        if not np.isfinite(dp) or abs(dp - lv) > 1e-4 * max(1.0, abs(lv)):
            raise RuntimeError(
                f"the data-parallel check over {n} ranks gave loss {dp}, the "
                f"one-device run {lv}: check the process group's backend")
        print(f"Your paddle_tpu_torch works well on MUTIPLE {n} ranks.")
    else:
        print("Your paddle_tpu_torch works well on SINGLE device.")
    print("Your paddle_tpu_torch is installed successfully!")


if __name__ == "__main__":
    run_check()
