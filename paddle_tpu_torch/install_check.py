"""Post-install smoke check (the JAX package's install_check.py, after the
reference's install_check.py run_check): build a tiny two-fc regression
program, train two steps on the device, and print the reference's success
message; raise with a pointed hint on failure.

    python -m paddle_tpu_torch.install_check

The device is CUDA unless the caller names the CPU (`run_check("cpu")`).
With more than one CUDA device visible the JAX package repeats the run
data-parallel through CompiledProgram; the port has no CompiledProgram
yet, so there the check raises.
"""
from __future__ import annotations

import numpy as np

__all__ = ["run_check"]


def _train_tiny(device) -> float:
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = layers.data(name="inp", shape=[2], dtype="float32")
        hidden = layers.fc(x, size=4)
        out = layers.fc(hidden, size=1)
        loss = layers.mean(layers.square(out))
        pt.optimizer.SGD(learning_rate=0.01).minimize(loss)
    exe, scope = pt.Executor(place=device), pt.Scope()
    rng = np.random.default_rng(0)
    exe.run(startup, scope=scope)
    for _ in range(2):
        (lv,) = exe.run(
            main, feed={"inp": rng.standard_normal((8, 2)).astype(np.float32)},
            fetch_list=[loss], scope=scope)
    return float(np.asarray(lv).reshape(-1)[0])


def run_check(device=None):
    """Train the tiny program on `device` (CUDA when None) and report."""
    import torch

    from .executor import resolve_device

    dev = resolve_device(device)
    print("Running verify paddle_tpu_torch program ... ")
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} CUDA devices: the data-parallel "
            f"check needs CompiledProgram, which the port has not yet "
            f"(ROADMAP Queue 1, \"parallel and distributed\")")
    lv = _train_tiny(dev)
    if not np.isfinite(lv):
        raise RuntimeError(
            f"the single-device check on {dev} gave a non-finite loss: check "
            f"the PyTorch build and the CUDA installation")
    print("Your paddle_tpu_torch works well on SINGLE device.")
    print("Your paddle_tpu_torch is installed successfully!")


if __name__ == "__main__":
    run_check()
