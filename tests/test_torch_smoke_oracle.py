"""chip_smoke.py's ResNet-50 AMP step-1 gate, run on the CPU at a small
size: the port's bf16 step (the kernels' plain versions) against the
script's plain-torch oracles, which take each layer's input from the port.

The gate must pass the port as it is and refuse it with a fault planted in
one kernel's plain version: the batch-norm apply (K8) forward output off
by 0.3 at one element in 5000 of one layer, or its backward (K9) dx
scaled by 1.5 in one layer. The sizes are cut to B=4 at 64x64 (the script runs
B=128 at 224x224 on the card); the limits are the script's own.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import paddle_tpu_torch.executor as executor  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import bn_apply as k8  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as k9  # noqa: E402


@pytest.fixture
def cpu_smoke(monkeypatch):
    """chip_smoke's ResNet-50 AMP phase on the CPU: the device calls it
    makes around the step become no-ops, the executor's default device the
    CPU, the launch check the launches the program's ops imply."""
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    resolve = executor.resolve_device
    monkeypatch.setattr(executor, "resolve_device", lambda d=None: torch.device(
        "cpu") if d is None else resolve(d))
    monkeypatch.setattr(chip_smoke, "_check_launches",
                        lambda prog, what: chip_smoke._expected_launches(prog))
    for name, value in (("AMP_B", 4), ("RN_HW", 64), ("RN_STEPS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    return monkeypatch


def _plant_k8(monkeypatch):
    plain, seen = k8.bn_apply_act_plain, []

    def faulty(x2, *args, **kw):
        y = plain(x2, *args, **kw)
        if x2.shape[-1] == 512 and not seen:     # the first layer this wide
            seen.append(1)
            y.view(-1)[::5000] += 0.3
        return y
    monkeypatch.setattr(k8, "bn_apply_act_plain", faulty)


def _plant_k9(monkeypatch):
    plain = k9.bn_apply_act_backward_plain

    def faulty(x2, *args, **kw):
        dx, dres, p1, p2 = plain(x2, *args, **kw)
        chain = args[8] if len(args) > 8 else kw.get("chain")
        if x2.shape[-1] == 2048 and chain is not None:
            dx = (1.5 * dx.float()).to(dx.dtype)
        return dx, dres, p1, p2
    monkeypatch.setattr(k9, "bn_apply_act_backward_plain", faulty)


@pytest.mark.parametrize("plant", [None, "k8", "k9"])
def test_resnet50_amp_gate_holds_the_port_and_refuses_a_planted_fault(
        cpu_smoke, plant):
    if plant == "k8":
        _plant_k8(cpu_smoke)
    elif plant == "k9":
        _plant_k9(cpu_smoke)
    run = lambda: chip_smoke.train_resnet_amp(torch.device("cpu"), "CPU")  # noqa: E731
    if plant is None:
        _, counts = run()
        assert counts["bn_apply_act_backward"] == {"bfloat16": 106}
    else:
        with pytest.raises(RuntimeError, match={
                "k8": "relu outputs against the bf16 oracle",
                "k9": "gradients beyond their limits"}[plant]):
            run()
