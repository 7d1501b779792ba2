"""chip_smoke.py's ResNet-50 AMP step-1 gate, run on the CPU at a small
size: the port's bf16 step (the kernels' plain versions) against the
script's plain-torch oracles, which take each layer's input from the port;
and its long-context BERT AMP gate (K10/K11) at bert_tiny's widths, which
must refuse a K11 dQ scaled by 1.5 in one layer.

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
        dx, dres, *sums = plain(x2, *args, **kw)
        count = args[8] if len(args) > 8 else kw.get("count")
        if x2.shape[-1] == 2048 and count is not None:    # the training mode
            dx = (1.5 * dx.float()).to(dx.dtype)
        return (dx, dres, *sums)
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
        assert counts["bn_apply_act_backward"] == {"bfloat16": 53}
    else:
        with pytest.raises(RuntimeError, match={
                "k8": "relu outputs against the bf16 oracle",
                "k9": "gradients beyond their limits"}[plant]):
            run()


# bert_tiny's widths in place of BERT-base's (vocab 1024, hidden 64, 2
# layers of 4 heads of 16): the script's long-context AMP phase at B=2,
# S=640, through K10/K11's plain versions
BERT_TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                 ffn_size=128, max_position=512, dropout=0.0, use_tp=False)


def _plant_k11(monkeypatch):
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention_bwd as k11

    plain, seen = k11.flash_attention_backward_plain, []

    def faulty(*args, **kw):
        dq, dk, dv = plain(*args, **kw)
        if not seen:                      # the last layer's backward
            seen.append(1)
            dq = (1.5 * dq.float()).to(dq.dtype)
        return dq, dk, dv
    monkeypatch.setattr(k11, "flash_attention_backward_plain", faulty)


@pytest.mark.parametrize("plant", [None, "k11"])
def test_long_context_amp_gate_holds_the_port_and_refuses_a_planted_fault(
        cpu_smoke, plant):
    """The long-context AMP phase (train_bert_amp with flash) on the CPU:
    the port passes with launches by dtype as the program says (K10 and
    K11 once a layer, bf16), and a K11 whose dQ is scaled by 1.5 in one
    layer is refused by the gradient gate."""
    cpu_smoke.setattr(chip_smoke, "BERT_BASE", BERT_TINY)
    if plant:
        _plant_k11(cpu_smoke)
    run = lambda: chip_smoke.train_bert_amp(  # noqa: E731
        torch.device("cpu"), "CPU", 2, 640, flash=True)
    if plant is None:
        _, counts = run()
        assert counts["flash_attention_fwd"] == {"bfloat16": 2}
        assert counts["flash_attention_backward"] == {"bfloat16": 2}
        assert "causal_prefill_attention" not in counts
    else:
        with pytest.raises(RuntimeError, match="gradients beyond their limits"):
            run()
