"""chip_smoke.py's dataset-reader, numeric-guard and checkpointed-runner
phases rehearsed on the CPU at small sizes: book_readers (8 steps of
batch 16 a path; the PTB-format corpus at its full size), guard_resnet_amp and
runner_resnet_amp over a small network (fc, batch norm, fc at 3x8x8, B=4)
in place of ResNet-50, one step a timing window, the DeepFM sub-check at
vocab 2000 with a 16-wide tower, 2 files of 512 lines, batch 64. Each
must pass the port as it is; the guard's DeepFM sub-check must refuse a
sentinel that gates by multiplying with 0 (a NaN survives it) and the
runner phase a restore that leaves the state as it was."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

CPU = torch.device("cpu")
SHAPE = (3, 8, 8)


def _tiny(pt):
    """A small AMP network in ResNet-50's place: fc, batch norm with relu,
    fc and the softmax cross entropy (the kernels' plain versions)."""
    L = pt.layers
    img = L.data(name="img", shape=list(SHAPE), dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    h = L.batch_norm(L.fc(img, size=32), act="relu")
    return L.mean(L.softmax_with_cross_entropy(L.fc(h, size=10), label))


@pytest.fixture
def smoke_dir(tmp_path, monkeypatch):
    for name, value in (("SMOKE_DATA", str(tmp_path)), ("GUARD_TIMED", 1),
                        ("CTR_LINES", 512), ("CTR_B", 64)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "DFM_CFG", dict(
        chip_smoke.DFM_CFG, vocab_size=2000, hidden_sizes=(16, 16, 16)))
    return tmp_path


def test_book_readers_feed_the_book_models(smoke_dir, capsys, monkeypatch):
    for name in ("MNIST_B", "CIFAR_B", "W2V_B"):
        monkeypatch.setattr(chip_smoke, name, 16)
    assert chip_smoke.book_readers(CPU, "CPU", steps=8) == [{}, {}, {}]
    out = capsys.readouterr().out
    assert "imikolov synthetic False" in out
    assert out.count("samples/s end to end") == 3
    assert not list(smoke_dir.iterdir())          # the DATA_HOME is gone


def test_guard_phase_holds_the_port(smoke_dir, capsys):
    counts = chip_smoke.guard_resnet_amp(CPU, "CPU", build=_tiny,
                                         shape=SHAPE, B=4, classes=10)
    assert counts == ({}, {})
    out = capsys.readouterr().out
    assert "raised GuardError" in out and "skips ['nonfinite', 'loss_spike']" \
        in out
    assert "left all" in out and "live vars bit for bit" in out


def test_guard_phase_refuses_a_gate_that_keeps_nan(smoke_dir, monkeypatch):
    """A sentinel gating by 0 * g leaves a NaN step's NaN gradients in. In
    the AMP step AMP's own found-inf skip zeroes them first; the DeepFM
    sub-check (fp32, SelectedRows grads) sees its parameters move."""
    from paddle_tpu_torch.core.selected_rows import (SelectedRows,
                                                     is_selected_rows)
    from paddle_tpu_torch.ops import registry

    d = registry.get_op_def("health_sentinel")
    plain = d.compute

    def faulty(ctx):
        out = plain(ctx)
        keep = (out["Health"][3] == 0).float()
        out["Out"] = [SelectedRows(x.rows, x.values * keep, x.height)
                      if is_selected_rows(x) else x * keep
                      for x in ctx.inputs("X")]
        return out

    monkeypatch.setattr(d, "compute", faulty)
    with pytest.raises(RuntimeError, match="DeepFM NaN step"):
        chip_smoke._guard_deepfm(CPU, "CPU")


def test_runner_phase_holds_the_port(smoke_dir, capsys):
    assert chip_smoke.runner_resnet_amp(CPU, "CPU", build=_tiny, shape=SHAPE,
                                        B=4, classes=10) == {}
    out = capsys.readouterr().out
    assert "agree bit for bit, so must the faulted: held" in out


def test_runner_phase_refuses_a_restore_that_restores_nothing(smoke_dir,
                                                              monkeypatch):
    from paddle_tpu_torch.resilience import checkpoint

    restore = checkpoint.CheckpointManager.restore

    def stale(self, *a, **k):
        step = restore(self, *a, **k)
        return step if step is None else step + 1   # resume past the state

    monkeypatch.setattr(checkpoint.CheckpointManager, "restore", stale)
    with pytest.raises(RuntimeError, match="faulted losses"):
        chip_smoke.runner_resnet_amp(CPU, "CPU", build=_tiny, shape=SHAPE,
                                     B=4, classes=10)
