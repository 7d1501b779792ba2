"""chip_smoke.py's pipeline_bert phase rehearsed on the CPU at bert_tiny's
widths (B=8, S=16, the cut after encoder layer 1 of 2): GPipe and 1F1B in
lockstep, bit for bit but the not-repeatable embeddings, 1F1B's step 1
against the unpipelined step, the stash bound and the bubble account, with
the device calls around each step made no-ops and the launch checks
expecting none (the plain versions launch nothing). A pipeline that
feeds every microbatch the first one's rows is refused by the hold
against the unpipelined step.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from paddle_tpu_torch.models import transformer  # noqa: E402
from paddle_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


@pytest.fixture
def cpu_pipeline(monkeypatch):
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    for name, value in (("AMP_B", 8), ("AMP_S", 16), ("PIPE_CUT", 1),
                        ("_expected_launches", lambda program: {})):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "_bert_cfg",
                        lambda S, flash=False: transformer.TransformerConfig(
                            vocab_size=1024, hidden_size=64, num_layers=2,
                            num_heads=4, ffn_size=128, max_position=64,
                            dropout=0.0, use_tp=False))


def test_pipeline_bert_holds_on_the_cpu(cpu_pipeline, capsys):
    counts = chip_smoke.pipeline_bert(torch.device("cpu"), "cpu")
    assert len(counts) == 3
    out = capsys.readouterr().out
    assert "GPipe and 1F1B bit for bit" in out
    assert "last_peak_stash 1F1B 2" in out and "GPipe 4" in out


def test_pipeline_bert_refuses_a_feed_split_bug(cpu_pipeline, monkeypatch):
    """Every microbatch fed the first one's rows: the schedules still agree
    with each other, and the hold against the unpipelined step refuses."""
    real = tpipe._split
    monkeypatch.setattr(tpipe, "_split", lambda val, M, name: [
        real(val, M, name)[0]] * M)
    with pytest.raises(RuntimeError, match="from the unpipelined loss"):
        chip_smoke.pipeline_bert(torch.device("cpu"), "cpu")
