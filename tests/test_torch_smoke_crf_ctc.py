"""chip_smoke.py's crf/ctc/quant phases rehearsed on the CPU at small sizes,
the CPU standing in for the card: crf_ctc_ops at the SRL's and CRNN's op
sizes with SRL_B = 4 and CRNN_B = 3, train_srl at depth 2, hidden 32, B =
4, train_crnn_ctc at 16 x 64, two conv groups, GRUs of 16, B = 3. Each
passes the port as it is, and each refuses a fault planted in the card's
runs only: a Viterbi path one tag on, a CTC loss and a CRF likelihood
that ignore their label lengths, a moving-average quantizer that never
moves its scale."""
import copy
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from test_torch_smoke_longtail import _card_fault  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def tiny(monkeypatch):
    for name, value in (("SRL_DEPTH", 2), ("SRL_HIDDEN", 32), ("SRL_B", 4),
                        ("SRL_STEPS", 3), ("SRL_EVAL_BATCHES", 2),
                        ("CRNN_SHAPE", (1, 16, 64)), ("CRNN_CHANNELS", (16, 32)),
                        ("CRNN_HIDDEN", 16), ("CRNN_B", 3), ("CRNN_STEPS", 2),
                        ("CRNN_EVAL", 2), ("CRNN_QAT_STEPS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)


def _viterbi_pointer_on(plain):
    """Every path tag one on (mod N) where the sequence is live."""
    def compute(ctx):
        out = plain(ctx)["ViterbiPath"]
        n = ctx.input("Emission").shape[-1]
        if ctx.has_input("Label"):
            return {"ViterbiPath": out}
        return {"ViterbiPath": torch.where(out > 0, (out + 1) % n, out)}
    return compute


def _without(slot):
    """The op run as if its `slot` input were not given (the program's op
    left as it is)."""
    def fault(plain):
        def compute(ctx):
            ctx.op = copy.copy(ctx.op)
            ctx.op.inputs = {k: v for k, v in ctx.op.inputs.items() if k != slot}
            return plain(ctx)
        return compute
    return fault


def _scale_never_moves(plain):
    def compute(ctx):
        out = plain(ctx)
        return dict(out, OutScale=ctx.input("InScale").reshape(1).clone())
    return compute


def test_crf_ctc_ops_phase_holds_the_port(tiny, capsys):
    chip_smoke.crf_ctc_ops(CPU, "CPU")
    out = capsys.readouterr().out
    assert "crf, ctc and quant ops on the card against the CPU (11 cases" in out
    assert "warpctc against F.ctc_loss" in out


@pytest.mark.parametrize("op,fault,match", [
    ("crf_decoding", _viterbi_pointer_on, "crf_decoding: o differs"),
    ("warpctc", _without("LabelLength"), "warpctc: o on the card"),
    ("fake_quantize_dequantize_moving_average_abs_max", _scale_never_moves,
     "fake_quantize_dequantize_moving_average_abs_max: s on the card")])
def test_crf_ctc_ops_phase_refuses(tiny, monkeypatch, op, fault, match):
    _card_fault(monkeypatch, op, fault)
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.crf_ctc_ops(CPU, "CPU")


def test_train_srl_phase_holds_the_port(tiny, capsys):
    assert chip_smoke.train_srl(CPU, "CPU") == {}
    out = capsys.readouterr().out
    assert "SRL (db_lstm depth 2, hidden 32" in out and "sentences/s" in out
    assert "over 2 batches" in out
    assert "chunk_eval ran 0 times on the card with 0 host syncs" in out


def test_train_srl_phase_refuses_a_crf_without_lengths(tiny, monkeypatch):
    _card_fault(monkeypatch, "linear_chain_crf", _without("Length"))
    with pytest.raises(RuntimeError, match="SRL step 1: "):
        chip_smoke.train_srl(CPU, "CPU")


def test_train_crnn_ctc_phase_holds_the_port(tiny, capsys):
    counts = chip_smoke.train_crnn_ctc(CPU, "CPU")
    assert counts and all(c == {} for c in counts)
    out = capsys.readouterr().out
    assert "CRNN-CTC (1x16x64, 95 classes + blank) step 1 at B=3" in out
    assert "images/s" in out and "sequence error rate" in out
    assert "CRNN-CTC QAT (15 fake quantizers: 8 on weights, 7 on inputs)" in out


def test_train_crnn_ctc_phase_refuses_a_ctc_without_label_lengths(tiny,
                                                                  monkeypatch):
    _card_fault(monkeypatch, "warpctc", _without("LabelLength"))
    with pytest.raises(RuntimeError, match="CRNN-CTC step 1: "):
        chip_smoke.train_crnn_ctc(CPU, "CPU")


def _kink_rows(mode, dtype):
    """A batch-norm backward's inputs whose pre-activations sit a few fp32
    units from zero at a third of the elements, so that the product-then-sum
    and the fused multiply-add round some of them to opposite sides."""
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply as K8

    g = torch.Generator().manual_seed(5)
    R, row, C = (64, 256, 16) if mode == "cr" else (512, 32, 32)
    x = 1.5 * torch.randn((R, row), generator=g) + 0.3
    dy = torch.randn((R, row), generator=g).to(dtype)
    p = (1 + 0.2 * torch.randn((C,), generator=g),
         0.2 * torch.randn((C,), generator=g),
         0.3 + 0.1 * torch.randn((C,), generator=g),
         torch.rsqrt(2.25 + torch.rand((C,), generator=g)))
    s, b, m, v = (K8.param_view(t, x, mode) for t in p)
    root = (m - b / (v * s)).expand_as(x)
    steps = torch.randint(-200, 200, x.shape, generator=g).float()
    near = torch.rand(x.shape, generator=g) < 0.3
    x = torch.where(near, root + steps * root.abs() * 2.0 ** -24, x).to(dtype)
    fused = ((x.float() - m).double() * (v * s).double()
             + b.double()).float() > 0
    return x, p, dy, fused, R * row // C


@pytest.mark.parametrize("mode,dtype", [("cr", torch.float32),
                                        ("cl", torch.float32),
                                        ("cl", torch.bfloat16)])
def test_k9_reference_takes_either_rounding_at_the_kink_only(monkeypatch, mode,
                                                            dtype):
    """K9's hold at a relu: a kernel deciding each split element by the
    fused multiply-add passes with its sums held strictly; one wrong
    decision at a pre-activation clear of zero is refused."""
    from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as KB

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    x, p, dy, fused, M = _kink_rows(mode, dtype)
    agree = chip_smoke._agree16 if dtype == torch.bfloat16 else chip_smoke._agree
    for count in (None, M):
        got = KB.bn_apply_act_backward_plain(x, *p, dy * fused, "identity",
                                             None, mode, count)
        ref, n_split, n_fused = chip_smoke._k9_reference(
            "fused", got, x, p, dy, "relu", None, mode, count)
        assert n_fused == n_split and (n_split > 0 or dtype != torch.float32)
        agree("fused", got[0], ref[0])
        for o, r in zip(got[2:], ref[2:]):
            chip_smoke._sums_agree("sums", o, r)
        wrong = dy.clone()
        wrong[tuple((x.float() > 4.0).nonzero()[0].tolist())] = 0
        bad = KB.bn_apply_act_backward_plain(x, *p, wrong * fused, "identity",
                                             None, mode, count)
        ref = chip_smoke._k9_reference("bad", bad, x, p, dy, "relu", None,
                                       mode, count)[0]
        with pytest.raises(RuntimeError, match="disagrees"):
            agree("bad", bad[0], ref[0])
