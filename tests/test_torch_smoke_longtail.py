"""chip_smoke.py's long-tail, MobileNetV3 and recommender phases rehearsed
on the CPU at small sizes, the CPU standing in for the card: longtail_ops
at a few elements an op, train_mobilenet_v3 at x0.35 width, 32 x 32, the
first four bnecks and 10 classes, book_recommender on the movielens
reader's synthetic fallback. Each passes the port as it is, and each
refuses a fault planted in the card's runs only: hard_swish with its
offset at 2, hash with an arithmetic shift of the 64-bit word (ids past
2^31 change bucket), unique in sorted order, cos_sim without its norms."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(act=(2, 3, 4, 4), red=(2, 6, 3, 3), bert=(2, 4, 8, 50),
            mlm_rows=6, ctr=(16, 3), kl=(4, 10), seg=(2, 4, 8),
            gn=(2, 64, 3, 3), inorm=(1, 4, 4, 4), prelu=(2, 3, 4, 4),
            sn=(4, 3, 2, 2), tree=(2, 7, 4, 3), hs=(8, 5, 40),
            face=(6, 4, 9), gnd=(3, 5), nce=(16, 5, 300),
            sampled=(8, 200, 40), draws=(6000, 8))


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "LT_DIMS", TINY)
    for name, value in (("MBV3_HOLD_B", 4), ("MBV3_B", 8), ("MBV3_HW", 32),
                        ("MBV3_SCALE", 0.35), ("MBV3_CLASSES", 10),
                        ("MBV3_BNECKS", chip_smoke.MBV3_LARGE[:4]),
                        ("MBV3_STEPS", 3), ("MBV3_LR", 0.05)):
        monkeypatch.setattr(chip_smoke, name, value)


def _card_fault(monkeypatch, op_type, fault):
    """Run `op_type` through `fault(plain compute)` in the executors placed
    on a torch.device (the phases' card), the plain compute elsewhere."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import registry

    d = registry.get_op_def(op_type)
    plain, base = d.compute, pt.Executor

    class CardExecutor(base):
        def run(self, *args, **kwargs):
            if not isinstance(self._place_arg, torch.device):
                return super().run(*args, **kwargs)
            d.compute = fault(plain)
            try:
                return super().run(*args, **kwargs)
            finally:
                d.compute = plain

        def __init__(self, place=None, **kwargs):
            super().__init__(place=place, **kwargs)
            self._place_arg = place

    monkeypatch.setattr(pt, "Executor", CardExecutor)


def _hard_swish_offset_2(plain):
    def compute(ctx):
        x = ctx.input("X")
        return {"Out": x * torch.clamp(x + 2.0, 0.0, 6.0) / 6.0}
    return compute


def _hash_arithmetic_shift(plain):
    """The mix fed the sign-extended 64-bit id: an id past 2^31 (negative
    as int32) hashes differently."""
    def compute(ctx):
        from paddle_tpu_torch.ops import tensor_ops as T

        class _Ctx:
            op, device = ctx.op, ctx.device
            input = staticmethod(lambda s: ctx.input(s).to(torch.int64) >> 1)
            attr = ctx.attr
        return T.hash_op(_Ctx)
    return compute


def _unique_sorted(plain):
    def compute(ctx):
        out = plain(ctx)
        uniq, inv = torch.unique(ctx.input("X").reshape(-1), sorted=True,
                                 return_inverse=True)
        return dict(out, Out=uniq, Index=inv.to(out["Index"].dtype))
    return compute


def _cos_without_norms(plain):
    def compute(ctx):
        out = plain(ctx)
        return dict(out, Out=(ctx.input("X") * ctx.input("Y")).sum(-1, keepdim=True))
    return compute


def test_longtail_ops_phase_holds_the_port(tiny, capsys):
    assert chip_smoke.longtail_ops(CPU, "CPU") == {}
    out = capsys.readouterr().out
    assert "longtail ops on the card against the CPU (" in out
    assert out.count(" ms (") >= 79 - 5


@pytest.mark.parametrize("op,fault,why", [
    ("hard_swish", _hard_swish_offset_2, "hard_swish: o on the card"),
    ("hash", _hash_arithmetic_shift, "hash: o differs on the card"),
    ("unique", _unique_sorted, "unique: o differs on the card")])
def test_longtail_ops_phase_refuses_a_card_fault(tiny, monkeypatch, op, fault,
                                                 why):
    _card_fault(monkeypatch, op, fault)
    with pytest.raises(RuntimeError, match=why):
        chip_smoke.longtail_ops(CPU, "CPU")


def test_mobilenet_v3_phase_holds_the_port(tiny, capsys):
    held, timed = chip_smoke.train_mobilenet_v3(CPU, "CPU")
    assert held == {} and timed == {}
    out = capsys.readouterr().out
    assert "MobileNetV3-Large x1.0 step 1 at B=4" in out and "images/s" in out


def test_mobilenet_v3_phase_refuses_hard_swish_offset_2(tiny, monkeypatch):
    _card_fault(monkeypatch, "hard_swish", _hard_swish_offset_2)
    with pytest.raises(RuntimeError, match="MobileNetV3 step 1: loss"):
        chip_smoke.train_mobilenet_v3(CPU, "CPU")


def test_recommender_phase_holds_the_port(capsys):
    assert chip_smoke.book_recommender(CPU, "CPU") == {}
    out = capsys.readouterr().out
    assert "synthetic fallback" in out and "samples/s with the reader" in out


def test_recommender_phase_refuses_cos_sim_without_norms(monkeypatch):
    _card_fault(monkeypatch, "cos_sim", _cos_without_norms)
    with pytest.raises(RuntimeError, match="recommender step 1: loss"):
        chip_smoke.book_recommender(CPU, "CPU")
