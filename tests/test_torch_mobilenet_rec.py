"""chip_smoke.py's two new training paths, built from layers both packages
export, held against the JAX package on the CPU: a tiny MobileNetV3 (x0.35
width, 32 x 32 input, the first four bnecks and the head, 10 classes)
under Momentum(0.9), and the book recommender on the movielens reader's
synthetic fallback under SGD(0.2). Each program equals the JAX package's
through to_dict(); two steps from the JAX startup's weights agree within
1e-5 (losses, every parameter, the batch norms' running statistics)."""
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import J, T, close, run_both

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


@pytest.fixture
def tiny_mbv3(monkeypatch):
    """The tiny widths, the JAX baseline convolution arm, and the epilogue
    pass on in both packages (the port's default: batch norm -> relu folds
    into the norm op), the flags restored after."""
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags

    saved_j = {k: jflags.get_flag(k) for k in
               ("conv_implicit_gemm", "pallas_epilogue")}
    saved_t = tflags.get_flag("fuse_epilogue")
    jflags.set_flags({"conv_implicit_gemm": "off", "pallas_epilogue": "on"})
    tflags.set_flags({"fuse_epilogue": True})
    for name, value in (("MBV3_HW", 32), ("MBV3_SCALE", 0.35),
                        ("MBV3_CLASSES", 10), ("MBV3_LR", 0.05),
                        ("MBV3_BNECKS", chip_smoke.MBV3_LARGE[:4])):
        monkeypatch.setattr(chip_smoke, name, value)
    yield
    jflags.set_flags(saved_j)
    tflags.set_flags({"fuse_epilogue": saved_t})


def _persistables(main):
    return [v.name for v in main.global_block.vars.values()
            if v.persistable and not v.name.startswith("@")]


def _two_steps(jp, tp, feeds, jloss, tloss):
    assert tp[0].to_dict() == jp[0].to_dict()
    assert tp[1].to_dict() == jp[1].to_dict()
    jout, tout, jscope, tscope = run_both(jp, tp, feeds, [jloss], [tloss])
    for j, t in zip(jout, tout):
        close(t, j, what="loss")
    names = _persistables(tp[0])
    assert names
    for n in names:
        close([np.asarray(tscope.find_var(n))], [np.asarray(jscope.find_var(n))],
              what=n)
    return [float(np.asarray(j[0]).reshape(-1)[0]) for j in jout]


def test_tiny_mobilenet_v3_matches_jax(tiny_mbv3):
    import paddle_tpu as jpt
    import paddle_tpu_torch as tpt

    jm, js, jl = chip_smoke._mbv3_program(jpt)
    tm, ts, tl = chip_smoke._mbv3_program(tpt)
    types = [o.type for o in tm.global_block.ops]
    for t in ("hard_swish", "hard_sigmoid", "depthwise_conv2d", "batch_norm",
              "hard_swish_grad", "batch_norm_grad", "momentum"):
        assert t in types, t
    rng = np.random.default_rng(0)
    feeds = [{"img": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
              "label": rng.integers(0, 10, (4, 1)).astype(np.int64)}
             for _ in range(2)]
    _two_steps((jm, js), (tm, ts), feeds, jl, tl)


def test_tiny_recommender_matches_jax():
    import paddle_tpu as jpt
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.dataset import movielens

    jm, js, jtest, jl, _ = chip_smoke._rec_program(jpt, movielens)
    tm, ts, ttest, tl, feeds = chip_smoke._rec_program(tpt, movielens)
    assert ttest.to_dict() == jtest.to_dict()
    assert "cos_sim" in [o.type for o in tm.global_block.ops]
    feeder = chip_smoke._rec_feeder(tpt, feeds)
    batches = tpt.batch(movielens.train(), 32, drop_last=True)()
    losses = _two_steps((jm, js), (tm, ts),
                        [feeder(next(batches)) for _ in range(2)], jl, tl)
    assert all(np.isfinite(losses))
