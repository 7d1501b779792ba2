"""chip_smoke.py's YOLOv3 (`_yolov3_program`), built from layers both
packages export, held against the JAX package on the CPU at a tiny size:
one residual block a stage, width 8, 64 x 64 input, 4 classes, B = 2.
The training program and its eval clone equal the JAX package's through
to_dict(); two Momentum steps from one startup state agree within 1e-5
(the losses, every parameter, the batch norms' running statistics); the
eval clone saved by each package's io.save_inference_model and run by
each package's predictor: the boxes and scores before the NMS within 1e-5,
the port's multiclass_nms on the JAX predictor's boxes and scores equal to
its rows bit for bit (a score one rounding apart reorders near-ties, so the
NMS is held on one set of inputs)."""
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

from torch_parity import close

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

TINY = dict(hw=64, width=8, stages=(1, 1, 1, 1, 1), classes=4)


@pytest.fixture(scope="module")
def runs():
    """Both packages' programs, built under the JAX baseline convolution
    arm and the epilogue pass on in both (the port's default; the flags
    restored after), and two Momentum steps from the port's startup state
    (every var it writes, carried into the JAX scope). In the port's run,
    a leaky_relu input within chip_smoke.MBV3_KINK_NEAR of 0 and an ignore
    decision within YOLO_IOU_NEAR of ignore_thresh take the JAX run's side
    (chip_smoke's flip rule, the JAX run standing in for the card): XLA's
    and torch's convolutions round differently, and one leaky_relu input
    at 1e-7 of 0 on opposite sides moves every upstream gradient of step
    2 by up to 2e-2."""
    import jax.numpy as jnp
    import torch

    import paddle_tpu as jpt
    import paddle_tpu_torch as tpt
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags

    saved_j = {k: jflags.get_flag(k) for k in
               ("conv_implicit_gemm", "pallas_epilogue")}
    saved_t = tflags.get_flag("fuse_epilogue")
    jflags.set_flags({"conv_implicit_gemm": "off", "pallas_epilogue": "on"})
    tflags.set_flags({"fuse_epilogue": True})
    try:
        j = chip_smoke._yolov3_program(jpt, **TINY)
        t = chip_smoke._yolov3_program(tpt, **TINY)
        tscope, texe = tpt.Scope(), tpt.Executor(place="cpu")
        texe.run(t[1], scope=tscope)
        jscope, jexe = jpt.Scope(), jpt.Executor()
        for n in tscope.var_names():
            jscope.set_var(n, jnp.asarray(tscope.find_var(n).numpy()))
        kinks = chip_smoke._kink_vars(t[0])
        deciding = sorted(set(kinks.values()))
        fetch = [t[3].name] + deciding + t[4]
        losses, taken, flips = [], [0], [0]
        for feed in _feeds(2):
            jv = jexe.run(j[0], feed=feed, fetch_list=fetch, scope=jscope)
            at = dict(zip(fetch, (torch.from_numpy(np.array(v)) for v in jv)))
            with chip_smoke._card_kinks(t[0], {o: at[i] for o, i in kinks.items()},
                                        chip_smoke.MBV3_KINK_NEAR, taken), \
                    chip_smoke._card_ignore({m: at[m] for m in t[4]},
                                            chip_smoke.YOLO_IOU_NEAR, flips):
                (tl,) = texe.run(t[0], feed=feed, fetch_list=[t[3].name],
                                 scope=tscope)
            losses.append((np.asarray(jv[0]), np.asarray(tl)))
        yield dict(j=j, t=t, jscope=jscope, tscope=tscope, jexe=jexe,
                   texe=texe, losses=losses, taken=taken[0], flips=flips[0])
    finally:
        jflags.set_flags(saved_j)
        tflags.set_flags({"fuse_epilogue": saved_t})


def _feeds(n, B=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = chip_smoke._yolo_feed(rng, B, TINY["hw"], TINY["classes"])
        f["gt_label"] = f["gt_label"].astype(np.int64)
        out.append(f)
    return out


def test_tiny_yolov3_programs_equal_the_jax_packages(runs):
    j, t = runs["j"], runs["t"]
    for a, b in zip(j[:3], t[:3]):
        assert b.to_dict() == a.to_dict()
    types = [o.type for o in t[0].global_block.ops]
    assert sum(o in ("batch_norm", "conv2d_bn") for o in types) == 36
    for op in ("leaky_relu", "nearest_interp", "yolov3_loss", "concat",
               "yolov3_loss_grad", "nearest_interp_grad", "momentum"):
        assert op in types, op
    test_types = [o.type for o in t[2].global_block.ops]
    assert test_types.count("yolo_box") == 3 and test_types[-1] == "multiclass_nms"
    assert "yolov3_loss" not in test_types


def test_tiny_yolov3_two_momentum_steps_match_jax(runs):
    for j, t in runs["losses"]:
        close([t], [j], what="loss")
    (j1, _), (j2, _) = runs["losses"]
    assert np.isfinite(float(j1)) and float(j2) != float(j1)
    assert runs["taken"] <= 4 and runs["flips"] <= 4
    t, tscope, jscope = runs["t"], runs["tscope"], runs["jscope"]
    names = [v.name for v in t[0].global_block.vars.values()
             if v.persistable and not v.name.startswith("@")]
    assert any(n.endswith(".bn.mean") for n in names)
    for n in names:
        close([np.asarray(tscope.find_var(n))], [np.asarray(jscope.find_var(n))],
              what=n)


def test_tiny_yolov3_predictors_match_jax(runs):
    """After the two steps, each package saves its eval clone from its own
    scope and serves it: the same boxes and scores; the port's NMS on the
    JAX predictor's boxes and scores gives its rows (label, score, box)
    bit for bit, with detections."""
    import torch
    import paddle_tpu as jpt
    import paddle_tpu.inference as jinf
    import paddle_tpu_torch as tpt
    import paddle_tpu_torch.inference as tinf

    feed = {"image": _feeds(1, seed=5)[0]["image"],
            "im_shape": np.full((2, 2), TINY["hw"], np.int32)}
    outs, nms_op = [], None
    for pkg, inf, prog, scope, exe in (
            (jpt, jinf, runs["j"], runs["jscope"], runs["jexe"]),
            (tpt, tinf, runs["t"], runs["tscope"], runs["texe"])):
        test, nms = prog[2], prog[5]
        op = nms_op = next(o for o in test.global_block.ops
                           if o.type == "multiclass_nms")
        targets = [nms] + [test.global_block.var(op.inputs[s][0])
                           for s in ("BBoxes", "Scores")]
        with tempfile.TemporaryDirectory() as d:
            pkg.io.save_inference_model(d, ["image", "im_shape"], targets, exe,
                                        main_program=test, scope=scope)
            cfg = (inf.NativeConfig(model_dir=d) if pkg is jpt else
                   inf.NativeConfig(model_dir=d, device="cpu"))
            pred = inf.create_paddle_predictor(cfg)
            outs.append([np.asarray(a) for a in pred.run_dict(feed)])
    (jrows, jb, js), (trows, tb, ts) = outs
    assert tb.shape == jb.shape == (2, 3 * (4 + 16 + 64), 4)
    assert ts.shape == js.shape == (2, TINY["classes"], 3 * (4 + 16 + 64))
    close([tb, ts], [jb, js], what="boxes and scores")
    assert trows.shape == jrows.shape == (2, chip_smoke.YOLO_KEEP_TOP_K, 6)
    rows = chip_smoke._nms_on_cpu(nms_op, torch.from_numpy(jb),
                                  torch.from_numpy(js)).numpy()
    np.testing.assert_array_equal(rows, jrows)
    assert (jrows[..., 0] >= 0).any() and (trows[..., 0] >= 0).any()
