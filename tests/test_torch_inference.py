"""The port's Predictor (paddle_tpu_torch/inference) and
Program.clone(for_test) held against the JAX package's on the CPU.

* tests/test_inference_api.py's cases on the port: the native predictor
  matches a direct run, through run() and run_dict() and a clone; the bf16
  predictor's parameters are bf16 and its output within rtol 0.05 / atol
  0.02 of the fp32 run (the JAX test's band); a clone shares the program,
  the scope and the executor and runs from several threads at once; a
  missing feed raises; with no device named and no CUDA, a raise.
* The predictor's outputs equal the JAX Predictor's on the same directory,
  fp32 (1e-5) and bf16 (each within the band above of the fp32 run).
* clone(for_test=True) equals the JAX clone through to_dict(): dropout and
  batch_norm get is_test; a clone of a minimized ResNet keeps conv2d_bn in
  training mode (it has no is_test attr), in both packages.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from torch_parity import J, T, build

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import flags as jflags
from paddle_tpu.inference import AnalysisConfig as JAnalysis
from paddle_tpu.inference import NativeConfig as JNative
from paddle_tpu.inference import create_paddle_predictor as j_predictor
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                        PaddleTensor, create_paddle_predictor)
from paddle_tpu_torch.weights import load_params


def _net(pkg):
    """tests/test_inference_api.py's net: fc-relu-fc-softmax."""
    L = pkg["L"]
    x = L.data(name="x", shape=[8], dtype="float32")
    h = L.fc(x, size=16, act="relu")
    return [L.fc(h, size=3, act="softmax")]


def _save_model(tmp_path, pkg=T):
    """The net saved by `pkg` from the JAX startup's weights: (dir, x,
    the direct run's output)."""
    jm, js, _ = build(J, _net)
    main, startup, (out,) = build(pkg, _net)
    jscope = jpt.Scope()
    jpt.Executor().run(js, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name))
              for p in jm.all_parameters()}
    exe = pkg["exe"]()
    scope = pkg["scope"]()
    exe.run(startup, scope=scope)
    if pkg is T:
        load_params(scope, main, params)
    else:
        scope = jscope
    d = str(tmp_path / "model")
    pkg["pt"].io.save_inference_model(d, ["x"], [out], exe, main_program=main,
                                      scope=scope)
    xb = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    (ref,) = exe.run(main, feed={"x": xb}, fetch_list=[out], scope=scope)
    return d, xb, np.asarray(ref)


def test_native_predictor_matches_direct_run(tmp_path):
    model_dir, xb, ref = _save_model(tmp_path)
    pred = create_paddle_predictor(NativeConfig(model_dir=model_dir,
                                                device="cpu"))
    assert pred.get_input_names() == ["x"]
    assert len(pred.get_output_names()) == 1
    outs = pred.run([PaddleTensor(name="x", data=xb)])
    assert outs[0].name == pred.get_output_names()[0]
    np.testing.assert_allclose(outs[0].data, ref, rtol=1e-5)
    np.testing.assert_allclose(pred.run_dict({"x": xb})[0], ref, rtol=1e-5)
    np.testing.assert_allclose(pred.clone().run_dict({"x": xb})[0], ref,
                               rtol=1e-5)


def test_predictor_from_prog_and_params_files(tmp_path):
    """NativeConfig's prog_file / params_file form, one combined file."""
    main, startup, (out,) = build(T, _net)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    d = tmp_path / "m"
    tpt.io.save_inference_model(str(d), ["x"], [out], exe, main_program=main,
                                model_filename="prog.json",
                                params_filename="weights.npz", scope=scope)
    xb = np.ones((2, 8), np.float32)
    (ref,) = exe.run(main, feed={"x": xb}, fetch_list=[out], scope=scope)
    pred = create_paddle_predictor(NativeConfig(
        prog_file=str(d / "prog.json"), params_file=str(d / "weights.npz"),
        device="cpu"))
    np.testing.assert_array_equal(pred.run_dict({"x": xb})[0], ref)


def test_analysis_predictor_bf16(tmp_path):
    model_dir, xb, ref = _save_model(tmp_path)
    pred = create_paddle_predictor(AnalysisConfig(
        model_dir=model_dir, enable_bf16=True, device="cpu"))
    assert pred._scope.find_var("fc_0.w_0").dtype == torch.bfloat16
    assert pred._program.global_block.var("x").dtype.value == "bfloat16"
    (out,) = pred.run_dict({"x": xb})
    np.testing.assert_allclose(out, ref, rtol=0.05, atol=0.02)


def test_clone_shares_the_model_and_runs_from_other_threads(tmp_path):
    """Three threads and the main one run the predictor and its clones 20
    times each with a short switch interval: every result exact, the scope's
    run counter at the count of runs (no lost update)."""
    model_dir, xb, ref = _save_model(tmp_path)
    pred = create_paddle_predictor(NativeConfig(model_dir=model_dir,
                                                device="cpu"))
    clone = pred.clone()
    assert (clone._scope is pred._scope and clone._exe is pred._exe
            and clone._program is pred._program)
    start = pred._scope._run_counter
    errors = []

    def worker(p):
        try:
            for _ in range(20):
                (out,) = p.run_dict({"x": xb})
                np.testing.assert_allclose(out, ref, rtol=1e-5)
        except Exception as e:  # noqa: BLE001 - surfaced on the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(p,))
                   for p in (pred, clone, clone)]
        for t in threads:
            t.start()
        worker(pred)
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert pred._scope._run_counter - start == 80


def test_predictor_missing_feed_raises(tmp_path):
    model_dir, _, _ = _save_model(tmp_path)
    pred = create_paddle_predictor(NativeConfig(model_dir=model_dir,
                                                device="cpu"))
    with pytest.raises(ValueError, match="x"):
        pred.run_dict({})


def test_predictor_without_a_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model_dir, _, _ = _save_model(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA"):
        create_paddle_predictor(NativeConfig(model_dir=model_dir))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_predictor_matches_the_jax_predictor(tmp_path, bf16):
    """Both packages' predictors on one directory the JAX package saved."""
    model_dir, xb, ref = _save_model(tmp_path, J)
    cfg = dict(model_dir=model_dir, enable_bf16=bf16)
    got = create_paddle_predictor(AnalysisConfig(device="cpu", **cfg)
                                  ).run_dict({"x": xb})[0]
    want = np.asarray(j_predictor(JAnalysis(**cfg)).run_dict({"x": xb})[0],
                      np.float32)
    if bf16:
        np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.02)
        np.testing.assert_allclose(want, ref, rtol=0.05, atol=0.02)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert j_predictor(JNative(model_dir=model_dir)).get_output_names() \
            == create_paddle_predictor(NativeConfig(
                model_dir=model_dir, device="cpu")).get_output_names()


# -- Program.clone(for_test) -------------------------------------------------


def _clone_net(pkg):
    L = pkg["L"]
    x = L.data(name="x", shape=[3, 8, 8], dtype="float32")
    y = L.batch_norm(L.conv2d(x, num_filters=4, filter_size=3, padding=1,
                              bias_attr=False), act="relu")
    y = L.dropout(y, dropout_prob=0.3)
    return [L.mean(y)]


@pytest.fixture
def _fuse_flags():
    saved_j = {k: jflags.get_flag(k) for k in ("conv_implicit_gemm",
                                               "pallas_epilogue")}
    saved_t = tflags.get_flag("fuse_epilogue")
    jflags.set_flags({"conv_implicit_gemm": "off", "pallas_epilogue": "on"})
    tflags.set_flags({"fuse_epilogue": True})
    yield
    jflags.set_flags(saved_j)
    tflags.set_flags({"fuse_epilogue": saved_t})


@pytest.mark.parametrize("minimized", [False, True],
                         ids=["before_minimize", "after_minimize"])
def test_clone_for_test_equals_the_jax_clone(minimized, _fuse_flags):
    def fn(pkg):
        (loss,) = _clone_net(pkg)
        main = pkg["pt"].default_main_program()
        if minimized:
            pkg["pt"].optimizer.Momentum(0.1, 0.9).minimize(loss)
        return [main.clone(for_test=True), main.clone()]

    jm, _, (jtest, jsame) = build(J, fn)
    tm, _, (ttest, tsame) = build(T, fn)
    assert ttest.to_dict() == jtest.to_dict()
    assert tsame.to_dict() == tm.to_dict() == jm.to_dict()
    ops = {op.type: op for op in ttest.global_block.ops}
    assert ops["dropout"].attrs["is_test"] is True
    if minimized:
        # the fused op has no is_test: training-mode batch norm stays
        assert "conv2d_bn" in ops and "is_test" not in ops["conv2d_bn"].attrs
        assert ops["dropout_grad"].attrs["is_test"] is True
    else:
        assert ops["batch_norm"].attrs["is_test"] is True
        assert not tm.global_block.ops[1].attrs["is_test"]


def test_clone_copies_attrs_deeply():
    main, _, (loss,) = build(T, _clone_net)
    c = main.clone()
    op = next(o for o in c.global_block.ops if o.type == "conv2d")
    op.attrs["strides"][0] = 7
    op.inputs["Input"].append("other")
    orig = next(o for o in main.global_block.ops if o.type == "conv2d")
    assert orig.attrs["strides"] == [1, 1]
    assert orig.inputs["Input"] == ["x"]
    assert c.global_block.var("x") is not main.global_block.var("x")
