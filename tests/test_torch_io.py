"""The port's io.py held against the JAX package's on the CPU.

* tests/test_io.py's cases on the port: the persistables round trip, the
  combined `.npz`, the inference model round trip (backward and optimizer
  ops pruned), a missing var and saving before startup raise, a mid-graph
  feed prunes at the feed.
* The on-disk layout: one program saved by both packages gives equal
  `__model__.json` dicts and byte-equal fp32 parameter files; a directory
  saved by either loads in the other's Predictor, which gives the other's
  outputs (resnet_cifar10 from its for_test clone, bert_tiny's features),
  within rtol 1e-5 and 1e-5 of the output's max-abs (fp32 sums in another
  order).
* bfloat16: a bf16 var round-trips through `.npy` and `.npz` bit for bit,
  written as `np.save` writes ml_dtypes' bfloat16 ('<V2'); the JAX
  package's bf16 file loads into a bf16 var bit for bit and is refused by
  an fp32 one.
* Every function takes an explicit scope; the loads check every array
  before they write any; save_sharded / load_sharded raise past world
  size 1 (tests/test_torch_resilience.py holds them at world size 1).
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from torch_parity import J, T, build

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import flags as jflags
from paddle_tpu.inference import NativeConfig as JConfig
from paddle_tpu.inference import create_paddle_predictor as j_predictor
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core.types import DType
from paddle_tpu_torch.inference import NativeConfig as TConfig
from paddle_tpu_torch.inference import create_paddle_predictor as t_predictor
from paddle_tpu_torch.weights import load_params


def _regression(pkg):
    """tests/test_io.py's net: fc-relu-fc under Adam, its for_test clone
    taken before minimize."""
    L = pkg["L"]
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    h = L.fc(x, size=4, act="relu")
    pred = L.fc(h, size=1)
    loss = L.mean(L.square_error_cost(pred, y))
    eval_prog = pkg["pt"].default_main_program().clone(for_test=True)
    pkg["pt"].optimizer.Adam(learning_rate=0.01).minimize(loss)
    return [pred, loss, eval_prog]


def _trained(steps=3):
    """The port's regression net after `steps` Adam steps: (main, pred,
    eval_prog, scope, exe, x)."""
    main, startup, (pred, loss, eval_prog) = build(T, _regression)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(0)
    xv = rng.standard_normal((16, 8)).astype(np.float32)
    w = rng.standard_normal((8, 1)).astype(np.float32)
    for _ in range(steps):
        exe.run(main, feed={"x": xv, "y": xv @ w}, fetch_list=[loss],
                scope=scope)
    return main, pred, eval_prog, scope, exe, xv


def _eval(exe, prog, scope, xv, pred):
    return exe.run(prog, feed={"x": xv, "y": np.zeros((16, 1), np.float32)},
                   fetch_list=[pred.name], scope=scope)[0]


def test_save_load_persistables_roundtrip(tmp_path):
    main, pred, eval_prog, scope, exe, xv = _trained()
    before = _eval(exe, eval_prog, scope, xv, pred)
    saved = tio.save_persistables(exe, str(tmp_path / "ckpt"), main,
                                  scope=scope)
    assert any("moment" in n for n in saved) and "fc_0.w_0" in saved
    for name in saved:
        scope.set_var(name, torch.zeros_like(scope.find_var(name)))
    tio.load_persistables(exe, str(tmp_path / "ckpt"), main, scope=scope)
    np.testing.assert_array_equal(_eval(exe, eval_prog, scope, xv, pred),
                                  before)


def test_save_load_combined_file(tmp_path):
    main, _, _, scope, exe, _ = _trained()
    tio.save_params(exe, str(tmp_path / "ckpt"), main, filename="params.npz",
                    scope=scope)
    names = [p.name for p in main.all_parameters()]
    orig = {n: scope.find_var(n).clone() for n in names}
    for n in names:
        scope.set_var(n, torch.zeros_like(orig[n]))
    tio.load_params(exe, str(tmp_path / "ckpt"), main, filename="params",
                    scope=scope)
    for n in names:
        assert torch.equal(scope.find_var(n), orig[n]), n


def test_inference_model_roundtrip(tmp_path):
    main, pred, eval_prog, scope, exe, xv = _trained()
    want = _eval(exe, eval_prog, scope, xv, pred)
    tio.save_inference_model(str(tmp_path / "model"), ["x"], [pred], exe,
                             main_program=main, scope=scope)
    fresh = tpt.Scope()
    prog, feeds, fetches = tio.load_inference_model(str(tmp_path / "model"),
                                                    exe, scope=fresh)
    assert feeds == ["x"] and fetches == [pred.name]
    types = {op.type for op in prog.global_block.ops}
    assert not any(t.endswith("_grad") or t == "adam" for t in types)
    got = exe.run(prog, feed={"x": xv}, fetch_list=fetches, scope=fresh)[0]
    np.testing.assert_array_equal(got, want)


def test_load_missing_var_errors(tmp_path):
    main, _, _, scope, exe, _ = _trained(steps=0)
    with pytest.raises(FileNotFoundError):
        tio.load_params(exe, str(tmp_path / "nonexistent"), main, scope=scope)


def test_save_before_startup_errors(tmp_path):
    main, _, _ = build(T, lambda pkg: pkg["L"].fc(
        pkg["L"].data(name="x", shape=[4], dtype="float32"), size=2))
    with pytest.raises(RuntimeError, match="startup"):
        tio.save_params(None, str(tmp_path / "ckpt"), main, scope=tpt.Scope())


def test_inference_model_mid_graph_feed(tmp_path):
    """Feeding an intermediate var: the pruning stops at the feed (the ops
    computing the fed var are dropped, not kept)."""
    def fn(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[8], dtype="float32")
        h = L.fc(x, size=4, act="relu", name="hlayer")
        return [h, L.fc(h, size=1, name="olayer")]

    main, startup, (h, pred) = build(T, fn)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    tio.save_inference_model(str(tmp_path / "m"), [h.name], [pred], exe,
                             main_program=main, scope=scope)
    prog, feeds, fetches = tio.load_inference_model(str(tmp_path / "m"), exe,
                                                    scope=tpt.Scope())
    assert feeds == [h.name]
    assert [op.type for op in prog.global_block.ops] == ["mul",
                                                         "elementwise_add"]
    hv = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    want = (hv @ scope.find_var("olayer.w_0").numpy()
            + scope.find_var("olayer.b_0").numpy())
    scope2 = tpt.Scope()
    tio.load_inference_model(str(tmp_path / "m"), exe, scope=scope2)
    (got,) = exe.run(prog, feed={h.name: hv}, fetch_list=fetches,
                     scope=scope2)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_train_model_roundtrip(tmp_path):
    main, pred, eval_prog, scope, exe, xv = _trained()
    loss_name = next(op.outputs["Out"][0] for op in main.global_block.ops
                     if op.type == "mean")
    meta = tio.save_train_model(str(tmp_path / "t"), ["x", "y"], loss_name,
                                exe, main_program=main,
                                startup_program=tpt.Program(), scope=scope)
    scope2 = tpt.Scope()
    prog, _, meta2 = tio.load_train_model(str(tmp_path / "t"), exe,
                                          scope=scope2)
    assert meta2 == meta and prog.to_dict() == main.to_dict()
    for v in main.list_vars():
        if v.persistable:
            assert torch.equal(scope2.find_var(v.name),
                               scope.find_var(v.name)), v.name


@pytest.mark.parametrize("fn", ["save_vars", "save_params", "save_persistables",
                                "load_vars", "load_params", "load_persistables",
                                "save_train_model", "load_train_model",
                                "save_inference_model",
                                "load_inference_model"])
def test_every_function_needs_an_explicit_scope(tmp_path, fn):
    args = {"save_train_model": (str(tmp_path), [], "loss"),
            "save_inference_model": (str(tmp_path), [], []),
            "load_train_model": (str(tmp_path),),
            "load_inference_model": (str(tmp_path),)}.get(fn, ())
    kwargs = {} if args else {"dirname": str(tmp_path),
                              "main_program": tpt.Program()}
    with pytest.raises(ValueError, match="explicit scope"):
        getattr(tio, fn)(*args, **kwargs)


@pytest.mark.parametrize("fn", ["save_sharded", "load_sharded"])
def test_sharded_checkpoints_name_what_is_missing(fn, monkeypatch):
    """They checkpoint at world size 1; over more ranks they raise, naming
    the ROADMAP item."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="parallel and distributed"):
        getattr(tio, fn)(dirname="x", scope=tpt.Scope())


def test_loads_check_every_array_before_writing(tmp_path):
    """A file of the wrong shape or dtype raises, naming the var, and
    leaves every scope tensor as it was."""
    main, _, _, scope, exe, _ = _trained(steps=0)
    d = str(tmp_path / "ckpt")
    tio.save_params(exe, d, main, scope=scope)
    before = {p.name: scope.find_var(p.name) for p in main.all_parameters()}
    path = os.path.join(d, "fc_1.w_0.npy")
    np.save(path, np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="fc_1.w_0"):
        tio.load_params(exe, d, main, scope=scope)
    np.save(path, np.zeros((4, 1), np.float64))
    with pytest.raises(TypeError, match="fc_1.w_0"):
        tio.load_params(exe, d, main, scope=scope)
    for n, t in before.items():
        assert scope.find_var(n) is t


def test_loads_raise_without_cuda_unless_an_executor_names_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main, _, _, scope, exe, _ = _trained(steps=0)
    tio.save_params(exe, str(tmp_path), main, scope=scope)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tio.load_params(None, str(tmp_path), main, scope=scope)


# -- bfloat16 on disk --------------------------------------------------------


def _bf16_program():
    main = tpt.Program()
    main.global_block.create_var(name="w", shape=[3, 5], dtype="bfloat16",
                                 persistable=True)
    return main


@pytest.mark.parametrize("filename", [None, "all.npz"], ids=["npy", "npz"])
def test_bf16_var_roundtrips_bit_for_bit(tmp_path, filename):
    main = _bf16_program()
    words = np.random.default_rng(0).integers(0, 2**16, (3, 5)).astype(
        np.uint16)
    words[0, 0] = 0x7FC1                     # a NaN payload survives too
    scope = tpt.Scope()
    scope.set_var("w", torch.from_numpy(words.view(np.int16)).view(
        torch.bfloat16))
    exe = tpt.Executor(place="cpu")
    tio.save_persistables(exe, str(tmp_path), main, filename=filename,
                          scope=scope)
    back = tpt.Scope()
    tio.load_persistables(exe, str(tmp_path), main, filename=filename,
                          scope=back)
    got = back.find_var("w")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), words)


def test_bf16_file_is_the_jax_packages_bytes(tmp_path):
    """The port's bf16 .npy has np.save's bytes for ml_dtypes' bfloat16
    (descr '<V2'); a file the JAX package's arrays give loads into a bf16
    var bit for bit, and an fp32 var refuses it."""
    main = _bf16_program()
    vals = np.random.default_rng(1).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    scope = tpt.Scope()
    scope.set_var("w", torch.from_numpy(vals.view(np.int16)).view(
        torch.bfloat16))
    exe = tpt.Executor(place="cpu")
    tio.save_persistables(exe, str(tmp_path / "t"), main, scope=scope)
    os.makedirs(tmp_path / "j")
    np.save(tmp_path / "j" / "w.npy", vals)
    assert ((tmp_path / "t" / "w.npy").read_bytes()
            == (tmp_path / "j" / "w.npy").read_bytes())
    back = tpt.Scope()
    tio.load_persistables(exe, str(tmp_path / "j"), main, scope=back)
    assert torch.equal(back.find_var("w"), scope.find_var("w"))
    main.global_block.var("w").dtype = DType.FP32
    with pytest.raises(TypeError, match="'w'"):
        tio.load_persistables(exe, str(tmp_path / "j"), main, scope=back)


# -- across the two packages -------------------------------------------------


def _save_both(fn, tmp_path, feeds, params_filename=None):
    """Build fn in both packages; save its inference model from each, the
    JAX startup's parameters in both scopes. Returns (jax dir, port dir,
    the JAX program, its target)."""
    jm, js, (jtarget, jprog) = build(J, fn)
    tm, ts, (ttarget, tprog) = build(T, fn)
    assert tprog.to_dict() == jprog.to_dict()
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    tscope, texe = tpt.Scope(), tpt.Executor(place="cpu")
    texe.run(ts, scope=tscope)
    load_params(tscope, tm, {p.name: np.asarray(jscope.find_var(p.name))
                             for p in jm.all_parameters()})
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpt.io.save_inference_model(jd, feeds, [jtarget], jexe,
                                main_program=jprog, scope=jscope,
                                params_filename=params_filename)
    tio.save_inference_model(td, feeds, [ttarget], texe, main_program=tprog,
                             scope=tscope, params_filename=params_filename)
    return jd, td


def _cifar(pkg):
    from importlib import import_module

    rn = import_module(pkg["pt"].__name__ + ".models.resnet")
    _, _, logits = rn.resnet_cifar10()
    return logits, pkg["pt"].default_main_program().clone(for_test=True)


def _bert(pkg):
    from importlib import import_module

    tr = import_module(pkg["pt"].__name__ + ".models.transformer")
    tr.bert_pretrain(tr.bert_tiny(use_tp=False), seq_len=16)
    return (tr.last_layer_outputs[-1],
            pkg["pt"].default_main_program().clone(for_test=True))


def _cifar_feed():
    return {"img": np.random.default_rng(0).standard_normal(
        (4, 3, 32, 32)).astype(np.float32)}


def _bert_feed():
    rng = np.random.default_rng(0)
    return {"src_ids": rng.integers(0, 100, (4, 16)).astype(np.int64),
            "pos_ids": np.tile(np.arange(16, dtype=np.int64), (4, 1))}


MODELS = {"resnet_cifar10": (_cifar, _cifar_feed),
          "bert_tiny": (_bert, _bert_feed)}


@pytest.fixture(autouse=True)
def _jax_baseline_conv():
    saved = jflags.get_flag("conv_implicit_gemm")
    jflags.set_flags({"conv_implicit_gemm": "off"})
    yield
    jflags.set_flags({"conv_implicit_gemm": saved})


@pytest.mark.parametrize("model", sorted(MODELS))
def test_both_packages_write_the_same_directory(tmp_path, model):
    fn, feed = MODELS[model]
    jd, td = _save_both(fn, tmp_path, list(feed()))
    with open(os.path.join(jd, "__model__.json")) as f:
        jdesc = json.load(f)
    with open(os.path.join(td, "__model__.json")) as f:
        tdesc = json.load(f)
    assert tdesc == jdesc
    files = sorted(os.listdir(jd))
    assert sorted(os.listdir(td)) == files and len(files) > 10
    for name in files:
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def _outputs_agree(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("params_filename", [None, "params.npz"],
                         ids=["npy", "npz"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_directory_loads_in_the_other_packages_predictor(tmp_path, model,
                                                           params_filename):
    fn, feed = MODELS[model]
    jd, td = _save_both(fn, tmp_path, list(feed()), params_filename)
    fd = feed()
    want = j_predictor(JConfig(model_dir=jd)).run_dict(fd)[0]
    for d in (jd, td):
        _outputs_agree(t_predictor(TConfig(model_dir=d, device="cpu"))
                       .run_dict(fd)[0], want)
    back = t_predictor(TConfig(model_dir=jd, device="cpu")).run_dict(fd)[0]
    _outputs_agree(np.asarray(j_predictor(JConfig(model_dir=td))
                              .run_dict(fd)[0]), back)
