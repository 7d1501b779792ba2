"""The port's IR stack (paddle_tpu_torch: framework, layers, op registry,
executor) held against the JAX package's: the serving programs are built
op for op alike, shape inference on meta tensors gives the JAX side's
shapes, the ops compute the same values, and the package stands alone."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu import unique_name as jun
from paddle_tpu.executor import Executor as JExecutor
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.serving import model as jmodel
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.executor import Executor, Scope
from paddle_tpu_torch.framework import Program, program_guard
from paddle_tpu_torch.serving import model as tmodel

REPO = Path(__file__).resolve().parents[1]
BUILDERS = ("prefill", "decode", "full")


def _build(which, Prog, guard, un, mod, cfg):
    main, startup = Prog(), Prog()
    with guard(main, startup), un.guard():
        if which == "prefill":
            io = mod.build_prefill_program(cfg, 16, 4)
        elif which == "decode":
            io = mod.build_decode_program(cfg, 16, 4)
        else:
            io = mod.build_full_forward_program(cfg)
    return main, startup, io


def _both(which):
    t = _build(which, Program, program_guard, tun, tmodel, tmodel.decoder_tiny())
    j = _build(which, JProgram, jguard, jun, jmodel, jmodel.decoder_tiny())
    return t, j


@pytest.mark.parametrize("which", BUILDERS)
def test_serving_program_ops_identical(which):
    (tm, _, _), (jm, _, _) = _both(which)
    assert tm.to_dict()["blocks"][0]["ops"] == jm.to_dict()["blocks"][0]["ops"]


@pytest.mark.parametrize("which", BUILDERS)
def test_serving_program_vars_identical(which):
    """Every var's shape (the -1 batch included, through fc's
    num_flatten_dims and reshape2's 0 dims) and dtype agree."""
    (tm, _, _), (jm, _, _) = _both(which)
    assert tm.to_dict()["blocks"][0]["vars"] == jm.to_dict()["blocks"][0]["vars"]


@pytest.mark.parametrize("which", BUILDERS)
def test_startup_program_identical(which):
    (_, ts, _), (_, js, _) = _both(which)
    assert ts.to_dict() == js.to_dict()


def test_program_json_round_trips_across_packages():
    """A program serialized by the JAX package loads in the port (and back)
    unchanged."""
    _, (jm, _, _) = _both("decode")
    d = json.loads(json.dumps(jm.to_dict()))
    assert Program.from_dict(d).to_dict() == d
    assert JProgram.from_dict(Program.from_dict(d).to_dict()).to_dict() == d


def test_full_forward_matches_jax_on_carried_weights():
    """The dense oracle program run by both executors on the same weights:
    every op of the slice (lookup_table, layer_norm, mul, elementwise_add,
    reshape2, transpose2, slice, squeeze2, fused_attention, gelu) composed.
    Tolerance rtol 1e-4 / atol 1e-5: fp32 on both sides, sums reordered."""
    (tm, ts, tio), (jm, js, jio) = _both("full")
    js.random_seed = 3
    jscope = JScope()
    jexe = JExecutor()
    jexe.run(js, scope=jscope)
    scope, exe = Scope(), Executor(place="cpu")
    for p in tm.all_parameters():
        scope.set_var(p.name, torch.from_numpy(np.array(jscope.find_var(p.name))))
    rng = np.random.default_rng(0)
    feed = {tmodel.TOK_FEED: rng.integers(0, 97, (2, 13)).astype(np.int32),
            tmodel.POS_FEED: np.tile(np.arange(13, dtype=np.int32), (2, 1))}
    (want,) = jexe.run(jm, feed=feed, fetch_list=[jio["logits"]], scope=jscope)
    (got,) = exe.run(tm, feed=feed, fetch_list=[tio["logits"]], scope=scope)
    assert got.shape == (2, 13, 97)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_startup_draws_match_distribution_and_seed():
    """uniform_random draws from a generator keyed by the program seed: the
    same seed gives the same weights, another seed others, and the Xavier
    bound holds; fill_constant gives the layer-norm ones and bias zeros."""
    cfg = tmodel.decoder_tiny()

    def init(seed):
        _, startup, _ = _build("full", Program, program_guard, tun, tmodel, cfg)
        startup.random_seed = seed
        scope = Scope()
        Executor(place="cpu").run(startup, scope=scope, rng_counter=1)
        return scope

    a, b, c = init(0), init(0), init(1)
    w = a.find_var("dec.layer0.ffn.in.w")
    assert torch.equal(w, b.find_var("dec.layer0.ffn.in.w"))
    assert not torch.equal(w, c.find_var("dec.layer0.ffn.in.w"))
    limit = (6.0 / (cfg.hidden_size + cfg.ffn_size)) ** 0.5
    assert float(w.abs().max()) <= limit and float(w.std()) > limit / 3
    assert torch.equal(a.find_var("dec.emb_ln.scale"), torch.ones(cfg.hidden_size))
    assert torch.equal(a.find_var("dec.layer1.mha.qkv.b"),
                       torch.zeros(3 * cfg.hidden_size))


def test_feeds_narrow_to_32_bits():
    main = Program()
    with program_guard(main, Program()), tun.guard():
        from paddle_tpu_torch import layers as L

        x = L.data(name="ids", shape=[3], dtype="int64")
        y = L.argmax(L.reshape(x, shape=[0, 3]), axis=1)
    (got,) = Executor(place="cpu").run(
        main, feed={"ids": np.asarray([[1, 5, 2], [7, 7, 0]], np.int64)},
        fetch_list=[y], scope=Scope())
    assert got.dtype == np.int32 and got.tolist() == [1, 0]   # first max wins


def test_missing_state_raises_naming_the_variable():
    main, _, io = _build("full", Program, program_guard, tun, tmodel,
                         tmodel.decoder_tiny())
    feed = {tmodel.TOK_FEED: np.zeros((1, 4), np.int32),
            tmodel.POS_FEED: np.zeros((1, 4), np.int32)}
    with pytest.raises(RuntimeError, match="dec.word_emb"):
        Executor(place="cpu").run(main, feed=feed, fetch_list=[io["logits"]],
                                  scope=Scope())


def test_executor_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Executor()


def test_import_leaves_out_jax_and_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.ops.cuda_kernels, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.backward, paddle_tpu_torch.models.transformer, "
            "paddle_tpu_torch.weights, paddle_tpu_torch.clip, "
            "paddle_tpu_torch.regularizer, paddle_tpu_torch.passes, "
            "paddle_tpu_torch.models.resnet, paddle_tpu_torch.ops.vision_ops, "
            "paddle_tpu_torch.ops.cuda_kernels.bn_apply, "
            "paddle_tpu_torch.ops.cuda_kernels.bn_apply_bwd, "
            "paddle_tpu_torch.ops.cuda_kernels.bottleneck, "
            "paddle_tpu_torch.ops.cuda_kernels.flash_attention, "
            "paddle_tpu_torch.ops.cuda_kernels.flash_attention_bwd, "
            "paddle_tpu_torch.ops.cuda_kernels.attn_probe, "
            "paddle_tpu_torch.ops.cuda_kernels.dma_probe, "
            "paddle_tpu_torch.contrib.mixed_precision, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu', 'triton', 'tools')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_port_sources_never_import_jax_or_paddle_tpu():
    """Also no lazy import hidden in a function body, in the package or in
    chip_smoke.py: not of jax, the JAX package or its tools/."""
    files = list((REPO / "paddle_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {"flash_attention.py", "flash_attention_bwd.py", "attn_probe.py",
            "dma_probe.py", "bottleneck.py"} <= {f.name for f in files}
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "paddle_tpu", "tools"), \
                    f"{f}: {s}"
