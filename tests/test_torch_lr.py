"""The port's learning-rate schedules (paddle_tpu_torch/layers/
learning_rate_scheduler.py) and the ops they build with, held against the
JAX package's.

* Each of the eight schedules (with its staircase or cycle variant where
  it has one), linear_lr_warmup over polynomial_decay and over
  piecewise_decay: the programs equal the JAX package's through to_dict(),
  and the learning rate over 8 runs equals the JAX package's within rtol
  1e-6 (and, at 0, within 1e-6 of the schedule's largest rate: where
  polynomial decay ends at 0, XLA computes 1 - 6 / 6 as -2^-25, a
  reciprocal multiply fused into an FMA, where torch gives 0).
* The step counter: one increment however many schedules compose, no grad
  op for it after minimize, and the ValueError when schedules of different
  origins share a program.
* bert_tiny under decorate(Lamb(warmup + polynomial decay)): the rewritten
  program equals the JAX package's (the schedule's [1]-sized chain stays
  fp32), then 3 steps from the JAX startup's weights within the bf16 bands
  tests/test_torch_amp.py records for Adam.
"""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package runs on the CPU here)

import paddle_tpu as jpt
from paddle_tpu import unique_name as jun
from paddle_tpu.contrib import mixed_precision as jamp
from paddle_tpu.models import transformer as jtr
import paddle_tpu_torch as tpt
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.contrib import mixed_precision as tamp
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.weights import load_params

from __graft_entry__ import _example_feed

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

J = dict(pt=jpt, un=jun, amp=jamp, tr=jtr,
         L=importlib.import_module("paddle_tpu.layers"),
         exe=lambda: jpt.Executor(), scope=jpt.Scope)
T = dict(pt=tpt, un=tun, amp=tamp, tr=ttr,
         L=importlib.import_module("paddle_tpu_torch.layers"),
         exe=lambda: tpt.Executor(place="cpu"), scope=tpt.Scope)

SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 3),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(0.1, 3, 0.5, True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(0.1, 3, 0.5, True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(0.1, 3, 0.5,
                                                             True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 5, 1e-3, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 3, 1e-3, power=2.0,
                                                     cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 5], [0.1, 0.05, 0.01]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 6),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(0.1, 3, 0.01, 0.1),
    "warmup_polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(1e-4, decay_steps=6, end_learning_rate=0.0,
                           power=1.0),
        warmup_steps=2, start_lr=2e-5, end_lr=1e-4),
    "warmup_piecewise": lambda L: L.linear_lr_warmup(
        L.piecewise_decay([4, 6], [0.1, 0.05, 0.01]), 3, 0.01, 0.1),
}


def _schedule_program(pkg, which):
    pt = pkg["pt"]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pkg["un"].guard():
        lr = SCHEDULES[which](pkg["L"])
    return main, startup, lr


def _lrs(pkg, which, steps=8):
    main, startup, lr = _schedule_program(pkg, which)
    scope, exe = pkg["scope"](), pkg["exe"]()
    exe.run(startup, scope=scope)
    return main, startup, [float(np.asarray(exe.run(main, fetch_list=[lr],
                                                    scope=scope)[0])[0])
                           for _ in range(steps)]


@pytest.mark.parametrize("which", list(SCHEDULES))
def test_schedule_matches_jax_over_eight_steps(which):
    jm, js, want = _lrs(J, which)
    tm, ts, got = _lrs(T, which)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert [op.type for op in tm.global_block.ops].count("increment") == 1
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * max(abs(w) for w in want))
    assert len(set(got)) > 1


def test_bert_lamb_recipe_follows_its_closed_form():
    """chip_smoke's LAMB schedule (warmup 2e-5 -> 1e-4 over 2 steps, then
    linear decay to 0 at step 6) against the script's closed form:
    2e-5, 6e-5, 6.667e-5, 5e-5, 3.333e-5, ..."""
    _, _, got = _lrs(T, "warmup_polynomial")
    want = [chip_smoke._lamb_lr(s) for s in range(8)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(want[:5], [2e-5, 6e-5, 1e-4 * 2 / 3, 5e-5,
                                          1e-4 / 3], rtol=1e-12)


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_schedules_of_different_origins_cannot_share_a_program(pkg):
    pt, L = pkg["pt"], pkg["L"]
    with pt.program_guard(pt.Program(), pt.Program()), pkg["un"].guard():
        L.noam_decay(64, 3)
        with pytest.raises(ValueError, match="different step-counter origins"):
            L.exponential_decay(0.1, 3, 0.5)


# bf16 bands of tests/test_torch_amp.py (3 Adam steps of bert_tiny): both
# packages round the same tensors to bf16 at the same places, but their CPU
# products sum in other orders, and a product's bf16 rounding then differs
# by one unit of its last place here and there
LR_MAX, STEPS, B, S = 1e-3, 3, 4, 16


def _bert_lamb(pkg):
    pt, L = pkg["pt"], pkg["L"]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pkg["un"].guard():
        loss, _ = pkg["tr"].bert_pretrain(pkg["tr"].bert_tiny(use_tp=False),
                                          seq_len=S)
        lr = L.linear_lr_warmup(
            L.polynomial_decay(LR_MAX, decay_steps=6, end_learning_rate=0.0),
            warmup_steps=2, start_lr=2e-4, end_lr=LR_MAX)
        pkg["amp"].decorate(pt.optimizer.Lamb(learning_rate=lr,
                                              lamb_weight_decay=0.01)
                            ).minimize(loss)
    return main, startup, loss, lr


@pytest.fixture(scope="module")
def bert_lamb():
    (jm, js, jl, jlr), (tm, ts, tl, tlr) = _bert_lamb(J), _bert_lamb(T)
    feed = _example_feed(jtr.bert_tiny(use_tp=False), B, S)
    feed["lm_weight"] = (np.random.default_rng(1).random((B, S)) < 0.5
                         ).astype(np.float32)
    js.random_seed = 5
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    names = [p.name for p in jm.all_parameters()]
    tscope, texe = tpt.Scope(), tpt.Executor(place="cpu")
    texe.run(ts, scope=tscope)
    load_params(tscope, tm, {n: np.array(jscope.find_var(n)) for n in names})
    gnames = [n + "@GRAD" for n in names]
    out = {"programs": (jm, tm)}
    for key, exe, prog, loss, lr, scope in (
            ("jax", jexe, jm, jl, jlr, jscope),
            ("torch", texe, tm, tl, tlr, tscope)):
        losses, lrs, grads = [], [], None
        for step in range(STEPS):
            vals = exe.run(prog, feed=feed, scope=scope,
                           fetch_list=[loss.name, lr.name]
                           + (gnames if step == 0 else []))
            losses.append(float(np.asarray(vals[0])))
            lrs.append(float(np.asarray(vals[1])[0]))
            if step == 0:
                grads = {n: np.asarray(v, np.float32)
                         for n, v in zip(names, vals[2:])}
        params = {n: np.asarray(scope.find_var(n)) for n in names}
        out[key] = (losses, lrs, grads, params)
    return out


def test_bert_amp_lamb_program_equals_jax_and_keeps_the_schedule_fp32(
        bert_lamb):
    jm, tm = bert_lamb["programs"]
    assert tm.to_dict() == jm.to_dict()
    block = tm.global_block
    types = [op.type for op in block.ops]
    assert types.count("lamb") == len(tm.all_parameters())
    assert types.count("increment") == 1
    assert not any(t.startswith("increment_grad") for t in types)
    lr_name = next(op for op in block.ops if op.type == "lamb"
                   ).inputs["LearningRate"][0]
    chain = {"@LR_DECAY_COUNTER@", lr_name}
    for op in block.ops:          # the schedule's ops: before the forward
        if op.type == "lookup_table":
            break
        chain.update(op.output_names)
    for n in chain:
        assert block.var(n).dtype.value in ("float32", "bool"), n


def test_bert_amp_lamb_losses_and_learning_rates_agree(bert_lamb):
    """Step 1 reads the same weights: its loss agrees to 1e-4, the later
    ones within 2e-3; the learning rates are the same schedule."""
    jl, jlr = bert_lamb["jax"][:2]
    tl, tlr = bert_lamb["torch"][:2]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    np.testing.assert_allclose(tlr, jlr, rtol=1e-6)
    assert tl[2] < tl[0]


def test_bert_amp_lamb_step1_gradients_agree(bert_lamb):
    """Within 6e-2 of each gradient's max-abs and 4e-2 in relative L2, the
    bands of the Adam test."""
    jg, tg = bert_lamb["jax"][2], bert_lamb["torch"][2]
    assert sorted(tg) == sorted(jg)
    for n in jg:
        scale = max(float(np.abs(jg[n]).max()), 1e-12)
        assert float(np.abs(tg[n] - jg[n]).max()) <= 6e-2 * scale, n
        l2 = np.linalg.norm(tg[n] - jg[n]) / max(np.linalg.norm(jg[n]), 1e-12)
        assert l2 <= 4e-2, n


def test_bert_amp_lamb_params_agree_after_three_steps(bert_lamb):
    """fp32 master weights within 2 k lr (lr the schedule's largest), the
    Adam test's band: a LAMB step moves a weight by at most about lr."""
    jp, tp = bert_lamb["jax"][3], bert_lamb["torch"][3]
    for n in jp:
        assert tp[n].dtype == np.float32
        np.testing.assert_allclose(tp[n], jp[n], rtol=0,
                                   atol=2 * STEPS * LR_MAX, err_msg=n)
