"""The WMT Transformer-base training step of the port (paddle_tpu_torch)
held against the JAX package's (`paddle_tpu.models.transformer.transformer_wmt`,
bench.py's `bench_wmt`), on the CPU.

* The ops the slice adds, each against the JAX op on the same numpy inputs
  and cotangents through both packages' `gradients` sweeps and executors:
  matmul (transposes, alpha, batched broadcasting), softmax and its causal
  fused form, one_hot, label_smooth, the soft-label and ignore_index cross
  entropy, fused_attention with a Bias and with Sq != Sk (the torch
  composition of the JAX package's XLA arm), and dropout (its mask given,
  its keep rate, its repeat by seed and counter, its is_test branches).
* transformer_wmt at bench_wmt's CPU widths (vocab 256, hidden 64, 2 + 2
  layers, 4 heads, ffn 128), after Adam.minimize: the main and startup
  programs equal the JAX package's through to_dict(), with and without
  AMP, a source mask, dropout 0.1 and src_len != tgt_len; wmt_base() and
  bert_base() (dropout 0.1) build and equal the JAX programs too.
* Trajectories: 3 Adam steps from the JAX startup's weights on one batch,
  fp32 and AMP, and with dropout 0.1 for transformer_wmt and bert_tiny,
  where both packages' dropout computes are patched (in the test only) to
  take one numpy mask keyed by the op's output name.

Tolerances are stated where used: fp32 sums in another order, or the bf16
band tests/test_torch_amp.py holds bert_tiny's AMP trajectory to.
"""
import zlib

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU here)

import paddle_tpu as jpt
from paddle_tpu import backward as jbw
from paddle_tpu import unique_name as jun
from paddle_tpu.contrib import mixed_precision as jamp
from paddle_tpu.models import transformer as jtr
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as tpt
from paddle_tpu_torch import backward as tbw
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.contrib import mixed_precision as tamp
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.weights import load_params

from __graft_entry__ import _example_feed
from torch_threads import one_intra_op_thread  # noqa: F401

J = dict(pt=jpt, un=jun, bw=jbw, tr=jtr, amp=jamp, reg=jreg,
         exe=lambda: jpt.Executor(), scope=jpt.Scope)
T = dict(pt=tpt, un=tun, bw=tbw, tr=ttr, amp=tamp, reg=treg,
         exe=lambda: tpt.Executor(place="cpu"), scope=tpt.Scope)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _run_op(pkg, op_type, ins, outs, attrs, cots):
    """`op_type` over vars named as `ins` ({slot: {name: array}}) in a
    fresh program, its `outs` ({slot: [name]}) differentiated with the fed
    cotangents `cots` ({name: array}) by the package's `gradients`: the
    fetched outputs {name: array} and grads {input name: array}."""
    main = pkg["pt"].Program()
    with pkg["pt"].program_guard(main, pkg["pt"].Program()), pkg["un"].guard():
        block = main.global_block
        diff = []
        for names in ins.values():
            for n, a in names.items():
                flt = a.dtype.kind == "f" or str(a.dtype) == "bfloat16"
                v = block.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                                     stop_gradient=not flt)
                if flt:
                    diff.append(v)
        block.append_op(op_type, {s: list(d) for s, d in ins.items()}, outs,
                        attrs)
        gvars = []
        if cots:
            targets = [block.var(n) for n in cots]
            tgs = [block.create_var(name=n + "_cot", shape=cots[n].shape,
                                    dtype=str(cots[n].dtype)) for n in cots]
            gvars = pkg["bw"].gradients(targets, diff, tgs)
    feed = {n: a for d in ins.values() for n, a in d.items()}
    feed.update({n + "_cot": a for n, a in cots.items()})
    if pkg is T:    # numpy has no bfloat16: the port takes a bf16 tensor
        feed = {n: torch.from_numpy(a.astype(np.float32)).bfloat16()
                if str(a.dtype) == "bfloat16" else a for n, a in feed.items()}
    out_names = [n for ns in outs.values() for n in ns]
    fetch = out_names + [g for g in gvars if g is not None]
    vals = pkg["exe"]().run(main, feed=feed, fetch_list=fetch,
                            scope=pkg["scope"]())
    got = {n: np.asarray(v, np.float32) for n, v in zip(out_names, vals)}
    grads = {}
    for v, g in zip(diff, gvars):
        if g is not None:
            grads[v.name] = np.asarray(vals[fetch.index(g)], np.float32)
    return got, grads


def _hold(op_type, ins, outs, attrs, cot_shapes, rtol, atol=0.0, exact=()):
    """Outputs and input grads of both packages: rtol of each one's
    max-abs (atol absolute on top); the outputs named in `exact` bit for
    bit."""
    cots = {n: _rand(s, 100 + i) for i, (n, s) in enumerate(cot_shapes.items())}
    jo, jg = _run_op(J, op_type, ins, outs, attrs, cots)
    to, tg = _run_op(T, op_type, ins, outs, attrs, cots)
    assert sorted(tg) == sorted(jg)
    for n, want in list(jo.items()) + list(jg.items()):
        got = to.get(n, tg.get(n))
        if n in exact:
            np.testing.assert_array_equal(got, want, err_msg=n)
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= rtol * scale + atol, n
    return jo, to, jg, tg


# -- the ops ---------------------------------------------------------------------

MATMUL = [  # (x shape, y shape, transpose_X, transpose_Y, alpha)
    ((2, 3, 5, 4), (2, 3, 4, 6), False, False, 1.0),
    ((2, 3, 5, 4), (2, 3, 6, 4), False, True, 0.125),
    ((2, 3, 4, 5), (2, 3, 4, 6), True, False, 0.5),
    ((2, 3, 4, 5), (2, 3, 6, 4), True, True, -1.5),
    ((2, 3, 5, 4), (4, 6), False, False, 2.0),        # broadcast over batch
    ((3, 1, 5, 4), (2, 4, 6), False, False, 1.0),     # both broadcast
]


@pytest.mark.parametrize("xs,ys,tx,ty,alpha", MATMUL)
def test_matmul_and_its_grad_match_jax(xs, ys, tx, ty, alpha):
    """fp32: forward and both grads within 1e-5 of their max-abs."""
    x, y = _rand(xs, 1), _rand(ys, 2)
    out_shape = np.broadcast_shapes(xs[:-2], ys[:-2]) + (
        xs[-1] if tx else xs[-2], ys[-2] if ty else ys[-1])
    _hold("matmul", {"X": {"x": x}, "Y": {"y": y}}, {"Out": ["out"]},
          {"transpose_X": tx, "transpose_Y": ty, "alpha": alpha},
          {"out": out_shape}, rtol=1e-5)


@pytest.mark.parametrize("op_type", ["softmax",
                                     "softmax_mask_fuse_upper_triangle"])
def test_softmax_and_its_causal_form_match_jax(op_type):
    """fp32: the probabilities and their grad within 1e-5 of max-abs; the
    causal form's entries above the diagonal are zero."""
    x = _rand((2, 3, 6, 6), 3, 3.0)
    attrs = {"axis": -1} if op_type == "softmax" else {}
    _, to, _, _ = _hold(op_type, {"X": {"x": x}}, {"Out": ["out"]}, attrs,
                        {"out": x.shape}, rtol=1e-5)
    if op_type != "softmax":
        assert not to["out"][..., np.triu_indices(6, 1)[0],
                             np.triu_indices(6, 1)[1]].any()


@pytest.mark.parametrize("trailing_one", [False, True])
def test_one_hot_matches_jax_exactly(trailing_one):
    """Ids in range and out of it (-1, depth): fp32 rows, exact."""
    ids = np.array([[0, 3, 9, -1], [10, 5, 5, 2]], np.int32)
    if trailing_one:
        ids = ids[..., None]
    jo, to, _, _ = _hold("one_hot", {"X": {"ids": ids}}, {"Out": ["out"]},
                         {"depth": 10}, {}, rtol=0, exact=("out",))
    assert to["out"].shape == (2, 4, 10) and to["out"].sum() == 6


@pytest.mark.parametrize("prior", [False, True])
def test_label_smooth_matches_jax_exactly(prior):
    label = (np.random.default_rng(4).random((3, 5, 7)) < 0.3).astype(np.float32)
    ins = {"X": {"label": label}}
    if prior:
        ins["PriorDist"] = {"prior": np.random.default_rng(5).dirichlet(
            np.ones(7), 1).astype(np.float32)}
    _hold("label_smooth", ins, {"Out": ["out"]}, {"epsilon": 0.1}, {},
          rtol=0, exact=("out",))


@pytest.mark.parametrize("case", ["soft_label", "ignore_index"])
def test_cross_entropy_options_match_jax(case):
    """Soft labels (a smoothed one-hot) and hard labels with ignore_index
    (some rows at it): the loss, the softmax and the logits' grad within
    1e-5 of their max-abs."""
    logits = _rand((2, 5, 300), 6, 3.0)
    lab = np.random.default_rng(7).integers(0, 300, (2, 5)).astype(np.int32)
    if case == "soft_label":
        label = np.full((2, 5, 300), 0.1 / 300, np.float32)
        np.put_along_axis(label, lab[..., None], 0.9 + 0.1 / 300, axis=-1)
        attrs = {"soft_label": True, "ignore_index": -100}
    else:
        lab[0, 1] = lab[1, 3] = 7
        label = lab[..., None]
        attrs = {"soft_label": False, "ignore_index": 7}
    _, to, _, _ = _hold(
        "softmax_with_cross_entropy",
        {"Logits": {"logits": logits}, "Label": {"label": label}},
        {"Softmax": ["sm"], "Loss": ["loss"]}, attrs, {"loss": (2, 5, 1)},
        rtol=1e-5)
    if case == "ignore_index":
        assert to["loss"][0, 1, 0] == 0 and to["loss"][1, 3, 0] == 0


ATTN = [  # (Sq, Sk, causal, bias shape or None)
    (12, 12, False, (2, 1, 1, 12)),     # the source-mask bias
    (12, 12, True, (2, 3, 12, 12)),
    (12, 20, False, None),              # cross-attention, src_len > tgt_len
    (20, 12, False, None),
    (12, 20, True, None),               # causal, aligned to the last key
    (12, 20, False, (2, 1, 1, 20)),
]


@pytest.mark.parametrize("sq,sk,causal,bias", ATTN)
def test_fused_attention_with_a_bias_or_sq_ne_sk_matches_jax(sq, sk, causal,
                                                              bias):
    """The torch composition of the JAX package's XLA arm, fp32: Out and
    the Q, K, V (and Bias) grads within 1e-5 of their max-abs."""
    dh = 8
    ins = {"Q": {"q": _rand((2, 3, sq, dh), 8)},
           "K": {"k": _rand((2, 3, sk, dh), 9)},
           "V": {"v": _rand((2, 3, sk, dh), 10)}}
    if bias:
        b = -1e9 * (np.random.default_rng(11).random(bias) < 0.2)
        ins["Bias"] = {"bias": (b + _rand(bias, 12)).astype(np.float32)}
    _hold("fused_attention", ins, {"Out": ["out"]},
          {"causal": causal, "sm_scale": dh ** -0.5, "use_pallas": False},
          {"out": (2, 3, sq, dh)}, rtol=1e-5)


def test_fused_attention_past_the_xla_arm_raises():
    q = np.zeros((1, 1, 1100, 8), np.float32)
    k = np.zeros((1, 1, 1000, 8), np.float32)
    with pytest.raises(Exception, match="domain item 5"):
        _run_op(T, "fused_attention", {"Q": {"q": q}, "K": {"k": k},
                                       "V": {"v": k}},
                {"Out": ["out"]}, {"causal": False, "sm_scale": 1.0,
                                   "use_pallas": False}, {})


DROP_ATTRS = {"dropout_prob": 0.1, "is_test": False, "seed": 0,
              "dropout_implementation": "upscale_in_train"}


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_given_the_same_mask_matches_jax_exactly(monkeypatch, impl,
                                                         dtype):
    """The JAX op draws its mask; the port's draw is made to keep the same
    elements (torch.rand patched in the test only): Mask and Out bit for
    bit, in fp32 and bf16, and X@GRAD = dOut * Mask exactly (bit for bit
    with the JAX op's in fp32)."""
    x = _rand((4, 8, 16), 13)
    attrs = dict(DROP_ATTRS, dropout_implementation=impl, dropout_prob=0.3)
    ins = {"X": {"x": x.astype(jax.numpy.bfloat16) if dtype == "bfloat16"
                 else x}}
    cots = {"out": _rand(x.shape, 14)}
    outs = {"Out": ["out"], "Mask": ["mask"]}
    jo, jg = _run_op(J, "dropout", ins, outs, attrs, cots)
    kept = jo["mask"] != 0
    assert 0 < kept.mean() < 1
    rand = torch.rand

    def draw(shape, generator=None, device=None, dtype=None):
        assert generator is not None
        return torch.where(torch.from_numpy(kept), 0.0, 0.95)
    monkeypatch.setattr(torch, "rand", draw)
    to, tg = _run_op(T, "dropout", ins, outs, attrs, cots)
    monkeypatch.setattr(torch, "rand", rand)
    for n in ("out", "mask"):
        np.testing.assert_array_equal(to[n], jo[n], err_msg=n)
    np.testing.assert_array_equal(tg["x"], cots["out"] * to["mask"])
    if dtype == "float32":
        np.testing.assert_array_equal(tg["x"], jg["x"])
    else:
        # XLA fuses the bf16 mask's division into the grad's product and
        # skips its rounding there (the fetched Mask is rounded): the JAX
        # grad is dOut / bf16(1 - p), within a bf16 spacing of dOut * Mask
        np.testing.assert_allclose(tg["x"], jg["x"], rtol=2.0 ** -8)
    vals = set(np.unique(to["mask"]).tolist())
    keep_val = 1.0 if impl == "downgrade_in_infer" else float(
        torch.tensor(1.0, dtype=getattr(torch, dtype))
        / torch.tensor(0.7, dtype=getattr(torch, dtype)))
    assert vals == {0.0, keep_val}


def _dropout_program(shape, attrs, dtype="float32"):
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()), tun.guard():
        x = tpt.layers.data(name="x", shape=list(shape[1:]), dtype=dtype)
        out = tpt.layers.dropout(x, attrs["dropout_prob"],
                                 is_test=attrs["is_test"],
                                 dropout_implementation=attrs[
                                     "dropout_implementation"])
    mask = next(op.outputs["Mask"][0] for op in main.global_block.ops
                if op.type == "dropout")
    return main, out, mask


def test_dropout_keep_rate_and_repeat_by_seed_and_counter():
    """Over 1e6 elements the keep rate lies within 5 binomial sigmas of
    0.9; the same (program seed, run counter) repeats the mask bit for bit,
    a new counter or seed draws another; torch's global stream is not
    read or moved."""
    shape = (1000, 1000)
    main, out, mask = _dropout_program(shape, DROP_ATTRS)
    main.random_seed = 3
    x = np.ones(shape, np.float32)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    state = torch.get_rng_state()
    m1, o1 = exe.run(main, feed={"x": x}, fetch_list=[mask, out], scope=scope,
                     rng_counter=7)
    assert torch.equal(torch.get_rng_state(), state)
    n, keep = m1.size, float((m1 != 0).sum())
    assert abs(keep - 0.9 * n) <= 5 * (n * 0.9 * 0.1) ** 0.5
    assert set(np.unique(m1).tolist()) == {0.0, float(np.float32(1) /
                                                       np.float32(0.9))}
    np.testing.assert_array_equal(o1, x * m1)
    (m2,) = exe.run(main, feed={"x": x}, fetch_list=[mask], scope=scope,
                    rng_counter=7)
    np.testing.assert_array_equal(m2, m1)
    (m3,) = exe.run(main, feed={"x": x}, fetch_list=[mask], scope=scope,
                    rng_counter=8)
    assert (m3 != m1).mean() > 0.1
    main.random_seed = 4
    (m4,) = exe.run(main, feed={"x": x}, fetch_list=[mask], scope=scope,
                    rng_counter=7)
    assert (m4 != m1).mean() > 0.1


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_is_test_branches_match_jax(impl):
    """is_test: Out = X (upscale_in_train) or X (1 - p) rounded in X's
    dtype, Mask ones; exact against the JAX op."""
    x = _rand((3, 7), 15)
    attrs = dict(DROP_ATTRS, is_test=True, dropout_implementation=impl)
    _hold("dropout", {"X": {"x": x}}, {"Out": ["out"], "Mask": ["mask"]},
          attrs, {}, rtol=0, exact=("out", "mask"))


# -- the programs ------------------------------------------------------------------

CPU_WMT = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               ffn_size=128, max_position=64, dropout=0.0, use_tp=False)
LR, STEPS, B = 1e-3, 3, 8


def _build_wmt(pkg, cfg=None, amp=False, **kw):
    main, startup = pkg["pt"].Program(), pkg["pt"].Program()
    with pkg["pt"].program_guard(main, startup), pkg["un"].guard():
        tr = pkg["tr"]
        cfg = tr.TransformerConfig(**CPU_WMT) if cfg is None else cfg
        loss, _ = tr.transformer_wmt(cfg, **kw)
        opt = pkg["pt"].optimizer.Adam(learning_rate=LR)
        (pkg["amp"].decorate(opt) if amp else opt).minimize(loss)
    return main, startup, loss


PROGRAMS = {
    "fp32": ({}, {}),
    "amp": ({}, {"amp": True}),
    "src_mask": ({}, {"use_src_mask": True}),
    "dropout": ({"dropout": 0.1}, {}),
    "src_len_ne_tgt_len": ({}, {"src_len": 16, "tgt_len": 12}),
    "amp_dropout_mask_12_16": ({"dropout": 0.1}, {
        "amp": True, "use_src_mask": True, "src_len": 12, "tgt_len": 16}),
    "hard_label": ({}, {"label_smooth_eps": 0}),
}


@pytest.mark.parametrize("case", list(PROGRAMS))
def test_wmt_programs_equal_jax(case):
    """The main program op for op and var for var (shapes and dtypes),
    and the startup program."""
    over, kw = PROGRAMS[case]
    kw = {"src_len": 16, "tgt_len": 16, **kw}
    progs = []
    for pkg in (J, T):
        cfg = pkg["tr"].TransformerConfig(**{**CPU_WMT, **over})
        progs.append(_build_wmt(pkg, cfg, **kw))
    (jm, js, _), (tm, ts, _) = progs
    jd, td = jm.to_dict(), tm.to_dict()
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    assert td == jd
    assert ts.to_dict() == js.to_dict()
    types = [op.type for op in tm.global_block.ops]
    assert types.count("dropout") == (2 * 4 + 2 * 6 + 2 if over else 0)
    assert ("label_smooth" in types) == (kw.get("label_smooth_eps") != 0)


@pytest.mark.parametrize("which", ["wmt_base", "bert_base"])
def test_published_configs_with_dropout_build_as_in_jax(which):
    """wmt_base() and bert_base() as published (dropout 0.1): the forward
    programs equal the JAX package's through to_dict()."""
    progs = []
    for pkg in (J, T):
        main = pkg["pt"].Program()
        with pkg["pt"].program_guard(main, pkg["pt"].Program()), pkg["un"].guard():
            tr = pkg["tr"]
            if which == "wmt_base":
                tr.transformer_wmt(tr.wmt_base(), src_len=32, tgt_len=32)
            else:
                tr.bert_pretrain(tr.bert_base(), seq_len=32)
        progs.append(main.to_dict())
    assert progs[1] == progs[0]
    types = [op["type"] for op in progs[1]["blocks"][0]["ops"]]
    # 4 an encoder layer, 6 a decoder layer, one an embedding
    assert types.count("dropout") == (6 * 4 + 6 * 6 + 2 if which == "wmt_base"
                                      else 12 * 4 + 1)


# -- the trajectories ---------------------------------------------------------------


def _wmt_feed(cfg, src_len=16, tgt_len=16):
    """bench_wmt's feed form, seeded; tgt_weight zero at a few positions."""
    rng = np.random.default_rng(0)
    feed = {
        "src_ids": rng.integers(0, cfg["vocab_size"], (B, src_len)),
        "src_pos": np.tile(np.arange(src_len), (B, 1)),
        "tgt_ids": rng.integers(0, cfg["vocab_size"], (B, tgt_len)),
        "tgt_pos": np.tile(np.arange(tgt_len), (B, 1)),
        "tgt_label": rng.integers(0, cfg["vocab_size"], (B, tgt_len)),
    }
    feed = {k: v.astype(np.int32) for k, v in feed.items()}
    feed["tgt_weight"] = (rng.random((B, tgt_len)) < 0.9).astype(np.float32)
    return feed


def _masks_by_name():
    """A dropout compute for each package that takes one numpy mask keyed
    by the op's Out name (kept at 0.9, 1 / 0.9 in fp32), and those masks."""
    masks = {}

    def mask_for(name, shape):
        key = (name, tuple(shape))
        if key not in masks:
            rng = np.random.default_rng(zlib.crc32(name.encode()))
            keep = rng.random(shape) < 0.9
            masks[key] = keep.astype(np.float32) / np.float32(0.9)
        return masks[key]

    def jax_compute(ctx):
        import jax.numpy as jnp
        x = ctx.input("X")
        m = jnp.asarray(mask_for(ctx.op.outputs["Out"][0], x.shape), x.dtype)
        return {"Out": x * m, "Mask": m}

    def torch_compute(ctx):
        x = ctx.input("X")
        if ctx.is_meta:
            return {"Out": torch.empty_like(x), "Mask": torch.empty_like(x)}
        m = torch.from_numpy(mask_for(ctx.op.outputs["Out"][0],
                                      tuple(x.shape))).to(x.dtype)
        return {"Out": x * m, "Mask": m}
    return jax_compute, torch_compute, masks


def _trajectory(build, feed):
    """STEPS Adam steps of each package's program from the JAX startup's
    weights on one batch: {pkg: (losses, step-1 grads, final params)}."""
    (jm, js, jl), (tm, ts, tl) = build(J), build(T)
    js.random_seed = 5
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    names = [p.name for p in jm.all_parameters()]
    tscope, texe = tpt.Scope(), tpt.Executor(place="cpu")
    texe.run(ts, scope=tscope)
    load_params(tscope, tm, {n: np.array(jscope.find_var(n)) for n in names})
    gnames = [n + "@GRAD" for n in names]
    out = {}
    for key, exe, prog, loss, scope in (("jax", jexe, jm, jl, jscope),
                                        ("torch", texe, tm, tl, tscope)):
        losses, grads = [], None
        for step in range(STEPS):
            vals = exe.run(prog, feed=feed, scope=scope,
                           fetch_list=[loss.name] + (gnames if step == 0 else []))
            losses.append(float(np.asarray(vals[0])))
            if step == 0:
                grads = {n: np.asarray(v, np.float32)
                         for n, v in zip(names, vals[1:])}
        params = {n: np.asarray(scope.find_var(n)) for n in names}
        out[key] = (losses, grads, params)
    return out


def _hold_fp32(traj):
    """Losses rtol 1e-4 and falling; step-1 grads within 1e-4 of their
    max-abs; parameters within 2 k lr (Adam moves a weight about lr a step
    whatever its gradient's size), as tests/test_torch_training.py holds
    bert_tiny."""
    (jl, jg, jp), (tl, tg, tp) = traj["jax"], traj["torch"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]
    assert sorted(tg) == sorted(jg)
    for n in jg:
        scale = max(float(np.abs(jg[n]).max()), 1e-12)
        assert float(np.abs(tg[n] - jg[n]).max()) <= 1e-4 * scale, n
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=0, atol=2 * STEPS * LR,
                                   err_msg=n)


@pytest.fixture(scope="module")
def wmt_fp32():
    return _trajectory(lambda pkg: _build_wmt(pkg, src_len=16, tgt_len=16),
                       _wmt_feed(CPU_WMT))


def test_wmt_fp32_losses_agree_over_three_adam_steps(wmt_fp32):
    jl, tl = wmt_fp32["jax"][0], wmt_fp32["torch"][0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]


def test_wmt_fp32_step1_gradients_and_params_agree(wmt_fp32):
    """Every step-1 grad within 1e-4 of its max-abs (the shared word
    embedding's two partial grads summed through @RENAME@ temporaries, the
    encoder's K/V projections reached only through cross-attention), the
    parameters within 2 k lr after three steps."""
    _hold_fp32(wmt_fp32)
    assert "word_emb" in wmt_fp32["torch"][1]
    assert np.abs(wmt_fp32["torch"][1]["dec.layer1.cross.kv.w"]).max() > 0


def test_wmt_fp32_trajectory_with_a_source_mask_and_src_len_ne_tgt_len():
    """src_len 16, tgt_len 12, a source mask with padding: the masked
    self-attention and cross-attention take the unfused ops (scores
    matmul, bias add, softmax, matmul), both packages alike."""
    feed = _wmt_feed(CPU_WMT, 16, 12)
    feed["src_mask"] = np.ones((B, 16), np.float32)
    feed["src_mask"][:, 13:] = 0
    _hold_fp32(_trajectory(lambda pkg: _build_wmt(
        pkg, src_len=16, tgt_len=12, use_src_mask=True), feed))


def test_wmt_cross_attention_with_src_len_ne_tgt_len_on_fused_attention():
    """No mask, no dropout, src_len 20 != tgt_len 12: cross-attention is
    one fused_attention op with Sq != Sk (the composed arm), both
    packages alike over three steps."""
    _hold_fp32(_trajectory(lambda pkg: _build_wmt(pkg, src_len=20,
                                                   tgt_len=12),
                           _wmt_feed(CPU_WMT, 20, 12)))


@pytest.fixture(scope="module")
def wmt_amp():
    return _trajectory(lambda pkg: _build_wmt(pkg, amp=True, src_len=16,
                                              tgt_len=16),
                       _wmt_feed(CPU_WMT))


def test_wmt_amp_trajectory_within_the_bf16_band(wmt_amp):
    """tests/test_torch_amp.py's band for bert_tiny under AMP: the losses
    within 2e-3 and falling; every step-1 grad fp32, within 6e-2 of its
    max-abs and 4e-2 in relative L2; the fp32 master weights within 2 k lr.
    The step-1 loss is held to 5e-4, where bert_tiny's is held to 1e-4
    (measured here 2.4e-4): its logits pass 4 layers and 6 attentions, each
    a bf16 rounding apart by construction (the port's K2 keeps fp32 scores
    and casts the unnormalized weights, the JAX package's XLA arm rounds
    the scores to bf16), 8.5e-3 apart in relative L2 at the logits, and
    each token's loss is rounded to bf16 (a spacing of 2^-5 at 5.7)."""
    (jl, jg, jp), (tl, tg, tp) = wmt_amp["jax"], wmt_amp["torch"]
    np.testing.assert_allclose(tl[0], jl[0], rtol=5e-4)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[2] < tl[0]
    assert sorted(tg) == sorted(jg)
    for n in jg:
        assert tg[n].dtype == np.float32
        scale = max(float(np.abs(jg[n]).max()), 1e-12)
        assert float(np.abs(tg[n] - jg[n]).max()) <= 6e-2 * scale, n
        l2 = np.linalg.norm(tg[n] - jg[n]) / max(np.linalg.norm(jg[n]), 1e-12)
        assert l2 <= 4e-2, n
    for n in jp:
        assert tp[n].dtype == np.float32
        np.testing.assert_allclose(tp[n], jp[n], rtol=0, atol=2 * STEPS * LR,
                                   err_msg=n)


@pytest.mark.parametrize("model", ["wmt", "bert_tiny"])
def test_dropout_trajectories_agree_given_the_same_masks(monkeypatch, model):
    """Dropout 0.1 in every place the JAX builders put it, both packages'
    dropout computes patched (here only) to take one numpy mask keyed by
    the op's output name: the fp32 trajectory as without dropout."""
    jax_compute, torch_compute, masks = _masks_by_name()
    monkeypatch.setattr(jreg.get_op_def("dropout"), "compute", jax_compute)
    monkeypatch.setattr(treg.get_op_def("dropout"), "compute", torch_compute)
    if model == "wmt":
        cfg = dict(CPU_WMT, dropout=0.1)

        def build(pkg):
            return _build_wmt(pkg, pkg["tr"].TransformerConfig(**cfg),
                              src_len=16, tgt_len=16)
        feed = _wmt_feed(cfg)
    else:
        def build(pkg):
            main, startup = pkg["pt"].Program(), pkg["pt"].Program()
            with pkg["pt"].program_guard(main, startup), pkg["un"].guard():
                tr = pkg["tr"]
                c = tr.bert_tiny(use_tp=False)
                c.dropout = 0.1
                loss, _ = tr.bert_pretrain(c, seq_len=16)
                pkg["pt"].optimizer.Adam(learning_rate=LR).minimize(loss)
            return main, startup, loss
        feed = _example_feed(jtr.bert_tiny(use_tp=False), 4, 16)
        feed["lm_weight"] = (np.random.default_rng(1).random((4, 16)) < 0.5
                             ).astype(np.float32)
    _hold_fp32(_trajectory(build, feed))
    assert len({k[0] for k in masks}) == (22 if model == "wmt" else 9)
