"""The port's autotuner (paddle_tpu_torch/tuning/) held against the JAX
package's on the CPU: the decision DB both ways across the packages, the
tiers and provenance of `decide`, the lever wirings (the attention route,
conv+BN fusion, the tiered embeddings' slots, the AMP gray lists, feed
buckets), sweep mode's recorded keys, and the port's own contract: an
attention route resolves once per prepared program, its grad follows the
forward, and a route the port cannot run is refused or raises."""
import json
import os
import re
import warnings

import numpy as np
import pytest

import torch_parity as tp

import paddle_tpu.flags as jflags
import paddle_tpu_torch as tpt
import paddle_tpu_torch.flags as tflags
from paddle_tpu import tuning as jtuning
from paddle_tpu_torch import tuning as ttuning
from paddle_tpu_torch.ops import attention_ops as tattn

H100 = "NVIDIA H100 80GB HBM3"
TUNING_FLAGS = ("tuning_mode", "tuning_db", "tuning_explore_every",
                "tuning_record", "tuning_model", "tuning_measurements")
PORT_FLAGS = TUNING_FLAGS + ("attention_force_backend", "emb_hbm_budget_mb",
                             "emb_cache_slots")


def _reset():
    for t in (jtuning, ttuning):
        t.invalidate_db_cache()
        t.reset_provenance()
        t.policy._seen_candidates.clear()
        t.learned.invalidate_model_cache()
        t.learned.reset_counters()
        t.learned.explore.reset_state()


@pytest.fixture
def tuned(tmp_path):
    """Both packages in consult mode on one scratch DB path (not written
    yet); `set_both` sets flags in both; flags and caches restored after.
    The JAX package's epilogue pass is on, as the port's always is."""
    saved = (jflags.all_flags(), {k: tflags.get_flag(k) for k in PORT_FLAGS})
    db_path = str(tmp_path / "tuning_db.json")

    def set_both(values):
        jflags.set_flags(values)
        tflags.set_flags(values)

    set_both({"tuning_mode": "consult", "tuning_db": db_path})
    jflags.set_flags({"pallas_epilogue": "on"})
    _reset()
    yield db_path, set_both
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])
    _reset()


def _write_db(tuning, path, entries):
    db = tuning.TuningDB(path)
    for key, decision, src in entries:
        db.put(key, decision, source=src)
    db.save(path)
    _reset()


# -- the DB ---------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(jtuning, ttuning),
                                           (ttuning, jtuning)],
                         ids=["jax-to-port", "port-to-jax"])
def test_db_roundtrip_across_packages(tmp_path, writer, reader):
    """A DB file written by either package loads in the other, entry for
    entry, and the two packages write the same bytes."""
    files = []
    for i, t in enumerate((writer, reader)):
        p = str(tmp_path / f"w{i}" / "db.json")
        db = t.TuningDB(p)
        db.put("attention|b=2 nh=12 sq=512 sk=512 dh=64 causal=0|bfloat16|"
               + H100, {"backend": "flash_bundled"}, measured=t.evidence(
                   {"pallas_short": {"median_s": 2e-3, "band": 0.01},
                    "flash_bundled": {"median_s": 1e-3, "band": 0.02}}),
               note="explore: verdict=keep base=pallas_short")
        db.put("amp_list|op=pool2d|-|cpu", {"list": "white"})
        db.save()
        files.append(p)
        assert os.listdir(os.path.dirname(p)) == ["db.json"]
    assert open(files[0], "rb").read() == open(files[1], "rb").read()
    back = reader.TuningDB(files[0])
    assert back.entries == writer.TuningDB(files[0]).entries
    assert json.load(open(files[0]))["schema"] == reader.DB_SCHEMA


def test_candidate_put_never_clobbers_swept(tmp_path):
    db = ttuning.TuningDB(str(tmp_path / "db.json"))
    db.put("k", {"backend": "flash_bundled"}, source="swept")
    assert not db.put("k", {"backend": "pallas_short"}, source="candidate",
                      overwrite=False)
    assert db.lookup("k")["decision"] == {"backend": "flash_bundled"}


@pytest.mark.parametrize("payload", [
    "{corrupt json",
    json.dumps({"schema": 999, "entries": {}}),
    json.dumps(["not", "an", "object"]),
])
def test_bad_db_warns_and_degrades_to_empty(tmp_path, payload):
    p = str(tmp_path / "bad.json")
    open(p, "w").write(payload)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        db = ttuning.TuningDB(p)
    assert len(db) == 0
    assert any("falling back to the analytic" in str(x.message) for x in w)


# -- the tiers ------------------------------------------------------------

def test_decide_tiers_and_provenance_match_jax(tuned):
    """The same DB and the same calls give the same decisions, tiers and
    provenance in both packages: default, analytic, an exact hit, a
    candidate entry (no hit), a validate refusal, sweep-mode recording."""
    db_path, set_both = tuned
    key = "demo|shape|float32|cpu"
    cand = "demo|cand|float32|cpu"
    bad = "demo|bad|float32|cpu"
    _write_db(jtuning, db_path, [(key, {"x": 3}, "swept"),
                                 (cand, {"x": 9}, "candidate"),
                                 (bad, {"x": "bogus"}, "swept")])
    got = {}
    for t in (jtuning, ttuning):
        got[t] = [t.decide("demo", "demo|none|float32|cpu", default={"x": 1}),
                  t.decide("demo", "demo|none|float32|cpu",
                           prior=lambda: {"x": 2}),
                  t.decide("demo", key, prior=lambda: {"x": 2}),
                  t.decide("demo", cand, prior=lambda: {"x": 2}),
                  t.decide("demo", bad, prior=lambda: {"x": 2},
                           validate=lambda d: isinstance(d.get("x"), int)),
                  t.provenance_snapshot()]
    assert got[ttuning] == got[jtuning]
    assert got[ttuning][-1]["per_op"]["demo"] == {"db": 1, "analytic": 3,
                                                  "default": 1}
    set_both({"tuning_mode": "sweep"})
    for i, t in enumerate((jtuning, ttuning)):
        p = os.path.join(os.path.dirname(db_path), f"sweep{i}.json")
        (jflags if t is jtuning else tflags).set_flags({"tuning_db": p})
        assert t.decide("demo", "demo|s|float32|cpu",
                        prior=lambda: {"x": 5}) == ({"x": 5}, "analytic")
        assert json.load(open(p))["entries"]["demo|s|float32|cpu"] == {
            "decision": {"x": 5}, "source": "candidate",
            "note": "analytic resolution tier=analytic"}


SHAPE512 = (2, 12, 512, 64)


def _attn_key(shape, dtype="bfloat16", dev=H100):
    b, nh, s, dh = shape
    return ttuning.canonical_key(
        "attention", ttuning.attention_key(b, nh, s, s, dh, False), dtype, dev)


@pytest.mark.parametrize("verdict,shape,want", [
    ("xla", SHAPE512, ("pallas_short", "analytic")),
    ("flash_bundled", SHAPE512, ("flash_bundled", "db")),
    ("pallas_short128", SHAPE512, ("pallas_short128", "db")),
    ("pallas_short", (2, 12, 640, 64), ("flash_bundled", "analytic")),
    ("flash_bundled", (2, 12, 256, 40), ("pallas_short", "analytic")),
])
def test_validate_refuses_routes_the_port_cannot_run(tuned, monkeypatch,
                                                     verdict, shape, want):
    """On a CUDA-named key the port takes only a route it runs with hand
    kernels: an "xla" verdict, K2/K4 past S = 512 and K10/K11 at a head
    width they lack fall through to the prior, where the JAX package's
    validate takes all four names."""
    import torch

    db_path, _ = tuned
    monkeypatch.setattr(ttuning, "device_kind", lambda device=None: H100)
    _write_db(ttuning, db_path, [(_attn_key(shape), {"backend": verdict},
                                  "swept")])
    assert tattn.attention_backend(shape, torch.bfloat16) == want
    assert jtuning.decide("attention", _attn_key(shape), prior=lambda: {
        "backend": "xla"}, validate=lambda d: d.get("backend") in (
            "xla", "pallas_short", "pallas_short128", "flash_bundled")) == (
        {"backend": verdict}, "db")


@pytest.mark.parametrize("forced,shape", [("xla", SHAPE512),
                                          ("pallas_short", (2, 12, 640, 64))])
def test_a_forced_route_the_port_cannot_run_raises(tuned, forced, shape):
    import torch

    _, set_both = tuned
    tflags.set_flags({"attention_force_backend": forced})
    with pytest.raises(ValueError, match="FLAGS_attention_force_backend"):
        tattn.attention_backend(shape, torch.float32)
    tflags.set_flags({"attention_force_backend": "flash_bundled"})
    assert tattn.attention_backend(shape, torch.float32) == ("flash_bundled",
                                                             "forced")


# -- the lever wirings ---------------------------------------------------

def _conv_bn(pkg):
    L = pkg["L"]
    img = L.data(name="img", shape=[8, 8, 3], dtype="float32")
    c = L.conv2d(img, num_filters=4, filter_size=3, padding=1,
                 bias_attr=False, data_format="NHWC")
    c2 = L.conv2d(L.batch_norm(c, data_layout="NHWC"), num_filters=4,
                  filter_size=1, bias_attr=False, data_format="NHWC")
    loss = L.reduce_mean(L.batch_norm(c2, data_layout="NHWC"))
    pkg["pt"].optimizer.SGD(0.1).minimize(loss)
    return loss


def test_fusion_entry_retires_one_conv_shape_as_in_jax(tuned):
    """A swept {"fuse": false} for the 3x3 conv's declared shape keeps that
    pair unfused while the 1x1 pair fuses; the programs equal the JAX
    package's by to_dict()."""
    db_path, _ = tuned
    key = ttuning.canonical_key(
        "conv2d_bn_fusion",
        ttuning.conv_key(-1, 8, 8, 3, 4, 3, 3, [1, 1], [1, 1], "NHWC"),
        "float32", "cpu")
    _write_db(ttuning, db_path, [(key, {"fuse": False}, "swept")])
    (jm, js, _), (tm, ts, _) = (tp.build(p, _conv_bn) for p in (tp.J, tp.T))
    types = [op.type for op in tm.global_block.ops]
    assert types.count("conv2d_bn") == 1 and types.count("batch_norm") == 1
    assert tm.to_dict() == jm.to_dict()
    assert ttuning.provenance_snapshot()["per_op"]["conv2d_bn_fusion"] == \
        jtuning.provenance_snapshot()["per_op"]["conv2d_bn_fusion"] == \
        {"db": 1, "analytic": 1, "default": 0}


def test_amp_gray_entries_move_the_same_ops(tuned):
    """pool2d promoted to white, softmax demoted to black, every other gray
    op untouched, in both packages' lists."""
    from paddle_tpu.contrib.mixed_precision import fp16_lists as jl
    from paddle_tpu_torch.contrib.mixed_precision import fp16_lists as tl

    db_path, _ = tuned
    _write_db(ttuning, db_path, [
        (ttuning.canonical_key("amp_list", ttuning.amp_key(op), "-", "cpu"),
         {"list": to}, "swept") for op, to in (("pool2d", "white"),
                                               ("softmax", "black"))])
    for m in (jl, tl):
        base = m.AutoMixedPrecisionLists()
        got = m.apply_tuning_overrides(m.AutoMixedPrecisionLists())
        assert got.white_list - base.white_list == {"pool2d"}
        assert got.black_list - base.black_list == {"softmax"}
        assert base.gray_list - got.gray_list == {"pool2d", "softmax"}


@pytest.mark.parametrize("entry,raw,default,want", [
    (12, 9, 16, 12), (4, 9, 16, 16), (None, 5, 8, 8)],
    ids=["refined", "below-raw-refused", "no-entry"])
def test_bucket_extent_matches_jax(tuned, entry, raw, default, want):
    from paddle_tpu.data_feeder import _tuned_extent as jext
    from paddle_tpu_torch.data_feeder import _tuned_extent as text

    db_path, _ = tuned
    if entry is not None:
        _write_db(ttuning, db_path, [(ttuning.canonical_key(
            "feed_bucket", ttuning.bucket_key("rx", 1, raw), "-", "cpu"),
            {"pad_to": entry}, "swept")])
    assert text("rx", 1, raw, default) == jext("rx", 1, raw, default) == want


def _tiered(pkg):
    from paddle_tpu.param_attr import ParamAttr as JAttr
    from paddle_tpu_torch.param_attr import ParamAttr as TAttr

    L = pkg["L"]
    ids = L.data(name="ids", shape=[6], dtype="int64")
    label = L.data(name="label", shape=[1], dtype="float32")
    emb = L.embedding(ids, size=[512, 8], is_sparse=True, param_attr=(
        JAttr if pkg is tp.J else TAttr)(name="tbl"))
    logit = L.fc(L.reduce_sum(emb, dim=1), size=1)
    loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
    pkg["pt"].optimizer.SGD(0.1).minimize(loss)
    return loss


def test_tiered_cache_geometry_resolves_through_the_db(tuned):
    """The port's counterpart of tests/test_tiered_embedding.py:307: a
    swept embedding verdict sets the slots and the prefetch width, as in
    the JAX package, and the rewritten programs stay equal."""
    db_path, set_both = tuned
    key = ttuning.canonical_key(
        "embedding", ttuning.embedding_key("tbl", 512, 8), "float32", "cpu")
    _write_db(ttuning, db_path, [(key, {"slots": 192, "prefetch_rows": 64},
                                  "swept")])
    set_both({"emb_hbm_budget_mb": 0.001, "emb_cache_slots": 0})
    (jm, _, _), (tm, _, _) = (tp.build(p, _tiered) for p in (tp.J, tp.T))
    for m in (jm, tm):
        t = m._tiered_engine.tables["tbl"]
        assert (t.slots, t.prefetch_rows) == (192, 64)
    assert tm.to_dict() == jm.to_dict()


def _attn_amp(pkg, S=8, nh=2, dh=64):
    """A tiny attention block under AMP: fc -> q, k, v [B, nh, S, dh] ->
    fused_attention -> mean, decorate(Adam)."""
    L = pkg["L"]
    x = L.data(name="x", shape=[S, nh * dh], dtype="float32")
    heads = []
    for i in range(3):
        h = L.fc(x, size=nh * dh, num_flatten_dims=2)
        heads.append(L.transpose(L.reshape(h, [0, S, nh, dh]), [0, 2, 1, 3]))
    out = L.fused_attention(*heads)
    loss = L.mean(out)
    pkg["pt"].contrib.mixed_precision.decorate(
        pkg["pt"].optimizer.Adam(1e-3)).minimize(loss)
    return loss


def test_sweep_mode_records_the_same_keys(tuned, tmp_path):
    """One sweep over the same programs and feeds in each package records
    the same attention, AMP, bucket, fusion and embedding keys. Left out
    of the JAX package's set: the keys its shape inference consults at
    build time (batch 8191, its dynamic-batch sentinel: attention and conv
    lowering keys; the port's shape inference consults nothing) and its
    epilogue keys (the port has one route on the card for the epilogue
    kernels and does not consult)."""
    _, set_both = tuned
    set_both({"tuning_mode": "sweep", "emb_hbm_budget_mb": 0.001,
              "emb_cache_slots": 0})
    feed = {"x": np.random.default_rng(0).standard_normal(
        (3, 8, 128)).astype(np.float32)}
    keys = {}
    for pkg, t, f in ((tp.J, jtuning, jflags), (tp.T, ttuning, tflags)):
        path = str(tmp_path / f"{pkg['name']}.json")
        f.set_flags({"tuning_db": path})
        t.invalidate_db_cache()
        m, s, loss = tp.build(pkg, _attn_amp)
        exe, scope = pkg["exe"](), pkg["scope"]()
        exe.run(s, scope=scope)
        exe.run(m, feed=feed, fetch_list=[loss], scope=scope)
        tp.build(pkg, _conv_bn)
        tp.build(pkg, _tiered)
        x = pkg["L"].data(name="bx", shape=[2], dtype="float32")
        pkg["pt"].DataFeeder([x], bucket_size=4).feed(
            [(np.zeros(2, np.float32),)] * 3)
        keys[pkg["name"]] = set(json.load(open(path))["entries"])
    want = {k for k in keys["jax"] if not k.startswith("epilogue|")
            and not re.search(r"\b[bn]=8191 ", k)}
    assert keys["torch"] == want
    assert {k.split("|")[0] for k in want} == {
        "attention", "amp_list", "feed_bucket", "conv2d_bn_fusion",
        "embedding"}


# -- the port's attention record ---------------------------------------------

def _attn_fp32(pkg, S=8, nh=2, dh=64):
    L = pkg["L"]
    q, k, v = (L.data(name=n, shape=[nh, S, dh], dtype="float32",
                      stop_gradient=False) for n in "qkv")
    out = L.fused_attention(L.scale(q, 1.0), k, v)
    return L.mean(out)


def test_route_resolves_once_per_prepared_program_and_grad_follows(
        tuned, monkeypatch):
    """The forward resolves its key at its first run in a prepared program
    and its grad op reads that record: a DB verdict changed between runs
    moves neither until `invalidate_cache`, and the grad always takes the
    forward's pair (K11 after K10, K4 after K2)."""
    db_path, _ = tuned
    main, startup, loss = tp.build(tp.T, _attn_fp32)
    with tpt.program_guard(main, startup):
        grads = tpt.gradients(loss, [main.global_block.var(n) for n in "qkv"])
    key = _attn_key((2, 2, 8, 64), "float32", "cpu")
    calls = []
    for name in ("causal_prefill_attention", "flash_attention_fwd",
                 "attention_backward", "flash_attention_backward"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    rng = np.random.default_rng(0)
    feed = {n: rng.standard_normal((2, 2, 8, 64)).astype(np.float32)
            for n in "qkv"}
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()

    def run():
        calls.clear()
        exe.run(main, feed=feed, fetch_list=[loss] + grads, scope=scope)
        return list(calls)

    _write_db(ttuning, db_path, [(key, {"backend": "flash_bundled"}, "swept")])
    assert run() == ["flash_attention_fwd", "flash_attention_backward"]
    _write_db(ttuning, db_path, [(key, {"backend": "pallas_short"}, "swept")])
    assert run() == ["flash_attention_fwd", "flash_attention_backward"]
    exe.invalidate_cache(main)
    assert run() == ["causal_prefill_attention", "attention_backward"]
    # since the second write (which reset the counters): two runs, one
    # resolution
    assert ttuning.provenance_snapshot()["per_op"]["attention"] == {
        "db": 1, "analytic": 0, "default": 0}
    # the two routes compute one function
    tflags.set_flags({"attention_force_backend": "flash_bundled"})
    exe.invalidate_cache()
    flash = exe.run(main, feed=feed, fetch_list=[loss] + grads, scope=scope)
    tflags.set_flags({"attention_force_backend": "pallas_short"})
    exe.invalidate_cache()
    short = exe.run(main, feed=feed, fetch_list=[loss] + grads, scope=scope)
    for a, b in zip(flash, short):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# -- chip_smoke's tuned phase, rehearsed on the CPU -----------------------------

TUNED_TINY = dict(BERT_BASE=dict(vocab_size=100, hidden_size=128, num_layers=2,
                                 num_heads=2, ffn_size=256, max_position=512,
                                 dropout=0.0, use_tp=False),
                  TUNED_B=2, TUNED_S=16, TUNED_STEPS=1)


@pytest.mark.parametrize("fault", [None, "k11_drops_dk"])
def test_tuned_phase_rehearsal(tuned, monkeypatch, fault):
    """chip_smoke.tuned_bert_long at 2 layers of 128 (heads of 64, so both
    routes run), B = 2, S = 16, on the kernels' plain versions (no launch
    counts on the CPU: their check is stubbed): explore, the probe, the
    consult step on the verdict, both forced routes held against each
    other. A K11 that returns a zero dK must be refused by that hold."""
    import chip_smoke

    for k, v in TUNED_TINY.items():
        monkeypatch.setattr(chip_smoke, k, v)
    monkeypatch.setattr(chip_smoke, "SMOKE_DATA", str(
        os.path.relpath(os.path.dirname(tuned[0]),
                        os.path.dirname(os.path.abspath(chip_smoke.__file__)))))
    monkeypatch.setattr(chip_smoke, "_check_tuned_launches", lambda *a: None)
    if fault:
        real = tattn.flash_attention_backward
        monkeypatch.setattr(tattn, "flash_attention_backward", lambda *a: (
            lambda g: (g[0], g[1].zero_(), g[2]))(real(*a)))
        with pytest.raises(RuntimeError, match="K2/K4 vs K10/K11"):
            chip_smoke.tuned_bert_long(tpt.executor.resolve_device("cpu"),
                                       "cpu")
        return
    chip_smoke.tuned_bert_long(tpt.executor.resolve_device("cpu"), "cpu")
    assert tflags.get_flag("tuning_mode") == "consult"   # the fixture's, back
