"""The port's learned tier (paddle_tpu_torch/tuning/learned/) held against
the JAX package's on the CPU: the features float for float, training to
byte-identical model files and equal predictions, the confidence gates
and fail-open cases with equal counters, explore's verdicts with stubbed
arms writing equal DB entries, and `Executor.run_async` driving a real
probe of an attention key (the port's two routes, on their plain versions
here)."""
import json
import warnings

import numpy as np
import pytest

import paddle_tpu.flags as jflags
import paddle_tpu_torch as tpt
import paddle_tpu_torch.flags as tflags
from paddle_tpu import tuning as jtuning
from paddle_tpu_torch import tuning as ttuning

PKGS = ((jtuning, jflags), (ttuning, tflags))
FLAG_NAMES = ("tuning_mode", "tuning_db", "tuning_measurements",
              "tuning_model", "tuning_explore_every", "tuning_record")


def _reset():
    for t, _ in PKGS:
        t.invalidate_db_cache()
        t.reset_provenance()
        t.policy._seen_candidates.clear()
        t.learned.invalidate_model_cache()
        t.learned.reset_counters()
        t.learned.explore.reset_state()


@pytest.fixture
def lenv(tmp_path):
    """Each package on a scratch DB, store and model path of its own
    (`paths[i]`), consult mode; flags and caches restored after."""
    saved = [{k: f.get_flag(k) for k in FLAG_NAMES} for _, f in PKGS]
    paths = []
    for i, (_, f) in enumerate(PKGS):
        p = {k: str(tmp_path / f"{i}.{k}") for k in ("db", "meas", "model")}
        f.set_flags({"tuning_mode": "consult", "tuning_db": p["db"],
                     "tuning_measurements": p["meas"],
                     "tuning_model": p["model"]})
        paths.append(p)
    _reset()
    yield paths
    for (_, f), s in zip(PKGS, saved):
        f.set_flags(s)
    _reset()


def _conv_sk(t, n, hw, cin, cout, k=3):
    return t.conv_key(n, hw, hw, cin, cout, k, k, (1, 1), (1, 1), "NHWC")


def _records(dk):
    """tests/test_learned_costmodel.py's synthetic conv grid (arm times
    exact log-linear functions of the features) and an attention grid of
    the port's two arms, flash winning past S = 256."""
    recs = []
    base = {"schema": 1, "dtype": "float32", "device_kind": dk}
    for hw in (8, 16):
        for cin in (3, 8, 16, 32, 64, 128):
            for cout in (4, 16, 64):
                if (hw, cin, cout) == (8, 3, 4):
                    continue
                flops = 2.0 * (4 * hw * hw) * (cin * 9) * cout
                direct = flops * 1e-10
                for arm, t in (("direct", direct),
                               ("igemm", direct * (cin * 9 / 288.0) ** -0.5)):
                    recs.append(dict(base, op="conv2d", arm=arm, median_s=t,
                                     shape_key=_conv_sk(ttuning, 4, hw, cin,
                                                        cout)))
    for b in (2, 8, 32):
        for s in (64, 128, 256, 512, 1024):
            for dh in (64, 128):
                work = 4.0 * b * 12 * s * s * dh * 1e-13
                for arm, t in (("pallas_short", work * (s / 256.0) ** 0.5),
                               ("flash_bundled", work)):
                    recs.append(dict(base, op="attention", arm=arm,
                                     median_s=t, shape_key=ttuning.
                                     attention_key(b, 12, s, s, dh, False)))
    return recs


FEATURE_KEYS = {
    "conv2d": ["n=4 out=16x16 cin=128 cout=64 k=3x3 s=1x1 d=1x1 NHWC",
               "n=-1 out=7x7 cin=2048 cout=512 k=1x1 s=2x2 d=1x1 NCHW",
               "garbage"],
    "attention": ["b=64 nh=12 sq=512 sk=512 dh=64 causal=0",
                  "b=8 nh=12 sq=1 sk=4096 dh=128 causal=1", "b=2"],
    "epilogue": ["kind=ln rows=16384 c=768 ch=last act=identity res=0",
                 "kind=bn rows=401408 c=64 ch=row act=relu res=1"],
    "xent": ["rows=16384 v=30522", "rows=3 v=7"],
    "serving.control": ["rate=120 p50=64 p95=400 out=128 hit=35 occ=70 "
                        "q=3 hr=80"],
    "amp_list": ["op=relu"],
}


@pytest.mark.parametrize("op", sorted(FEATURE_KEYS))
def test_featurize_equals_jax(op):
    for sk in FEATURE_KEYS[op]:
        for dt in ("float32", "bfloat16"):
            got = ttuning.learned.features.featurize(op, sk, dt)
            want = jtuning.learned.features.featurize(op, sk, dt)
            assert got == want, (op, sk, dt)
            assert (ttuning.learned.features.analytic_decision(op, sk, dt)
                    == jtuning.learned.features.analytic_decision(op, sk, dt))


def test_training_gives_the_jax_model_bytes_and_predictions(lenv):
    """The same records train byte-identical model files in both packages,
    each loads the other's, and they predict the same times."""
    recs = _records("cpu")
    for (t, _), p in zip(PKGS, lenv):
        t.learned.save_model(t.learned.train_model(recs, seed=0), p["model"])
    raw = [open(p["model"], "rb").read() for p in lenv]
    assert raw[0] == raw[1]
    jm = jtuning.learned.load_model(lenv[1]["model"])
    tm = ttuning.learned.load_model(lenv[0]["model"])
    assert set(tm["groups"]) == {"conv2d|cpu", "attention|cpu"}
    for op, sk in (("conv2d", _conv_sk(ttuning, 4, 16, 8, 32)),
                   ("conv2d", _conv_sk(ttuning, 4, 16, 128, 32)),
                   ("attention", ttuning.attention_key(16, 12, 384, 384, 64,
                                                       False)),
                   ("attention", ttuning.attention_key(4, 12, 96, 96, 128,
                                                       False))):
        for dev in ("cpu", "NVIDIA H100 80GB HBM3"):
            got = ttuning.learned.predict_times(tm, op, sk, "float32", dev)
            assert got == jtuning.learned.predict_times(jm, op, sk, "float32",
                                                        dev)
            assert got[0] is not None


def _decide_all(t, keys, validate=None):
    return [t.decide(k.split("|")[0], k, prior=lambda: {"x": "prior"},
                     default={"x": "default"}, validate=validate)
            for k in keys]


def test_gates_and_fail_open_match_jax(lenv):
    """The learned tier's answers, fallback reasons and counters are the
    JAX package's: a prediction in the envelope, the envelope gate past
    it, the holdout gate on a group that cannot rank its holdout, a
    validate refusal; a missing model is silent, a corrupt one warns once
    and fails open."""
    recs = _records("cpu")
    # a group whose arms' times are noise: its holdout ranking fails
    rng = np.random.default_rng(0)
    for r in recs:
        if r["op"] == "conv2d":
            r["median_s"] = float(rng.random())
    keys = [ttuning.canonical_key("attention", ttuning.attention_key(
                16, 12, 384, 384, 64, False), "float32", "cpu"),
            ttuning.canonical_key("attention", ttuning.attention_key(
                16, 12, 65536, 65536, 64, False), "float32", "cpu"),
            ttuning.canonical_key("conv2d", _conv_sk(ttuning, 4, 16, 128, 64),
                                  "float32", "cpu")]
    out = []
    for (t, _), p in zip(PKGS, lenv):
        t.learned.save_model(t.learned.train_model(recs, seed=0), p["model"])
        _reset()
        got = _decide_all(t, keys)
        got += _decide_all(t, keys[:1],
                           validate=lambda d: d.get("backend") == "x")
        out.append((got, t.learned.snapshot(), t.provenance_snapshot()))
    assert out[0] == out[1]
    got, snap, _ = out[1]
    assert got[0][1] == "learned" and got[1][1] == got[2][1] == "analytic"
    assert snap["fallback_reasons"] == {"envelope": 1, "accuracy": 1,
                                        "validate": 1}
    for (t, f), p in zip(PKGS, lenv):
        f.set_flags({"tuning_model": p["model"] + ".missing"})
        _reset()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert _decide_all(t, keys[:1])[0][1] == "analytic"
        assert not [x for x in w if "cost model" in str(x.message)]
        open(p["model"], "w").write("{not json")
        f.set_flags({"tuning_model": p["model"]})
        _reset()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(3):
                assert _decide_all(t, keys[:1])[0][1] == "analytic"
        assert len([x for x in w if "cost model" in str(x.message)]) == 1


def _fake_measured(times):
    def measure(fn):
        t = times[fn]
        return {"median_s": t, "min_s": t, "windows_s": [t], "band": 0.0}
    return measure


@pytest.mark.parametrize("base,times,verdict,decision,source", [
    ("pallas_short", {"a": 1.0, "b": 0.5}, "keep", "flash_bundled", "swept"),
    ("pallas_short", {"a": 1.0, "b": 0.98}, "tie", "pallas_short",
     "candidate"),
    ("flash_bundled", {"a": 1.0, "b": 2.0}, "keep", "pallas_short", "swept"),
    ("pallas_short", {"a": 0.5, "b": 1.0}, "retire", "pallas_short", "swept"),
], ids=["promote", "tie", "keep-the-other", "retire"])
def test_explore_verdicts_write_the_jax_entries(lenv, monkeypatch, base, times,
                                                verdict, decision, source):
    """With the arms stubbed ("a" K2/K4, "b" K10/K11) and their times
    fixed, a probe of one candidate gives the same verdict, DB entry,
    store rows and promotion count in both packages."""
    key = ttuning.canonical_key("attention", ttuning.attention_key(
        64, 12, 512, 512, 64, False), "bfloat16", "cpu")
    results = []
    for (t, f), p in zip(PKGS, lenv):
        f.set_flags({"tuning_mode": "explore"})
        db = t.TuningDB(p["db"])
        db.put(key, {"backend": base}, source="candidate")
        db.save()
        _reset()
        ex = t.learned.explore
        monkeypatch.setattr(ex, "_build_arms", lambda op, sk, dt: {
            "pallas_short": "a", "flash_bundled": "b"})
        monkeypatch.setattr(ex, "_measure", _fake_measured(times))
        out = ex.explore_one()
        assert ex.explore_one() is None          # never re-probed
        rows = [{k: v for k, v in r.items() if k not in ("host", "ts")}
                for r in t.learned.iter_records(p["meas"])]
        results.append((out, t.TuningDB(p["db"]).lookup(key), rows,
                        t.learned.snapshot()["promotions"]))
    assert results[0] == results[1]
    out, entry, rows, promotions = results[1]
    assert (out["verdict"], entry["source"]) == (verdict, source)
    assert entry["decision"] == {"backend": decision}
    assert set(entry["measured"]) == {"pallas_short", "flash_bundled"}
    assert {r["source"] for r in rows} == {"explore"} and len(rows) == 2
    assert promotions == (source == "swept")


@pytest.mark.parametrize("record,rows", [("off", 0), ("auto", 2), ("on", 2)])
def test_probe_honours_tuning_record(lenv, monkeypatch, record, rows):
    """The port's probe appends its arms to the store only where
    FLAGS_tuning_record lets it ('off' never records); the verdict and the
    DB entry are the same either way."""
    p = lenv[1]
    key = ttuning.canonical_key("attention", ttuning.attention_key(
        64, 12, 512, 512, 64, False), "bfloat16", "cpu")
    tflags.set_flags({"tuning_mode": "explore", "tuning_record": record})
    db = ttuning.TuningDB(p["db"])
    db.put(key, {"backend": "pallas_short"}, source="candidate")
    db.save()
    _reset()
    ex = ttuning.learned.explore
    monkeypatch.setattr(ex, "_build_arms", lambda op, sk, dt: {
        "pallas_short": "a", "flash_bundled": "b"})
    monkeypatch.setattr(ex, "_measure", _fake_measured({"a": 1.0, "b": 0.5}))
    assert ex.explore_one()["verdict"] == "keep"
    entry = ttuning.TuningDB(p["db"]).lookup(key)
    assert entry["decision"] == {"backend": "flash_bundled"}
    assert len(list(ttuning.learned.iter_records(p["meas"]))) == rows


def test_run_async_drives_a_real_probe(lenv):
    """Explore mode end to end in the port: the attention op's first run
    records its key as a candidate, and `run_async` probes it after its
    window drain: both routes timed forward + backward (their plain
    versions on this CPU), a verdict, the evidence in the DB and the
    store's explore rows."""
    p = lenv[1]
    tflags.set_flags({"tuning_mode": "explore", "tuning_explore_every": 1})
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        q, k, v = (tpt.layers.data(name=n, shape=[2, 16, 64], dtype="float32")
                   for n in "qkv")
        out = tpt.layers.reduce_mean(tpt.layers.fused_attention(q, k, v))
    rng = np.random.default_rng(0)
    feed = {n: rng.standard_normal((2, 2, 16, 64)).astype(np.float32)
            for n in "qkv"}
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run_async(main, feed=feed, fetch_list=[out], scope=scope)
    exe.wait()
    key = ttuning.canonical_key("attention", ttuning.attention_key(
        2, 2, 16, 16, 64, False), "float32", "cpu")
    entry = json.load(open(p["db"]))["entries"][key]
    assert set(entry["measured"]) == {"pallas_short", "flash_bundled"}
    assert entry["note"].startswith("explore:")
    assert all(e["median_s"] > 0 for e in entry["measured"].values())
    rows = list(ttuning.learned.iter_records(p["meas"]))
    assert {(r["arm"], r["source"]) for r in rows} == {
        ("pallas_short", "explore"), ("flash_bundled", "explore")}
