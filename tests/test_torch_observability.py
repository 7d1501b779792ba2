"""The port's telemetry layer (paddle_tpu_torch/observability/ and the
profiler's stage counters on its registry) held against the JAX package's
on the CPU: the same writes give the same snapshots, exports and SLO
verdicts."""
import json
import os
import re
import threading

import pytest

from paddle_tpu import observability as jobs
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import profiler
from paddle_tpu_torch.observability import (JsonlWriter, MetricsRegistry,
                                            jsonl_line, parse_prometheus,
                                            prometheus_text, schema,
                                            write_prometheus)
from paddle_tpu_torch.observability.slo import (counter_ratio_below,
                                                gauge_above, hist_p99_above)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both():
    return (MetricsRegistry(schema.DECLARED),
            jobs.MetricsRegistry(jobs.schema.DECLARED))


def _same(a, b):
    """Two snapshots equal but for the event ring's timestamps."""
    sa, sb = a.snapshot(), b.snapshot()
    ea, eb = sa.pop("events"), sb.pop("events")
    assert sa == sb
    strip = lambda es: [{k: v for k, v in e.items() if k != "ts"}  # noqa: E731
                        for e in es]
    assert strip(ea) == strip(eb)
    return sa


def test_schema_declares_the_jax_names_and_the_dataset_stages():
    assert jobs.schema.DECLARED_NAMES <= schema.DECLARED_NAMES
    assert schema.DECLARED_NAMES - jobs.schema.DECLARED_NAMES == {
        "dataset.parse", "dataset.assemble"}
    kinds = {s[0]: s[1] for s in jobs.schema.DECLARED}
    assert all(kinds[s[0]] == s[1] for s in schema.DECLARED if s[0] in kinds)


def test_every_stage_literal_of_the_port_is_declared():
    """Each profiler.bump / record_stage / stage_timer literal in the
    port's source names a declared stage."""
    pat = re.compile(r'(?:\bbump|\brecord_stage|\bstage_timer)\(\s*"([^"]+)"')
    used = set()
    for dirpath, _, files in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        if os.path.basename(dirpath) == "observability":
            continue  # the layer's own docs show call examples
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as f:
                    used |= set(pat.findall(f.read()))
    assert {"dataset.parse", "pipeline.device_put", "emb.resolved_batches",
            "pipeline.window_drain"} <= used
    assert sorted(used - schema.STAGE_NAMES) == []


def test_counters_gauges_and_labeled_series_as_jax():
    snap = _same(*_both_filled(lambda r: (
        r.counter_inc("serving.prefills"),
        r.counter_inc("serving.prefills", 4),
        r.gauge_set("serving.pool_occupancy", 0.25),
        r.counter_inc("emb.hit_ids", 7, labels={"table": "emb_a"}),
        r.counter_inc("emb.hit_ids", 1, labels={"table": "emb_b"}))))
    assert snap["counters"]["serving.prefills"] == 5
    assert snap["counters"]['emb.hit_ids{table="emb_a"}'] == 7
    assert obs.base_name('emb.hit_ids{table="emb_a"}') == "emb.hit_ids"


def _both_filled(fill):
    regs = _both()
    for r in regs:
        fill(r)
    return regs


@pytest.mark.parametrize("vals", [
    [0.001 * (i + 1) for i in range(100)],
    [1e-7, 3.0, 3.0, 42.0, 1e6],
    [0.5]])
def test_histogram_summaries_equal_jax(vals):
    regs = _both_filled(lambda r: [r.histogram_observe("serving.ttft_s", v)
                                   for v in vals])
    h = _same(*regs)["histograms"]["serving.ttft_s"]
    assert h["count"] == len(vals)
    assert h["min"] <= h["p50"] <= h["p99"] <= h["max"]


def test_undeclared_names_record_but_are_flagged():
    reg = MetricsRegistry(schema.DECLARED)
    reg.counter_inc("serving.prefills")
    reg.counter_inc("rogue.metric")
    snap = reg.snapshot()
    assert snap["counters"]["rogue.metric"] == 1
    assert snap["undeclared"] == ["rogue.metric"]
    reg.declare("rogue.metric", schema.COUNTER, "now blessed")
    assert reg.snapshot()["undeclared"] == []


def test_snapshot_reset_is_atomic_under_8_threads():
    """8 writers and a reader taking snapshot(reset=True): nothing is lost
    or double-counted across the reset boundaries."""
    reg = MetricsRegistry(schema.DECLARED)
    N, THREADS = 500, 8
    stop = threading.Event()
    seen = {"count": 0.0, "hist": 0}

    def writer():
        for _ in range(N):
            reg.counter_inc("train.steps")
            reg.histogram_observe("train.step_latency_s", 0.01)

    def reader():
        while not stop.is_set():
            snap = reg.snapshot(reset=True)
            seen["count"] += snap["counters"].get("train.steps", 0)
            seen["hist"] += snap["histograms"].get(
                "train.step_latency_s", {}).get("count", 0)

    ws = [threading.Thread(target=writer) for _ in range(THREADS)]
    r = threading.Thread(target=reader)
    r.start()
    for w in ws:
        w.start()
    for w in ws:
        w.join(60)
    stop.set()
    r.join(60)
    final = reg.snapshot()
    seen["count"] += final["counters"].get("train.steps", 0)
    seen["hist"] += final["histograms"].get(
        "train.step_latency_s", {}).get("count", 0)
    assert seen == {"count": N * THREADS, "hist": N * THREADS}


def test_reset_prefix_scopes_the_clear_as_jax():
    def fill(r):
        r.counter_inc("serving.prefills")
        r.counter_inc("train.steps")
        r.stage_record("pipeline.dispatch", 0.1)
        r.reset("serving.")
    snap = _same(*_both_filled(fill))
    assert "serving.prefills" not in snap["counters"]
    assert snap["stages"]["pipeline.dispatch"]["events"] == 1


def test_events_spans_and_the_enable_flag():
    from paddle_tpu_torch import flags

    reg = MetricsRegistry(schema.DECLARED)
    got = []
    reg.attach_sink(got.append)
    with reg.span("serving.decode", labels={"k": "v"}):
        pass
    reg.event("watchdog.stall", {"what": "x"}, level="error")
    assert [r["type"] for r in got] == ["span", "event"]
    assert got[0]["labels"] == {"k": "v"}
    assert reg.snapshot()["histograms"][
        'serving.decode.seconds{k="v"}']["count"] == 1
    reg.detach_sink(got.append)
    saved = flags.get_flag("obs_enable")
    flags.set_flags({"obs_enable": False})
    try:
        assert reg.event("watchdog.stall") is None
        reg.histogram_observe("serving.ttft_s", 1.0)
        reg.counter_inc("train.steps")
        snap = reg.snapshot()
        assert "serving.ttft_s" not in snap["histograms"]
        assert snap["counters"]["train.steps"] == 1
    finally:
        flags.set_flags({"obs_enable": saved})


# -- the profiler's stage counters on the registry -----------------------------

def test_profiler_stage_shims_keep_their_semantics():
    profiler.stage_counters(reset=True)
    profiler.record_stage("pipeline.dispatch", 0.25, events=2)
    profiler.bump("feed.skip_corrupt", 3)
    with profiler.stage_timer("dataset.parse"):
        pass
    c = profiler.stage_counters()
    assert c["pipeline.dispatch"] == {"events": 2, "seconds": 0.25}
    assert c["feed.skip_corrupt"] == {"events": 3, "seconds": 0.0}
    assert c["dataset.parse"]["events"] == 1
    assert obs.snapshot()["stages"]["pipeline.dispatch"]["seconds"] == 0.25
    assert profiler.stage_counters(reset=True)["pipeline.dispatch"][
        "events"] == 2
    assert profiler.stage_counters() == {}


# -- exporters ----------------------------------------------------------------

def test_jsonl_writer_rotation_and_byte_roundtrip(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    w = JsonlWriter(path, rotate_bytes=4096)
    for i in range(120):
        w.write({"ts": float(i), "type": "event", "name": "serving.request",
                 "level": "info", "payload": {"rid": i, "pad": "x" * 40}})
    w.close()
    assert os.path.exists(path + ".1")
    rids = []
    for p in (path + ".1", path):
        with open(p, "rb") as f:
            for line in f:
                rec = json.loads(line)
                assert jsonl_line(rec) == line
                assert jobs.jsonl_line(rec) == line
                rids.append(rec["payload"]["rid"])
    assert rids == list(range(rids[0], 120))


def test_prometheus_text_equals_jax_and_round_trips(tmp_path):
    def fill(r):
        r.counter_inc("train.steps", 17)
        r.gauge_set("serving.pool_occupancy", 0.5)
        r.counter_inc("tuning.decisions", labels={"op": "fc", "tier": "db"})
        r.stage_record("pipeline.dispatch", 1.5, events=3)
        r.histogram_observe("serving.ttft_s", 0.02)
        r.counter_inc("emb.miss_ids", 12, labels={"table": "fm_emb"})
    regs = _both_filled(fill)
    snap = regs[0].snapshot()
    text = prometheus_text(snap)
    assert text == jobs.prometheus_text(regs[1].snapshot())
    path = str(tmp_path / "metrics.prom")
    assert write_prometheus(path, snap) == text
    with open(path) as f:
        assert f.read() == text
    parsed = parse_prometheus(text)
    assert parsed == jobs.parse_prometheus(text)
    assert parsed["train_steps"] == 17
    assert parsed['tuning_decisions{op="fc",tier="db"}'] == 1
    assert parsed["pipeline_dispatch_seconds_total"] == 1.5
    assert parsed['emb_miss_ids{table="fm_emb"}'] == 12
    with pytest.raises(ValueError, match="unparseable"):
        parse_prometheus("this is not exposition format\n")


def test_export_prometheus_follows_the_flag(tmp_path):
    from paddle_tpu_torch import flags

    saved = flags.get_flag("obs_prometheus_path")
    path = str(tmp_path / "m.prom")
    flags.set_flags({"obs_prometheus_path": path})
    try:
        obs.counter_inc("train.steps")
        text = obs.export_prometheus()
        assert "train_steps" in text and os.path.exists(path)
    finally:
        flags.set_flags({"obs_prometheus_path": saved})
    assert obs.export_prometheus() is None


def test_http_exporter_serves_live_snapshot():
    import urllib.request

    reg = MetricsRegistry(schema.DECLARED)
    reg.counter_inc("train.steps", 5)
    try:
        server = obs.start_http_exporter(reg, port=0)
    except OSError as e:
        pytest.skip(f"cannot bind loopback: {e}")
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert parse_prometheus(body)["train_steps"] == 5
    finally:
        server.shutdown()


# -- SLO monitor --------------------------------------------------------------

def _slo_run(mod, reg, window_s, alert_after, gauges, now):
    hits = []
    mon = mod.SloMonitor(registry=reg, window_s=window_s,
                         alert_after=alert_after,
                         on_warn=lambda b: hits.append(("warn", b)),
                         on_alert=lambda b: hits.append(("alert", b)))
    mon.add_rule("leak", mod.slo.gauge_above("serving.leaked_pages", 0.0), 0)
    for g, t in zip(gauges, now):
        reg.gauge_set("serving.leaked_pages", g)
        mon.observe(now=t)
    return hits


@pytest.mark.parametrize("window_s,gauges,now,want", [
    (60.0, [0.0, 3.0, 3.0], [0.0, 1.0, 2.0], ["warn", "alert"]),
    (10.0, [1.0, 1.0], [0.0, 20.0], ["warn", "warn"])])
def test_slo_monitor_verdicts_equal_jax(window_s, gauges, now, want):
    """Warn on a breach, alert once alert_after breaches fall in the
    window, breaches age out: verdict for verdict the JAX monitor's."""
    regs = _both()
    got = _slo_run(obs, regs[0], window_s, 2, gauges, now)
    jgot = _slo_run(jobs, regs[1], window_s, 2, gauges, now)
    assert [s for s, _ in got] == want
    assert got == jgot
    snap = _same(*regs)
    assert sum(v for k, v in snap["counters"].items()
               if k.startswith("slo.breaches")) == len(want)


def test_slo_rules_read_histograms_and_ratios():
    reg = MetricsRegistry(schema.DECLARED)
    for v in (0.5, 0.6, 2.0):
        reg.histogram_observe("serving.request_s", v)
    reg.counter_inc("serving.prefix_hit_tokens", 1)
    reg.counter_inc("serving.prefill_tokens_computed", 9)
    snap = reg.snapshot()
    assert hist_p99_above("serving.request_s", 1.0)(snap) > 1.0
    assert hist_p99_above("serving.request_s", 5.0)(snap) is None
    rate = counter_ratio_below(
        "serving.prefix_hit_tokens",
        ("serving.prefix_hit_tokens", "serving.prefill_tokens_computed"),
        0.5)(snap)
    assert rate == pytest.approx(0.1)
    assert gauge_above("serving.leaked_pages", 0.0)(snap) is None
    mon = obs.default_serving_monitor(registry=reg)
    assert [r.name for r in mon.rules] == [
        r.name for r in jobs.default_serving_monitor().rules]
