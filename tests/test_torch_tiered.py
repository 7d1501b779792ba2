"""The tiered giant embeddings of the port (paddle_tpu_torch/embedding/,
passes.rewrite_tiered_embeddings, the emb_cache_install / tiered_lookup
ops, the executor's resolution and write-back wiring) held against the JAX
package's on the CPU, at the JAX tests' size: a 512 x 8 table, 6 fields,
B=32, a 256-slot cache, the same numpy seeds through both packages."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp

import paddle_tpu.flags as jflags
import paddle_tpu_torch as tpt
import paddle_tpu_torch.flags as tflags
from paddle_tpu.param_attr import ParamAttr as JAttr
from paddle_tpu_torch.param_attr import ParamAttr as TAttr

VOCAB, DIM, FIELDS, BATCH = 512, 8, 6, 32
STEPS = 12
# a trajectory against another: every parameter and loss within 1e-6
# absolute (fp32 on both sides; the same sums in the same order on the CPU)
PARITY_ATOL = 1e-6
FLAG_NAMES = ("emb_hbm_budget_mb", "emb_cache_slots", "emb_prefetch_rows",
              "emb_admit_min_freq", "emb_host_shards", "emb_ckpt_base_every",
              "device_prefetch_depth", "watchdog_stall_s", "max_inflight_steps")


@pytest.fixture
def emb_flags():
    """Set flags in both packages at once; restore both afterwards."""
    saved = [{k: f.get_flag(k) for k in FLAG_NAMES} for f in (jflags, tflags)]

    def set_both(values):
        jflags.set_flags({k: v for k, v in values.items()
                          if k != "max_inflight_steps"})
        tflags.set_flags(values)

    yield set_both
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


def _model(pkg, padding_idx=None, name="tbl"):
    L = pkg["L"]
    attr = JAttr if pkg is tp.J else TAttr
    ids = L.data(name="ids", shape=[FIELDS], dtype="int64")
    label = L.data(name="label", shape=[1], dtype="float32")
    emb = L.embedding(ids, size=[VOCAB, DIM], is_sparse=True,
                      padding_idx=padding_idx, param_attr=attr(name=name))
    s = L.reduce_sum(emb, dim=1)
    logit = L.fc(s, size=1, param_attr=attr(name="w_out"),
                 bias_attr=attr(name="b_out"))
    loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
    pkg["pt"].optimizer.SGD(0.1).minimize(loss)
    return loss


def _minimized(pkg, set_flags, budget, slots=256, padding_idx=None, seed=7):
    set_flags({"emb_hbm_budget_mb": budget, "emb_cache_slots": slots})
    return tp.build(pkg, lambda p: _model(p, padding_idx), seed=seed)


def _feed(step, zipf=False, pad=None):
    rng = np.random.default_rng(100 + step)
    if zipf:
        ids = (rng.zipf(1.5, (BATCH, FIELDS)) - 1) % VOCAB
    else:
        ids = rng.integers(0, VOCAB, (BATCH, FIELDS))
    if pad is not None:
        ids[rng.random(ids.shape) < 0.2] = pad
    return {"ids": ids.astype(np.int64),
            "label": rng.integers(0, 2, (BATCH, 1)).astype(np.float32)}


def _recorded(engine):
    """Wrap the engine's resolver to keep every feed it resolves."""
    seen = []
    plain = engine.resolve_feed

    def resolve(feed):
        out = plain(feed)
        seen.append({k: np.array(v) for k, v in out.items()})
        return out

    engine.resolve_feed = resolve
    return seen


def _train(pkg, prog, feeds, init, tiered):
    """Run `feeds` through one package's program from the JAX startup's
    dense parameters in `init` (the table into the host tier when
    tiered). Returns (losses, {param: array}, scope, executor)."""
    main, startup, loss = prog
    scope, exe = pkg["scope"](), pkg["exe"]()
    exe.run(startup, scope=scope)
    if tiered:
        host = main._tiered_engine.tables["tbl"].host
        host.load_rows(np.arange(VOCAB), init["tbl"])
        host.clear_dirty()
    for n, a in init.items():
        if n == "tbl" and tiered:
            continue
        if pkg is tp.T:
            scope.set_var(n, torch.from_numpy(np.array(a)))
        else:
            scope.set_var(n, np.array(a))
    losses = []
    for feed in feeds:
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        losses.append(float(np.asarray(lv)))
    if tiered:
        exe.wait()
        main._tiered_engine.flush_all()
        table = main._tiered_engine.export_dense("tbl", scope)
    else:
        table = np.asarray(scope.find_var("tbl"))
    out = {"tbl": np.array(table)}
    for n in ("w_out", "b_out"):
        v = scope.find_var(n)
        out[n] = np.array(v.numpy() if isinstance(v, torch.Tensor) else v)
    return losses, out, scope, exe


def _jax_init(prog):
    main, startup, _ = prog
    scope, exe = tp.J["scope"](), tp.J["exe"]()
    exe.run(startup, scope=scope)
    return {n: np.array(np.asarray(scope.find_var(n)))
            for n in ("tbl", "w_out", "b_out")}


# -- the rewrite --------------------------------------------------------------

@pytest.mark.parametrize("budget", [0.001, 1024.0])
def test_rewritten_programs_equal_jax(emb_flags, budget):
    """Main and startup programs equal the JAX package's by to_dict(), over
    the budget (the cache, install and lookup rewrite, the table's init op
    removed, the cache fill added) and under it."""
    jm, js, _ = _minimized(tp.J, emb_flags, budget)
    tm, ts, _ = _minimized(tp.T, emb_flags, budget)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    ops = [op.type for op in tm.global_block.ops]
    if budget < 1:
        assert "lookup_table" not in ops
        assert ops.index("emb_cache_install") < ops.index("tiered_lookup")
        assert tm._tiered_engine.tables["tbl"].slots == 256
    else:
        assert getattr(tm, "_tiered_engine", None) is None
        assert "tiered_lookup" not in ops


def test_under_budget_program_is_the_untiered_one(emb_flags):
    """Tiering on with every table under the budget builds the very program
    of tiering off (bit for bit through to_dict's JSON)."""
    progs = {}
    for budget in (0.0, 1024.0):
        tm, ts, _ = _minimized(tp.T, emb_flags, budget)
        progs[budget] = (json.dumps(tm.to_dict(), sort_keys=True),
                         json.dumps(ts.to_dict(), sort_keys=True))
    assert progs[0.0] == progs[1024.0]


@pytest.mark.parametrize("shards", [1, 3])
def test_host_tiers_equal_jax_bit_for_bit(emb_flags, shards):
    """The host tier re-draws the removed init op's distribution from the
    same per-shard seeds as the JAX package's: equal bit for bit."""
    emb_flags({"emb_host_shards": shards})
    jm, _, _ = _minimized(tp.J, emb_flags, 0.001)
    tm, _, _ = _minimized(tp.T, emb_flags, 0.001)
    jh, th = (m._tiered_engine.tables["tbl"].host for m in (jm, tm))
    assert th.init == jh.init and th.init[0] == "uniform"
    assert th.num_shards == jh.num_shards == shards
    np.testing.assert_array_equal(th.bounds, jh.bounds)
    np.testing.assert_array_equal(th.to_dense(), jh.to_dense())


# -- trajectories -------------------------------------------------------------

def test_tiered_sgd_matches_jax_and_dense(emb_flags):
    """Twelve SGD steps of the tiered program (a 256-slot cache over the
    512-row table, so evictions and write-backs fire) against the JAX
    package's tiered program and the port's dense program, from the same
    initial values over the same batches: the resolved feeds equal the JAX
    package's at every step (slot ids, prefetch slots and the prefetch
    width bit for bit; the prefetched rows bit for bit at step 0 and later
    within PARITY_ATOL, since a row written back carries its trajectory's
    rounding), and losses and parameters agree within PARITY_ATOL."""
    feeds = [_feed(s) for s in range(STEPS)]
    jprog = _minimized(tp.J, emb_flags, 0.001)
    tprog = _minimized(tp.T, emb_flags, 0.001)
    dprog = _minimized(tp.T, emb_flags, 0.0)
    init = _jax_init(_minimized(tp.J, emb_flags, 0.0))
    jseen, tseen = (_recorded(p[0]._tiered_engine) for p in (jprog, tprog))
    jl, jout, _, _ = _train(tp.J, jprog, feeds, init, True)
    tl, tout, _, _ = _train(tp.T, tprog, feeds, init, True)
    dl, dout, _, _ = _train(tp.T, dprog, feeds, init, False)
    assert len(jseen) == len(tseen) == STEPS
    for s, (a, b) in enumerate(zip(jseen, tseen)):
        assert sorted(a) == sorted(b), s
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (s, k)
            if k.endswith("@PREFETCH_ROWS") and s > 0:
                # rows written back by a step carry its rounding
                np.testing.assert_allclose(a[k], b[k], rtol=0,
                                           atol=PARITY_ATOL, err_msg=f"{s}")
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{s} {k}")
    for other, olosses in ((jout, jl), (dout, dl)):
        np.testing.assert_allclose(tl, olosses, rtol=0, atol=PARITY_ATOL)
        for n in ("tbl", "w_out", "b_out"):
            np.testing.assert_allclose(tout[n], other[n], rtol=0,
                                       atol=PARITY_ATOL, err_msg=n)
    st = tprog[0]._tiered_engine.stats("tbl")
    assert st["evictions"] > 0
    assert st["writebacks"] == st["evictions"]
    assert st == jprog[0]._tiered_engine.stats("tbl")


# -- the padding_idx contract -------------------------------------------------

def test_lookup_table_padding_idx_forward_zeros_and_no_grad():
    """padding_idx rows read as zeros AND receive no gradient: an SGD(1.0)
    step leaves the padding row untouched while the looked-up rows move,
    and the output and updated table equal the JAX package's."""
    pad = 3

    def build(pkg):
        L = pkg["L"]
        attr = JAttr if pkg is tp.J else TAttr
        ids = L.data(name="ids", shape=[4], dtype="int64")
        emb = L.embedding(ids, size=[16, DIM], padding_idx=pad,
                          param_attr=attr(name="ptbl"))
        pkg["pt"].optimizer.SGD(1.0).minimize(L.mean(emb))
        return emb

    jprog, tprog = tp.build(tp.J, build), tp.build(tp.T, build)
    feed = {"ids": np.array([[pad, 1, 2, pad], [5, pad, 6, 7]], np.int64)}
    jout, tout, jscope, tscope = tp.run_both(
        jprog[:2], tprog[:2], [feed], [jprog[2].name], [tprog[2].name])
    out = tout[0][0]
    assert np.abs(np.asarray(jscope.find_var("ptbl"))[pad]).max() > 0
    for b, f in ((0, 0), (0, 3), (1, 1)):
        np.testing.assert_array_equal(out[b, f], np.zeros(DIM))
    np.testing.assert_allclose(out, jout[0][0], rtol=0, atol=PARITY_ATOL)
    w1 = tscope.find_var("ptbl").numpy()
    np.testing.assert_allclose(w1, np.asarray(jscope.find_var("ptbl")),
                               rtol=0, atol=PARITY_ATOL)
    startup = tp.J["scope"]()
    tp.J["exe"]().run(jprog[1], scope=startup)
    w0 = np.asarray(startup.find_var("ptbl"))
    np.testing.assert_array_equal(w1[pad], w0[pad])
    assert np.abs(w1[1] - w0[1]).max() > 0 and np.abs(w1[5] - w0[5]).max() > 0
    np.testing.assert_array_equal(w1[9], w0[9])


def test_tiered_padding_idx_matches_jax_and_dense(emb_flags):
    """Under tiering a padding id resolves to the scratch slot: it reads
    zeros, trains nothing, and four steps with a fifth of the ids padding
    match the JAX package's tiered program and the port's dense one."""
    pad = 3
    feeds = [_feed(s, pad=pad) for s in range(4)]
    jprog = _minimized(tp.J, emb_flags, 0.001, padding_idx=pad)
    tprog = _minimized(tp.T, emb_flags, 0.001, padding_idx=pad)
    dprog = _minimized(tp.T, emb_flags, 0.0, padding_idx=pad)
    init = _jax_init(_minimized(tp.J, emb_flags, 0.0, padding_idx=pad))
    tseen = _recorded(tprog[0]._tiered_engine)
    jl, jout, _, _ = _train(tp.J, jprog, feeds, init, True)
    tl, tout, _, _ = _train(tp.T, tprog, feeds, init, True)
    dl, dout, _, _ = _train(tp.T, dprog, feeds, init, False)
    scratch = tprog[0]._tiered_engine.tables["tbl"].scratch
    for feed, got in zip(feeds, tseen):
        slots = got["tbl@SLOTS@ids"]
        assert ((slots == scratch) == (feed["ids"] == pad)).all()
    np.testing.assert_array_equal(tout["tbl"][pad], init["tbl"][pad])
    for other, olosses in ((jout, jl), (dout, dl)):
        np.testing.assert_allclose(tl, olosses, rtol=0, atol=PARITY_ATOL)
        for n in ("tbl", "w_out", "b_out"):
            np.testing.assert_allclose(tout[n], other[n], rtol=0,
                                       atol=PARITY_ATOL, err_msg=n)


# -- admission, eviction, the prefetch width ----------------------------------

def _engines(set_flags, vocab, dim, slots, prefetch, init, seed=0):
    """The same raw engine in both packages (one table 't', one ids feed)."""
    from paddle_tpu.embedding import HostShardedTable as JHost
    from paddle_tpu.embedding import TieredEmbeddingEngine as JEngine
    from paddle_tpu_torch.embedding import HostShardedTable as THost
    from paddle_tpu_torch.embedding import TieredEmbeddingEngine as TEngine

    out = []
    for Host, Engine in ((JHost, JEngine), (THost, TEngine)):
        eng = Engine()
        eng.add_table("t", Host("t", vocab, dim, init=init, seed=seed),
                      slots=slots, cache_var="t@CACHE",
                      rows_var="t@PREFETCH_ROWS", slots_var="t@PREFETCH_SLOTS",
                      evict_var="t@EVICTED", prefetch_rows=prefetch)
        eng.add_lookup("t", "ids", "t@SLOTS@ids", None)
        out.append(eng)
    return out


def _same_resolution(engines, ids):
    feeds = [e.resolve_feed({"ids": np.asarray(ids, np.int64)})
             for e in engines]
    assert sorted(feeds[0]) == sorted(feeds[1])
    for k in feeds[0]:
        np.testing.assert_array_equal(np.asarray(feeds[0][k]),
                                      np.asarray(feeds[1][k]), err_msg=k)
    ts = [e.tables["t"] for e in engines]
    assert ts[0].row2slot == ts[1].row2slot
    np.testing.assert_array_equal(ts[0].slot_freq, ts[1].slot_freq)
    np.testing.assert_array_equal(ts[0].slot_used, ts[1].slot_used)
    return ts[1]


def test_frequency_admission_probation_and_lru_fallback(emb_flags):
    """Under FLAGS_emb_admit_min_freq a first-seen id enters on probation
    and is evicted before established hot rows, ties breaking LRU; slots of
    the current batch are pinned. Both packages' resolvers make the same
    decisions, feed for feed."""
    emb_flags({"emb_admit_min_freq": 3, "emb_prefetch_rows": 4})
    engines = _engines(emb_flags, 64, 4, 4, 4, ("uniform", -1, 1), seed=1)
    _same_resolution(engines, [[0, 1, 0, 1]])
    ts = _same_resolution(engines, [[0, 1, 2, 3]])
    assert set(ts.row2slot) == {0, 1, 2, 3}
    ts = _same_resolution(engines, [[4, 4, 4, 4]])
    assert {0, 1, 4} <= set(ts.row2slot) and 2 not in ts.row2slot
    ts = _same_resolution(engines, [[3, 5, 3, 5]])
    assert 3 in ts.row2slot and 5 in ts.row2slot


def test_prefetch_buffer_grows_on_overflow(emb_flags):
    """Ten misses overflow a configured width of 2: the width grows to the
    next power of two, padded with the scratch slot, as in the JAX
    package."""
    emb_flags({"emb_admit_min_freq": 1})
    engines = _engines(emb_flags, 256, 4, 128, 2, ("constant", 0.5))
    ts = _same_resolution(engines, np.arange(10)[None])
    out = engines[1].resolve_feed({"ids": np.arange(10, 30, dtype=np.int64)
                                   [None]})
    assert out["t@PREFETCH_ROWS"].shape == (32, 4)
    assert (out["t@PREFETCH_SLOTS"][20:] == ts.scratch).all()
    assert ts.prefetch_rows == 32 and ts.stats["prefetch_grows"] == 2


def test_cache_smaller_than_batch_working_set_raises(emb_flags):
    main, startup, loss = _minimized(tp.T, emb_flags, 0.001, slots=8)
    exe, scope = tp.T["exe"](), tpt.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(RuntimeError, match="working set"):
        exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)


# -- the async path -----------------------------------------------------------

def test_device_loader_and_run_async_match_the_synchronous_path(emb_flags):
    """The miss prefetch runs OFF the step: feeds resolved on the
    DeviceLoader's thread (feed_placer), dispatched by run_async under a
    window of 2, train the table to the synchronous path's values; every
    eviction is written back."""
    from paddle_tpu_torch.pipeline import DeviceLoader

    steps = 10
    emb_flags({"max_inflight_steps": 2})
    feeds = [_feed(s) for s in range(steps)]
    tables = []
    for asynchronous in (True, False):
        main, startup, loss = _minimized(tp.T, emb_flags, 0.001)
        eng = main._tiered_engine
        exe, scope = tp.T["exe"](), tpt.Scope()
        exe.run(startup, scope=scope)
        if asynchronous:
            loader = DeviceLoader(lambda: iter(feeds), depth=2,
                                  placement=exe.feed_placer(main))
            for feed in loader:
                assert "<emb_ticket>" in feed
                exe.run_async(main, feed=feed, fetch_list=[loss], scope=scope)
                assert len(exe._inflight) <= 2
            exe.wait()
        else:
            for feed in feeds:
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        eng.flush_all()
        st = eng.stats("tbl")
        assert st["batches"] == steps and st["evictions"] > 0
        assert st["writebacks"] == st["evictions"]
        tables.append(eng.export_dense("tbl", scope))
    np.testing.assert_allclose(tables[0], tables[1], rtol=0,
                               atol=PARITY_ATOL)


@pytest.mark.chaos
def test_emb_host_stall_surfaces_via_watchdog(emb_flags):
    """A wedged host-tier prefetch (emb_host_stall on the DeviceLoader's
    producer thread) raises StallError with the queue's depth, naming the
    DeviceLoader, instead of hanging the trainer on an empty queue."""
    from paddle_tpu_torch.pipeline import DeviceLoader
    from paddle_tpu_torch.resilience import StallError, fault_scope

    emb_flags({"watchdog_stall_s": 0.3})
    main, startup, loss = _minimized(tp.T, emb_flags, 0.001)
    exe, scope = tp.T["exe"](), tpt.Scope()
    exe.run(startup, scope=scope)
    with fault_scope("emb_host_stall:2"):
        loader = DeviceLoader(lambda: iter([_feed(s) for s in range(4)]),
                              depth=1, placement=exe.feed_placer(main))
        it = iter(loader)
        exe.run_async(main, feed=next(it), fetch_list=[loss], scope=scope)
        with pytest.raises(StallError) as exc:
            for feed in it:
                exe.run_async(main, feed=feed, fetch_list=[loss], scope=scope)
        exe.wait()
    assert "queue_depth" in exc.value.state
    assert "DeviceLoader" in exc.value.what


@pytest.mark.chaos
def test_pipeline_stall_in_the_drain_raises_stall_error(emb_flags):
    """pipeline_stall makes the oldest step one that never completes: the
    window's drain raises StallError carrying the in-flight step ids and
    the stage counters, and leaves the window intact."""
    from paddle_tpu_torch.resilience import StallError, fault_scope

    emb_flags({"watchdog_stall_s": 0.2, "max_inflight_steps": 2})
    main, startup, loss = _minimized(tp.T, emb_flags, 0.001)
    exe, scope = tp.T["exe"](), tpt.Scope()
    exe.run(startup, scope=scope)
    with fault_scope("pipeline_stall:1"):
        exe.run_async(main, feed=_feed(0), fetch_list=[loss], scope=scope)
        exe.run_async(main, feed=_feed(1), fetch_list=[loss], scope=scope)
        with pytest.raises(StallError) as exc:
            exe.run_async(main, feed=_feed(2), fetch_list=[loss], scope=scope)
    st = exc.value.state
    assert st["inflight_step_ids"] == [1, 2, 3] and st["oldest_step"] == 1
    assert "pipeline.dispatch" in st["profiler_stages"]
    assert "Executor async step 1" in exc.value.what
    exe.wait()  # the plan is gone: the window drains
    assert not exe._inflight


# -- delta checkpoints --------------------------------------------------------

def test_delta_checkpoint_roundtrip_base_plus_delta(emb_flags, tmp_path):
    """The host tier checkpoints as base + cumulative dirty-row deltas
    through the CheckpointManager manifest (bases rotate every 2 saves, two
    kept); restore = base + delta, the device cache restarts cold, and a
    further step trains on."""
    import glob

    from paddle_tpu_torch.resilience import CheckpointManager

    emb_flags({"emb_ckpt_base_every": 2})
    main, startup, loss = _minimized(tp.T, emb_flags, 0.001)
    eng = main._tiered_engine
    exe, scope = tp.T["exe"](), tpt.Scope()
    exe.run(startup, scope=scope)
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, main_program=main, scope=scope)
    for s in range(4):
        exe.run(main, feed=_feed(s), fetch_list=[loss], scope=scope)
        mgr.save(s, executor=exe)
    snap = eng.export_dense("tbl", scope)
    bases = sorted(glob.glob(os.path.join(root, "emb_tbl.base_*.npz")))
    assert [os.path.basename(b) for b in bases] == [
        "emb_tbl.base_00000000.npz", "emb_tbl.base_00000002.npz"]
    frag = mgr.read_manifest(3)["extra"]["tiered_embedding"]["tables"]["tbl"]
    assert frag["base_step"] == 2 and frag["delta_rows"] > 0
    eng.tables["tbl"].host.load_rows(np.arange(VOCAB),
                                     np.zeros((VOCAB, DIM), np.float32))
    assert mgr.restore(executor=exe) == 3
    np.testing.assert_array_equal(eng.tables["tbl"].host.to_dense(), snap)
    assert eng.tables["tbl"].row2slot == {}
    (lv,) = exe.run(main, feed=_feed(4), fetch_list=[loss], scope=scope)
    assert np.isfinite(lv).all()


def test_delta_checkpoint_kill_and_resume_bit_identical(tmp_path):
    """SIGKILL a tiered trainer mid-run (tests/torch_emb_resume.py); a fresh
    process restores base + delta and reproduces the undisturbed loss
    trajectory bit for bit."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_emb_resume.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("FLAGS_fault_plan", None)

    def run(root, losses, kill_at, check=True):
        p = subprocess.run(
            [sys.executable, script, root, losses, "10", str(kill_at)],
            env=env, capture_output=True, timeout=240)
        if check:
            assert p.returncode == 0, p.stderr.decode()[-3000:]
        return p

    def traj(path):
        with open(path) as f:
            return dict(line.split() for line in f)

    base = str(tmp_path / "base.txt")
    run(str(tmp_path / "base_ck"), base, -1)
    baseline = traj(base)
    assert sorted(map(int, baseline)) == list(range(10))
    root, losses = str(tmp_path / "ck"), str(tmp_path / "resumed.txt")
    p = run(root, losses, 4, check=False)
    assert p.returncode == -9, (p.returncode, p.stderr.decode()[-2000:])
    run(root, losses, -1)
    assert traj(losses) == baseline


def test_a_resolver_error_in_train_from_dataset_ends_the_process(tmp_path):
    """A resolver that raises on the DeviceLoader's thread (a cache smaller
    than a batch's working set) surfaces in train_from_dataset, and the
    process then exits: the abandoned QueueDataset iteration, closed last
    at interpreter shutdown when its workers no longer run, stops waiting
    for their sentinels."""
    code = f"""
import numpy as np, os, paddle_tpu_torch as pt
from paddle_tpu_torch import flags
from paddle_tpu_torch.models import deepfm
rng = np.random.default_rng(0)
files = []
for i in range(2):
    files.append(os.path.join({str(tmp_path)!r}, f"part-{{i}}"))
    with open(files[-1], "w") as f:
        for _ in range(64):
            ids, dense = rng.integers(0, 1000, 26), rng.random(13).round(4)
            f.write(f"26 {{' '.join(map(str, ids))}} 13 "
                    f"{{' '.join(map(str, dense))}} 1 {{rng.integers(0, 2)}}\\n")
flags.set_flags({{"emb_hbm_budget_mb": 0.02}})
main, startup = pt.Program(), pt.Program()
with pt.program_guard(main, startup):
    loss, _, feeds = deepfm.deepfm(vocab_size=1000, hidden_sizes=(8,))
    pt.optimizer.SGD(1e-3).minimize(loss)
ds = pt.DatasetFactory().create_dataset("QueueDataset")
ds.set_batch_size(64); ds.set_thread(2); ds.set_filelist(files)
ds.set_use_var([main.global_block.var(n) for n in feeds])
exe, scope = pt.Executor(place="cpu"), pt.Scope()
exe.run(startup, scope=scope)
exe.train_from_dataset(main, ds, scope=scope)
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, timeout=120)
    assert p.returncode == 1, p.stderr.decode()[-2000:]
    assert b"working set" in p.stderr
