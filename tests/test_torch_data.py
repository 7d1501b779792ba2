"""The port's data pipeline on the CPU, held against the JAX package where
both compute something: the native MultiSlot parser (C, built at first
use) against the plain Python parser and the JAX package's parser;
QueueDataset / InMemoryDataset and Executor.train_from_dataset (the port's
versions of tests/test_dataset_runtime.py); the reader decorators,
DataFeeder and PyReader (tests/test_data_pipeline.py:13-62, :73-132,
:141); DeviceLoader, PyReader's double buffer, pad_feed_to_bucket and the
trainer loop (tests/test_async_pipeline.py:39-180, :291-365, without its
XLA compile counts); the JAX package's train_from_dataset against the
port's over two files.

Every iteration of a threaded producer runs under `bounded` (a join with a
timeout), so a producer that never ends fails its test instead of holding
the whole run. Parameters after a trainer pass: within 1e-6 relative L2 of
the JAX package's (fp32 sums in another order), bit for bit where the port
is compared with itself.
"""
import threading
import time

import numpy as np
import pytest
import torch

from torch_parity import J, T, build

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.native import parse_multislot_file as jparse
from paddle_tpu_torch import flags, profiler
from paddle_tpu_torch import reader as R
from paddle_tpu_torch.data_feeder import ROW_MASK_NAME, pad_feed_to_bucket
from paddle_tpu_torch.native import _parse_multislot_py, parse_multislot_file
from paddle_tpu_torch.pipeline import DeviceLoader

TIMEOUT = 60.0   # seconds any one bounded call may take


def bounded(fn, *args, timeout=TIMEOUT, **kwargs):
    """fn(*args, **kwargs) on a daemon thread joined with a timeout: its
    result, or its exception re-raised; a call still running after
    `timeout` fails the test."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} did not finish in {timeout} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _threads_settle(base, deadline_s=5.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if threading.active_count() <= base:
            return True
        time.sleep(0.05)
    return threading.active_count() <= base


@pytest.fixture
def restore_flags():
    names = ("device_prefetch_depth", "feed_bucketing", "feed_skip_corrupt")
    saved = {n: flags.get_flag(n) for n in names}
    yield
    flags.set_flags(saved)


def _write_ctr_files(tmp_path, n_files=2, lines_per_file=40, seed=0):
    """MultiSlot CTR lines: 4 sparse ids, 3 dense floats, 1 label."""
    rng = np.random.default_rng(seed)
    paths = []
    for fi in range(n_files):
        p = tmp_path / f"slot{fi}.txt"
        with open(p, "w") as f:
            for _ in range(lines_per_file):
                ids = rng.integers(0, 50, 4)
                dense = rng.random(3).round(4)
                label = rng.integers(0, 2)
                f.write(f"4 {' '.join(map(str, ids))} "
                        f"3 {' '.join(map(str, dense))} "
                        f"1 {label}\n")
        paths.append(str(p))
    return paths


# -- the parser ----------------------------------------------------------------


def test_multislot_parser_native_matches_python(tmp_path):
    """The C parser, the plain Python parser and the JAX package's parser
    give the same bits."""
    (path,) = _write_ctr_files(tmp_path, n_files=1, lines_per_file=10)
    widths = [4, 3, 1]
    got = parse_multislot_file(path, widths)
    assert got.shape == (10, 8)
    np.testing.assert_array_equal(got, _parse_multislot_py(path, widths))
    np.testing.assert_array_equal(got, parse_multislot_file(path, widths,
                                                            native=False))
    np.testing.assert_array_equal(got, jparse(path, widths))


def test_multislot_parser_pads_and_truncates(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("2 7 8 1 0.5\n\n4 1 2 3 4 1 0.25\n")
    for native in (True, False):
        out = parse_multislot_file(str(p), [3, 1], native=native)
        np.testing.assert_array_equal(out[0], [7, 8, 0, 0.5])   # padded
        np.testing.assert_array_equal(out[1], [1, 2, 3, 0.25])  # truncated
        assert out.shape == (2, 4)                              # blank line


@pytest.mark.parametrize("text", ["2 7\n", "x 1\n", "1 3\n2 1\n"],
                         ids=["short", "no_count", "second_line"])
def test_multislot_parser_malformed(tmp_path, text):
    """A line that declares more values than it has, or no count, raises
    ValueError in both parsers."""
    p = tmp_path / "bad.txt"
    p.write_text(text)
    with pytest.raises(ValueError, match="malformed MultiSlot"):
        parse_multislot_file(str(p), [2])
    with pytest.raises(ValueError):
        parse_multislot_file(str(p), [2], native=False)


def test_multislot_parser_unreadable_file_raises(tmp_path):
    with pytest.raises(OSError):
        parse_multislot_file(str(tmp_path / "absent.txt"), [1])


def test_multislot_parser_builds_under_concurrent_first_use(tmp_path):
    """Three processes load a parser nobody built yet into one build
    directory at once (as the test runner's workers may): each compiles to
    a name of its own and replaces the library into place; all three parse
    the plain parser's bits and no temporary file is left."""
    import os
    import subprocess
    import sys

    (path,) = _write_ctr_files(tmp_path, n_files=1, lines_per_file=5)
    build_dir = tmp_path / "build"
    code = (
        "import sys, numpy as np\n"
        "import paddle_tpu_torch.native as n\n"
        f"n._BUILD = {str(build_dir)!r}\n"
        f"out = n.parse_multislot_file({path!r}, [4, 3, 1])\n"
        f"ref = n._parse_multislot_py({path!r}, [4, 3, 1])\n"
        "sys.exit(0 if np.array_equal(out, ref) else 3)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stderr=subprocess.PIPE) for _ in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, err.decode()[-2000:]
    names = sorted(p.name for p in build_dir.iterdir())
    assert len(names) == 1 and names[0].startswith("multislot-"), names


# -- datasets and the trainer -----------------------------------------------


def _ctr_program(pkg=T, sparse=False, opt=True):
    def fn(p):
        L = p["L"]
        ids = L.data(name="ids", shape=[4], dtype="int64")
        dense = L.data(name="dense", shape=[3], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="float32")
        emb = L.embedding(ids, size=[50, 8], is_sparse=sparse)
        feat = L.concat([L.reshape(emb, [-1, 32]), dense], axis=1)
        h = L.fc(feat, size=16, act="relu")
        logit = L.fc(h, size=1)
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        if opt:
            p["pt"].optimizer.SGD(0.1).minimize(loss)
        return [ids, dense, label], loss
    return build(pkg, fn)


def _dataset(kind, use_vars, files, batch, thread=1, pkg=tpt):
    ds = pkg.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(thread)
    ds.set_use_var(use_vars)
    ds.set_filelist(files)
    return ds


def _cpu():
    return tpt.Executor(place="cpu"), tpt.Scope()


def test_train_from_dataset_queue(tmp_path, capsys):
    files = _write_ctr_files(tmp_path)
    main, startup, (use_vars, loss) = _ctr_program()
    ds = _dataset("QueueDataset", use_vars, files, 8, thread=2)
    exe, scope = _cpu()
    exe.run(startup, scope=scope)
    w0 = scope.find_var("fc_0.w_0").clone()
    bounded(exe.train_from_dataset, main, ds, scope=scope,
            fetch_list=[loss], fetch_info=["loss"], print_period=5)
    w1 = scope.find_var("fc_0.w_0")
    assert not torch.allclose(w0, w1), "training moved no parameters"
    assert "loss" in capsys.readouterr().out


def test_inmemory_dataset_shuffles_and_trains(tmp_path):
    files = _write_ctr_files(tmp_path)
    main, startup, (use_vars, loss) = _ctr_program()
    ds = _dataset("InMemoryDataset", use_vars, files, 16, thread=2)
    bounded(ds.load_into_memory)
    assert ds.get_memory_data_size() == 80
    before = ds._data.copy()
    ds.local_shuffle()
    assert not np.array_equal(before, ds._data)
    np.testing.assert_array_equal(np.sort(before.ravel()),
                                  np.sort(ds._data.ravel()))
    exe, scope = _cpu()
    exe.run(startup, scope=scope)
    bounded(exe.train_from_dataset, main, ds, scope=scope)
    feed = bounded(lambda: next(iter(ds._iter_batches())))
    (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(float(lv))
    ds.release_memory()
    assert ds.get_memory_data_size() == 0


def test_inmemory_dataset_preloads_on_a_thread(tmp_path):
    files = _write_ctr_files(tmp_path)
    _, _, (use_vars, _) = _ctr_program(opt=False)
    ds = _dataset("InMemoryDataset", use_vars, files, 16, thread=2)
    ds.preload_into_memory()
    bounded(ds.wait_preload_done)
    assert ds.get_memory_data_size() == 80
    bad = _dataset("InMemoryDataset", use_vars, [str(tmp_path / "none")], 16)
    bad.preload_into_memory()
    with pytest.raises(OSError):
        bounded(bad.wait_preload_done)


def test_global_shuffle_partitions_by_rank(tmp_path):
    """Each sample on exactly one of two trainers, and each trainer's
    partition the JAX package's, row for row."""
    files = _write_ctr_files(tmp_path, n_files=1, lines_per_file=30)
    _, _, (use_vars, _) = _ctr_program(opt=False)
    _, _, (juse, _) = _ctr_program(J, opt=False)

    class _FakeFleet:
        def __init__(self, rank):
            self._rank = rank

        def worker_index(self):
            return self._rank

        def worker_num(self):
            return 2

    seen = []
    for rank in range(2):
        parts = []
        for pkg, uv in ((tpt, use_vars), (jpt, juse)):
            ds = _dataset("InMemoryDataset", uv, files, 8, pkg=pkg)
            bounded(ds.load_into_memory)
            ds.global_shuffle(_FakeFleet(rank))
            parts.append(ds._data)
        np.testing.assert_array_equal(parts[0], parts[1])
        seen.append(parts[0])
    assert sum(len(s) for s in seen) == 30
    full = _dataset("InMemoryDataset", use_vars, files, 8)
    bounded(full.load_into_memory)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen).ravel()),
                                  np.sort(full._data.ravel()))


def test_queue_dataset_assembly_runs_on_worker_threads(tmp_path):
    files = _write_ctr_files(tmp_path)
    _, _, (use_vars, _) = _ctr_program(opt=False)
    ds = _dataset("QueueDataset", use_vars, files, 8, thread=2)
    assembly_threads = set()
    orig = ds._split_batch

    def spying_split(flat):
        assembly_threads.add(threading.get_ident())
        return orig(flat)

    ds._split_batch = spying_split
    me = threading.get_ident()
    batches = bounded(lambda: (threading.get_ident(),
                               list(ds._iter_batches())))
    consumer, batches = batches
    assert batches and all(isinstance(b, dict) for b in batches)
    assert set(batches[0]) == {"ids", "dense", "label"}
    assert batches[0]["ids"].dtype == np.int32       # int64 narrowed
    assert consumer not in assembly_threads and me not in assembly_threads
    assert assembly_threads


def test_inmemory_dataset_double_buffers_assembly(tmp_path):
    files = _write_ctr_files(tmp_path)
    _, _, (use_vars, _) = _ctr_program(opt=False)
    ds = _dataset("InMemoryDataset", use_vars, files, 8)
    bounded(ds.load_into_memory)
    assembly_threads = set()
    orig = ds._split_batch

    def spying_split(flat):
        assembly_threads.add(threading.get_ident())
        return orig(flat)

    ds._split_batch = spying_split
    consumer, n = bounded(lambda: (threading.get_ident(),
                                   sum(1 for _ in ds._iter_batches())))
    assert n == 10  # 80 rows / batch 8
    assert consumer not in assembly_threads


def test_queue_dataset_worker_skips_corrupt_batch(tmp_path, restore_flags):
    files = _write_ctr_files(tmp_path, n_files=1, lines_per_file=24)
    _, _, (use_vars, _) = _ctr_program(opt=False)

    def make_ds():
        ds = _dataset("QueueDataset", use_vars, files, 8)
        orig = ds._split_batch
        calls = {"n": 0}

        def poisoned(flat):
            calls["n"] += 1
            if calls["n"] == 2:
                raise ValueError("corrupt batch (injected)")
            return orig(flat)

        ds._split_batch = poisoned
        return ds

    flags.set_flags({"feed_skip_corrupt": True})
    profiler.stage_counters(reset=True)
    got = bounded(lambda: list(make_ds()._iter_batches()))
    assert len(got) == 2  # 3 batches, one poisoned
    assert profiler.stage_counters()["feed.skip_corrupt"]["events"] == 1
    flags.set_flags({"feed_skip_corrupt": False})
    with pytest.raises(ValueError, match="corrupt batch"):
        bounded(lambda: list(make_ds()._iter_batches()))


def test_dataset_stage_counters_count_parse_and_assembly(tmp_path):
    files = _write_ctr_files(tmp_path, n_files=3, lines_per_file=20)
    _, _, (use_vars, _) = _ctr_program(opt=False)
    ds = _dataset("QueueDataset", use_vars, files, 8, thread=3)
    profiler.stage_counters(reset=True)
    n = bounded(lambda: sum(1 for _ in ds._iter_batches()))
    snap = profiler.stage_counters(reset=True)
    assert n == 9                      # 3 files of 20: 8, 8, 4 each
    assert snap["dataset.parse"]["events"] == 3
    assert snap["dataset.assemble"]["events"] == 9
    assert profiler.stage_counters() == {}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_train_from_dataset_matches_jax_over_two_files(tmp_path, sparse):
    """One thread (file order): the port's pass over two files ends with
    every parameter within 1e-6 relative L2 of the JAX package's, from the
    JAX startup's weights; with is_sparse the embedding's SelectedRows
    grads and sgd's row updates on both sides."""
    from paddle_tpu_torch.weights import load_params

    files = _write_ctr_files(tmp_path, lines_per_file=36)
    jm, js, (juse, _) = _ctr_program(J, sparse=sparse)
    tm, ts, (tuse, _) = _ctr_program(T, sparse=sparse)
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    exe, scope = _cpu()
    exe.run(ts, scope=scope)
    names = [p.name for p in jm.all_parameters()]
    load_params(scope, tm, {n: np.asarray(jscope.find_var(n)) for n in names})
    bounded(jexe.train_from_dataset, jm,
            _dataset("QueueDataset", juse, files, 8, pkg=jpt), scope=jscope,
            print_period=10**9)
    bounded(exe.train_from_dataset, tm,
            _dataset("QueueDataset", tuse, files, 8), scope=scope,
            print_period=10**9)
    for n in names:
        a = np.asarray(jscope.find_var(n), np.float64)
        b = scope.find_var(n).numpy().astype(np.float64)
        assert np.linalg.norm(a - b) <= 1e-6 * np.linalg.norm(a), n


# -- the reader decorators ---------------------------------------------------


def _both(fn):
    """fn(reader module) for the port's and the JAX package's readers."""
    from paddle_tpu import reader as JR

    return fn(R), fn(JR)


def test_batch_and_firstn():
    got, want = _both(lambda m: (list(m.batch(lambda: iter(range(10)), 3)()),
                                 list(m.batch(lambda: iter(range(10)), 3,
                                              drop_last=True)()),
                                 list(m.firstn(lambda: iter(range(10)), 4)())))
    assert got == want
    assert got[0] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    assert got[1][-1] == [6, 7, 8]
    assert got[2] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        R.batch(lambda: iter([]), 0)


def test_shuffle_preserves_multiset():
    r = R.shuffle(lambda: iter(range(100)), buf_size=16)
    assert sorted(r()) == list(range(100))


def test_chain_compose_map():
    a = lambda: iter([1, 2])  # noqa: E731
    b = lambda: iter([3, 4])  # noqa: E731
    got, want = _both(lambda m: (list(m.chain(a, b)()),
                                 list(m.compose(a, b)()),
                                 list(m.map_readers(lambda x, y: x + y,
                                                    a, b)())))
    assert got == want == ([1, 2, 3, 4], [(1, 3), (2, 4)], [4, 6])


def test_compose_misaligned_raises():
    a = lambda: iter([1, 2, 3])  # noqa: E731
    b = lambda: iter([4])  # noqa: E731
    with pytest.raises(RuntimeError):
        list(R.compose(a, b)())
    assert list(R.compose(a, b, check_alignment=False)()) == [(1, 4)]


def test_buffered_and_xmap():
    r = R.buffered(lambda: iter(range(50)), size=8)
    assert bounded(lambda: list(r())) == list(range(50))
    xm = R.xmap_readers(lambda x: x * 2, lambda: iter(range(20)),
                        process_num=4, buffer_size=8, order=True)
    assert bounded(lambda: list(xm())) == [2 * i for i in range(20)]
    xm2 = R.xmap_readers(lambda x: x * 2, lambda: iter(range(20)),
                         process_num=4, buffer_size=8, order=False)
    assert sorted(bounded(lambda: list(xm2()))) == [2 * i for i in range(20)]


def test_xmap_mapper_error_propagates_no_deadlock():
    xm = R.xmap_readers(lambda x: 1 // x, lambda: iter([1, 0, 2]),
                        process_num=2, buffer_size=4)
    with pytest.raises(ZeroDivisionError):
        bounded(lambda: list(xm()))


def test_buffered_propagates_errors():
    def bad():
        yield 1
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        bounded(lambda: list(R.buffered(lambda: bad(), 4)()))


def test_prefetch_stall_window_raises_stall_error():
    """A producer that wedges without raising: the consumer raises
    StallError after the window, naming the queue's state, and the
    producer's wait ends when the iteration is abandoned."""
    release = threading.Event()

    def wedged():
        yield 1
        release.wait(TIMEOUT)
        yield 2

    it = R._prefetch_iter(wedged, 2, stall_window=0.3, stall_what="test")
    assert bounded(next, it) == 1
    with pytest.raises(R.StallError, match="producer_alive"):
        bounded(next, it)
    release.set()


def test_cache_partial_first_pass_not_poisoned():
    c = R.cache(lambda: iter(range(5)))
    it = c()
    next(it)
    del it
    assert list(c()) == [0, 1, 2, 3, 4]
    assert list(c()) == [0, 1, 2, 3, 4]


def test_xmap_abandoned_iteration_stops_workers():
    base = threading.active_count()
    xm = R.xmap_readers(lambda x: x, lambda: iter(range(1000)),
                        process_num=3, buffer_size=2)
    it = xm()
    bounded(next, it)
    it.close()
    assert _threads_settle(base), "worker threads did not wind down"


# -- DataFeeder and PyReader -----------------------------------------------


def _vars(pkg, *specs):
    """Data vars in a fresh program of `pkg`: (name, shape, dtype)."""
    def fn(p):
        return [p["L"].data(name=n, shape=s, dtype=d) for n, s, d in specs]
    return build(pkg, fn)[2]


def test_data_feeder_pads_ragged():
    """The port's feed equals the JAX package's, array for array."""
    specs = (("ids", [-1], "int64"), ("lab", [1], "int64"))
    samples = [([1, 2, 3], 0), ([4], 1)]
    feed = tpt.DataFeeder(_vars(T, *specs), emit_lengths=True).feed(samples)
    jfeed = jpt.DataFeeder(_vars(J, *specs), emit_lengths=True).feed(samples)
    np.testing.assert_array_equal(feed["ids"], [[1, 2, 3], [4, 0, 0]])
    np.testing.assert_array_equal(feed["ids_len"], [3, 1])
    assert feed["lab"].shape == (2, 1)
    assert feed.keys() == jfeed.keys()
    for k in feed:
        np.testing.assert_array_equal(feed[k], jfeed[k])
        assert feed[k].dtype == jfeed[k].dtype


def _separable(n_batches=24, B=32, seed=0):
    """A 4-class problem a linear layer separates (stands in for MNIST)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, 16)).astype(np.float32) * 3
    def gen():
        r = np.random.default_rng(seed + 1)
        for _ in range(n_batches * B):
            c = int(r.integers(0, 4))
            yield (centers[c] + r.standard_normal(16).astype(np.float32), c)
    return gen


def test_pyreader_end_to_end_training():
    main, startup = tpt.Program(), tpt.Program()
    L = T["L"]
    with tpt.program_guard(main, startup):
        img = L.data(name="img", shape=[16], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(img, size=4), label))
        tpt.optimizer.SGD(0.1).minimize(loss)
    loader = tpt.PyReader(feed_list=[img, label], capacity=4, place="cpu")
    loader.decorate_sample_list_generator(
        R.batch(_separable(), batch_size=32, drop_last=True))
    exe, scope = _cpu()
    exe.run(startup, scope=scope)

    def train():
        losses = []
        for feed in loader():
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(float(lv))
        return losses

    losses = bounded(train)
    assert len(losses) == 24
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


def test_pyreader_propagates_worker_errors():
    (img,) = _vars(T, ("im2", [4], "float32"))
    loader = tpt.PyReader(feed_list=[img], capacity=2, place="cpu")

    def bad_reader():
        yield [(np.zeros(4, np.float32),)]
        raise ValueError("boom")

    loader.decorate_sample_list_generator(lambda: bad_reader())
    with pytest.raises(ValueError, match="boom"):
        bounded(lambda: [None for _ in loader()])


# -- DeviceLoader ----------------------------------------------------------


def test_device_loader_stages_to_device_in_order():
    def src():
        for i in range(5):
            yield {"x": np.full((2, 3), i, np.float32)}

    out = bounded(lambda: list(DeviceLoader(src, depth=2, device="cpu")))
    assert len(out) == 5
    for i, d in enumerate(out):
        assert isinstance(d["x"], torch.Tensor) and d["x"].device.type == "cpu"
        np.testing.assert_array_equal(d["x"].numpy(), np.full((2, 3), i))


def test_device_loader_casts_to_feed_var_dtypes():
    (x, i) = _vars(T, ("dl_x", [3], "float32"), ("dl_i", [1], "int64"))

    def src():
        yield {"dl_x": np.ones((2, 3), np.float64), "dl_i": np.ones((2, 1)),
               "extra": np.arange(2)}

    (d,) = bounded(lambda: list(DeviceLoader(src, depth=1, feed_vars=[x, i],
                                             device="cpu")))
    assert d["dl_x"].dtype == torch.float32   # the var's dtype, not float64
    assert d["dl_i"].dtype == torch.int32     # int64 narrowed at the feed
    assert isinstance(d["extra"], torch.Tensor)   # unknown keys staged too


def test_device_loader_passes_tensors_and_selected_rows_through():
    from paddle_tpu_torch.core.selected_rows import SelectedRows

    t = torch.ones(3)
    sr = SelectedRows(torch.zeros(1, dtype=torch.int32), torch.ones(1, 2), 4)
    (d,) = bounded(lambda: list(DeviceLoader(
        lambda: iter([{"t": t, "sr": sr}]), depth=1, device="cpu")))
    assert d["t"] is t and d["sr"] is sr


def test_device_loader_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceLoader(lambda: iter([]))


def test_device_loader_propagates_producer_errors_no_leaked_threads():
    base = threading.active_count()

    def bad():
        yield {"x": np.zeros(4, np.float32)}
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        bounded(lambda: list(DeviceLoader(lambda: bad(), depth=2,
                                          device="cpu")))
    assert _threads_settle(base), "DeviceLoader left its stage thread running"


def test_device_loader_abandoned_iteration_stops_thread():
    base = threading.active_count()

    def src():
        for i in range(1000):
            yield {"x": np.full(4, i, np.float32)}

    it = iter(DeviceLoader(src, depth=2, device="cpu"))
    bounded(next, it)
    it.close()
    assert _threads_settle(base), "abandoned DeviceLoader leaked its thread"


def test_device_loader_records_stage_counters():
    profiler.stage_counters(reset=True)
    bounded(lambda: list(DeviceLoader(
        lambda: iter([{"x": np.zeros(4, np.float32)}] * 3), depth=1,
        device="cpu")))
    snap = profiler.stage_counters()
    assert snap["pipeline.host_ingest"]["events"] == 3
    assert snap["pipeline.device_put"]["events"] == 3


def test_device_loader_skips_a_corrupt_batch_under_the_flag(restore_flags):
    (x,) = _vars(T, ("cx", [2], "float32"))
    batches = [{"cx": np.ones((1, 2))}, {"cx": np.array([["a", "b"]])},
               {"cx": np.zeros((1, 2))}]
    flags.set_flags({"feed_skip_corrupt": True})
    profiler.stage_counters(reset=True)
    got = bounded(lambda: list(DeviceLoader(lambda: iter(batches), depth=1,
                                            feed_vars=[x], device="cpu")))
    assert len(got) == 2
    assert profiler.stage_counters()["feed.skip_corrupt"]["events"] == 1
    flags.set_flags({"feed_skip_corrupt": False})
    with pytest.raises(ValueError):
        bounded(lambda: list(DeviceLoader(lambda: iter(batches), depth=1,
                                          feed_vars=[x], device="cpu")))


def _pyreader(double_buffer):
    (x,) = _vars(T, ("px", [4], "float32"))
    r = tpt.PyReader(feed_list=[x], capacity=4,
                     use_double_buffer=double_buffer,
                     place="cpu" if double_buffer else None)
    r.decorate_sample_list_generator(
        lambda: iter([[(np.full(4, i, np.float32),)] * 2 for i in range(4)]))
    return r


def test_pyreader_double_buffer_yields_device_tensors():
    feeds = bounded(lambda: list(_pyreader(True)()))
    assert len(feeds) == 4
    assert all(isinstance(d["px"], torch.Tensor) for d in feeds)
    np.testing.assert_array_equal(feeds[3]["px"].numpy(), np.full((2, 4), 3))


def test_pyreader_without_double_buffer_yields_host_arrays():
    feeds = bounded(lambda: list(_pyreader(False)()))
    assert all(isinstance(d["px"], np.ndarray) for d in feeds)


def test_pyreader_double_buffer_still_propagates_errors():
    (x,) = _vars(T, ("pe", [4], "float32"))
    r = tpt.DataLoader.from_generator(feed_list=[x], capacity=2,
                                      use_double_buffer=True, place="cpu",
                                      return_list=True)

    def bad():
        yield [(np.zeros(4, np.float32),)]
        raise ValueError("boom")

    r.decorate_sample_list_generator(lambda: bad())
    with pytest.raises(ValueError, match="boom"):
        bounded(lambda: [None for _ in r()])


# -- bucketed padding ----------------------------------------------------------


def test_pad_feed_to_bucket_shapes_and_mask():
    from paddle_tpu.data_feeder import pad_feed_to_bucket as jpad

    src = {"a": np.ones((3, 2), np.float32), "b": np.ones((3, 1), np.int64)}
    feed = pad_feed_to_bucket(src, 5)
    assert feed["a"].shape == (5, 2) and feed["b"].shape == (5, 1)
    np.testing.assert_array_equal(feed["a"][3:], 0)
    np.testing.assert_array_equal(feed[ROW_MASK_NAME].ravel(), [1, 1, 1, 0, 0])
    jfeed = jpad(src, 5)
    for k in feed:
        np.testing.assert_array_equal(feed[k], jfeed[k])


def test_bucketed_padding_numerics_match_unpadded():
    """A loss weighted by the row mask: one zero row of padding leaves the
    loss and the updated weight as without it (1e-6)."""
    main, startup = tpt.Program(), tpt.Program()
    L = T["L"]
    with tpt.program_guard(main, startup):
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        m = L.data(name=ROW_MASK_NAME, shape=[1], dtype="float32")
        per_row = L.square_error_cost(L.fc(x, size=1), y)
        loss = L.elementwise_div(L.reduce_sum(L.elementwise_mul(per_row, m)),
                                 L.reduce_sum(m))
        tpt.optimizer.SGD(0.1).minimize(loss)
    rng = np.random.default_rng(0)
    samples = [(rng.standard_normal(4, dtype=np.float32),
                rng.standard_normal(1, dtype=np.float32)) for _ in range(3)]
    w_name = main.all_parameters()[0].name
    results = []
    for bucket in (3, 4):
        feed = tpt.DataFeeder([x, y], bucket_size=bucket).feed(samples)
        assert feed["x"].shape[0] == bucket
        exe, scope = _cpu()
        exe.run(startup, scope=scope)
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        results.append((float(lv), scope.find_var(w_name).numpy()))
    (loss_a, w_a), (loss_b, w_b) = results
    np.testing.assert_allclose(loss_a, loss_b, rtol=1e-6)
    np.testing.assert_allclose(w_a, w_b, rtol=1e-6)


def test_dataset_split_batch_buckets_tail(restore_flags):
    ds = tpt.DatasetFactory().create_dataset("QueueDataset")
    (v,) = _vars(T, ("slot0", [2], "float32"))
    ds.set_use_var([v])
    ds.set_batch_size(4)
    flags.set_flags({"feed_bucketing": True})
    feed = ds._split_batch(np.arange(6, dtype=np.float64).reshape(3, 2))
    assert feed["slot0"].shape == (4, 2)
    np.testing.assert_array_equal(feed[ROW_MASK_NAME].ravel(), [1, 1, 1, 0])


# -- the trainer loop ----------------------------------------------------------


def _slot_file(tmp_path, rows, seed=0):
    rng = np.random.default_rng(seed)
    p = tmp_path / "part-0"
    with open(p, "w") as f:
        for _ in range(rows):
            vals = " ".join(f"{v:.4f}" for v in rng.random(4))
            f.write(f"4 {vals} 1 {rng.integers(0, 2)}\n")
    return str(p)


def _dataset_program():
    def fn(p):
        L = p["L"]
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        loss = L.reduce_mean(L.square_error_cost(L.fc(x, size=1), y))
        p["pt"].optimizer.SGD(0.1).minimize(loss)
        return [x, y], loss
    return build(T, fn)


def test_train_from_dataset_prefetch_matches_plain_loop(tmp_path,
                                                         restore_flags):
    """Depth 0 (batches straight from the dataset), depth 2 (through the
    DeviceLoader) and a plain loop of Executor.run over the parsed batches
    end with the same bits."""
    main, startup, (use_vars, loss) = _dataset_program()
    w_name = main.all_parameters()[0].name
    path = _slot_file(tmp_path, rows=10)       # batches of 4, 4, 2
    finals = []
    for depth in (0, 2):
        flags.set_flags({"device_prefetch_depth": depth})
        ds = _dataset("QueueDataset", use_vars, [path], 4)
        exe, scope = _cpu()
        exe.run(startup, scope=scope)
        bounded(exe.train_from_dataset, main, ds, scope=scope,
                fetch_list=[loss], print_period=10**9)
        finals.append(scope.find_var(w_name).numpy())
    exe, scope = _cpu()
    exe.run(startup, scope=scope)
    flat = _parse_multislot_py(path, [4, 1])
    for i in range(0, 10, 4):
        exe.run(main, feed={"x": flat[i:i + 4, :4], "y": flat[i:i + 4, 4:]},
                scope=scope)
    finals.append(scope.find_var(w_name).numpy())
    np.testing.assert_array_equal(finals[0], finals[1])
    np.testing.assert_array_equal(finals[0], finals[2])


def test_train_from_dataset_throughput_print_excludes_first_batch(
        tmp_path, capsys, restore_flags):
    main, startup, (use_vars, loss) = _dataset_program()
    ds = _dataset("QueueDataset", use_vars, [_slot_file(tmp_path, rows=16)], 4)
    exe, scope = _cpu()
    exe.run(startup, scope=scope)
    bounded(exe.train_from_dataset, main, ds, scope=scope, fetch_list=[loss],
            print_period=3)
    printed = capsys.readouterr().out
    assert "batch 3 (" in printed and "batch/s" in printed
    assert "batch 1 (" not in printed


def test_train_from_dataset_no_leaked_threads(tmp_path, restore_flags):
    base = threading.active_count()
    main, startup, (use_vars, _) = _dataset_program()
    ds = _dataset("QueueDataset", use_vars, [_slot_file(tmp_path, rows=12)],
                  4, thread=2)
    flags.set_flags({"device_prefetch_depth": 2})
    exe, scope = _cpu()
    exe.run(startup, scope=scope)
    bounded(exe.train_from_dataset, main, ds, scope=scope,
            print_period=10**9)
    assert _threads_settle(base), "prefetch stack leaked threads"


def test_train_from_dataset_clamps_threads_and_checks_fetch_info(tmp_path):
    main, startup, (use_vars, loss) = _dataset_program()
    path = _slot_file(tmp_path, rows=8)
    exe, scope = _cpu()
    exe.run(startup, scope=scope)
    ds = _dataset("QueueDataset", use_vars, [path], 4, thread=4)
    bounded(exe.train_from_dataset, main, ds, scope=scope, thread=2)
    assert ds.thread_num == 2
    ds1 = _dataset("QueueDataset", use_vars, [path], 4)
    bounded(exe.train_from_dataset, main, ds1, scope=scope, thread=3)
    assert ds1.thread_num == 3
    with pytest.raises(ValueError, match="fetch_info"):
        exe.train_from_dataset(main, ds1, scope=scope, fetch_list=[loss],
                               fetch_info=["a", "b"])
    with pytest.raises(RuntimeError, match="set_use_var"):
        exe.train_from_dataset(main, tpt.DatasetFactory().create_dataset(
            "QueueDataset"), scope=scope)
    with pytest.raises(ValueError, match="datafeed class"):
        tpt.DatasetFactory().create_dataset("NoSuchDataset")
