"""Dataset runtime: QueueDataset / InMemoryDataset + DatasetFactory (the
JAX package's fluid_dataset.py; the reference's fluid/dataset.py and
framework/data_set.h, data_feed.h MultiSlotDataFeed).

Slot-based text files, multi-threaded ingest, local/global shuffle,
consumed by `Executor.train_from_dataset`:
  * parsing runs in the native C parser (paddle_tpu_torch/native) on host
    threads; samples become padded fixed-width arrays at ingest, so every
    batch reaches the device with a static shape;
  * batch assembly (`_split_batch`: slice, reshape, dtype cast) runs on
    those threads too, so the consumer's loop is queue-pop -> step;
  * there are no per-thread device workers: one stream consumes the
    batches, and the host threads overlap parse and shuffle with the steps;
  * global_shuffle partitions by sample hash across trainers: every
    trainer loads the shared filelist and keeps hash(i) % nranks == rank,
    the reference's post-condition (each sample on exactly one trainer,
    seeded random order) without a fleet send path.
With set_thread(n > 1) a QueueDataset yields batches in the order its
threads finish them.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from . import flags, profiler
from .data_feeder import pad_feed_to_bucket
from .native import parse_multislot_file

__all__ = ["DatasetFactory", "QueueDataset", "InMemoryDataset", "MultiSlotDataset"]

# how long an abandoned QueueDataset iteration waits, with nothing arriving,
# for its stopped workers' sentinels
_DRAIN_S = 2.0


class DatasetFactory:
    """reference dataset.py:21 — create_dataset("QueueDataset"|"InMemoryDataset")."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        try:
            cls = {
                "QueueDataset": QueueDataset,
                "InMemoryDataset": InMemoryDataset,
                "MultiSlotDataset": QueueDataset,  # C++ name accepted too
            }[datafeed_class]
        except KeyError:
            raise ValueError(
                f"datafeed class {datafeed_class} does not exist")
        return cls()


class DatasetBase:
    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist: list[str] = []
        self.use_vars = []
        self.pipe_command = None  # accepted for API parity; not a hot path
        self.drop_last = False
        self._seed = 0

    # -- reference setters ---------------------------------------------------
    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num: int):
        self.thread_num = max(1, int(thread_num))

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        """Declare the slot layout: one slot per var, width = prod(var.shape)."""
        self.use_vars = list(var_list)

    def set_pipe_command(self, pipe_command: str):
        self.pipe_command = pipe_command

    def set_drop_last(self, drop_last: bool):
        self.drop_last = bool(drop_last)

    # -- slot layout ---------------------------------------------------------
    def _widths(self):
        ws = []
        for v in self.use_vars:
            shape = [d for d in v.shape if d not in (-1, None)]
            w = 1
            for d in shape:
                w *= int(d)
            ws.append(max(1, w))
        return ws

    def _split_batch(self, flat: np.ndarray) -> dict:
        """[B, sum(widths)] float64 -> {var name: [B, *shape] typed array}.

        Under FLAGS_feed_bucketing the ragged tail batch of an epoch is
        padded up to batch_size with zero rows and the feed gains the
        float32 row mask (data_feeder.ROW_MASK_NAME): every batch of the
        epoch then has one shape. Programs that must be exact under
        padding weight their per-row losses by the mask."""
        feed = {}
        off = 0
        for v, w in zip(self.use_vars, self._widths()):
            part = flat[:, off:off + w]
            off += w
            shape = [d for d in v.shape if d not in (-1, None)]
            arr = part.reshape([part.shape[0]] + [int(d) for d in shape])
            # id/label slots declared int64 cast straight to the int32 the
            # device runs (np_feed_dtype): explicit truncation at the feed
            # boundary
            feed[v.name] = arr.astype(v.np_feed_dtype, copy=False)
        if flags.get_flag("feed_bucketing"):
            feed = pad_feed_to_bucket(feed, self.batch_size)
        return feed

    def _parse_file(self, path: str) -> np.ndarray:
        with profiler.stage_timer("dataset.parse"):
            return parse_multislot_file(path, self._widths())

    # executor hooks (reference _prepare_to_run/_finish_to_run)
    def _prepare_to_run(self):
        if not self.use_vars:
            raise RuntimeError("Dataset.set_use_var must be called first")

    def _finish_to_run(self):
        pass


class QueueDataset(DatasetBase):
    """Streaming dataset (reference dataset.py:613): files are parsed by a
    thread pool during iteration; nothing is retained afterwards.

    Batch assembly (the `_split_batch` slice/reshape/dtype-cast fan-out)
    runs on the parser workers too, not on the consuming thread: workers
    hand the executor feed-ready dicts, so the consumer's epoch loop is
    queue-pop -> step. Parse and assembly time land on the
    `dataset.parse` and `dataset.assemble` stage counters."""

    def _iter_batches(self):
        self._prepare_to_run()
        files = queue.Queue()
        for f in self.filelist:
            files.put(f)
        out: queue.Queue = queue.Queue(maxsize=max(4, 2 * self.thread_num))
        n_workers = min(self.thread_num, max(1, len(self.filelist)))
        errors: list[BaseException] = []
        stop = threading.Event()  # consumer abandoned the generator

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                while not stop.is_set():
                    try:
                        path = files.get_nowait()
                    except queue.Empty:
                        return
                    data = self._parse_file(path)
                    for i in range(0, len(data), self.batch_size):
                        chunk = data[i:i + self.batch_size]
                        if self.drop_last and len(chunk) < self.batch_size:
                            continue
                        try:
                            with profiler.stage_timer("dataset.assemble"):
                                feed = self._split_batch(chunk)
                        except (ValueError, TypeError):
                            # corrupt record died in assembly, off-thread:
                            # same skip-and-count contract as the executor's
                            # own conversion site
                            if not flags.get_flag("feed_skip_corrupt"):
                                raise
                            profiler.bump("feed.skip_corrupt")
                            continue
                        if not _put(feed):
                            return
            except BaseException as e:  # propagate into the consumer
                errors.append(e)
            finally:
                _put(None) or out.put(None)  # sentinel must always land

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        finished = 0
        try:
            while finished < n_workers:
                item = out.get()
                if item is None:
                    finished += 1
                    continue
                yield item  # already assembled by the worker
        finally:
            # early exit (exe.run raised / caller broke out): unblock workers
            # and take their sentinels; a stopped worker posts its sentinel
            # within a put timeout, so a drain that sees nothing for
            # _DRAIN_S gives up (the workers no longer run once the
            # interpreter is shutting down, where an abandoned generator is
            # closed last)
            stop.set()
            idle = 0.0
            while finished < n_workers and idle < _DRAIN_S:
                try:
                    item = out.get(timeout=0.1)
                except queue.Empty:
                    idle += 0.1
                    continue
                idle = 0.0
                if item is None:
                    finished += 1
        if errors:
            raise errors[0]


class InMemoryDataset(DatasetBase):
    """reference dataset.py:269 — load once, shuffle in memory, iterate many
    epochs; global_shuffle partitions samples across fleet trainers."""

    def __init__(self):
        super().__init__()
        self._data: np.ndarray | None = None

    def load_into_memory(self):
        self._prepare_to_run()
        parts = []
        files = queue.Queue()
        for f in self.filelist:
            files.put(f)
        lock = threading.Lock()
        errors: list[BaseException] = []

        def worker():
            try:
                while True:
                    try:
                        path = files.get_nowait()
                    except queue.Empty:
                        return
                    d = self._parse_file(path)
                    with lock:
                        parts.append(d)
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.thread_num,
                                      max(1, len(self.filelist))))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        self._data = (np.concatenate(parts) if parts
                      else np.zeros((0, int(sum(self._widths())))))

    def preload_into_memory(self):
        self._preload_error: BaseException | None = None

        def _load():
            try:
                self.load_into_memory()
            except BaseException as e:
                self._preload_error = e

        self._preload = threading.Thread(target=_load)
        self._preload.start()

    def wait_preload_done(self):
        self._preload.join()
        if self._preload_error is not None:
            raise self._preload_error

    def local_shuffle(self):
        if self._data is None:
            raise RuntimeError("call load_into_memory() before local_shuffle()")
        rng = np.random.default_rng(self._seed)
        self._seed += 1
        rng.shuffle(self._data)

    def global_shuffle(self, fleet=None, thread_num: int | None = None):
        """Keep this trainer's hash partition of the (shared) sample set,
        shuffled. Matches the reference post-condition when every trainer
        loaded the same filelist (data_set.cc GlobalShuffle's send-by-hash)."""
        if self._data is None:
            raise RuntimeError("call load_into_memory() before global_shuffle()")
        rank, nranks = 0, 1
        if fleet is not None:
            rank, nranks = fleet.worker_index(), fleet.worker_num()
        rng = np.random.default_rng(self._seed)
        self._seed += 1
        perm = rng.permutation(len(self._data))
        if nranks > 1:
            perm = perm[perm % nranks == rank]
        self._data = self._data[perm]

    def release_memory(self):
        self._data = None

    def get_memory_data_size(self, fleet=None) -> int:
        n = 0 if self._data is None else len(self._data)
        return n  # per-trainer count; fleet-wide sum needs a collective

    get_shuffle_data_size = get_memory_data_size

    def _iter_batches(self):
        """Assembly double-buffers ahead of the consumer (the pyreader.py
        pattern): one background thread slices/reshapes/casts the next
        batches while the device chews on the current one, bounded at
        depth 2 so a slow consumer doesn't balloon host memory."""
        self._prepare_to_run()
        if self._data is None:
            raise RuntimeError(
                "InMemoryDataset: call load_into_memory() before training")
        out: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()
        errors: list[BaseException] = []

        def assembler():
            try:
                for i in range(0, len(self._data), self.batch_size):
                    chunk = self._data[i:i + self.batch_size]
                    if self.drop_last and len(chunk) < self.batch_size:
                        continue
                    with profiler.stage_timer("dataset.assemble"):
                        feed = self._split_batch(chunk)
                    while not stop.is_set():
                        try:
                            out.put(feed, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:
                errors.append(e)
            finally:
                while not stop.is_set():
                    try:
                        out.put(None, timeout=0.2)
                        return
                    except queue.Full:
                        continue

        t = threading.Thread(target=assembler, daemon=True)
        t.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
        if errors:
            raise errors[0]


MultiSlotDataset = QueueDataset
