"""Reader composition toolkit: plain-python generators and decorators (the
JAX package's reader/__init__.py; the reference's reader/decorator.py and
batch.py).

A "reader creator" is a zero-arg callable returning a generator of samples.
These compose on the host; DataFeeder / PyReader batch them into padded
numpy arrays before a step.
"""
from __future__ import annotations

import itertools
import queue
import random as _random
import threading

from ..resilience.watchdog import StallError

__all__ = ["batch", "map_readers", "shuffle", "chain", "compose", "buffered",
           "firstn", "cache", "xmap_readers", "multiprocess_reader",
           "StallError"]


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of `batch_size` (reference batch.py:17)."""

    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    if batch_size <= 0:
        raise ValueError("batch_size must be a positive integer")
    return batch_reader


def map_readers(func, *readers):
    """Apply func to the items of several readers zipped together."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer of `buf_size` samples."""

    def shuffled_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return shuffled_reader


def chain(*readers):
    """Concatenate readers back to back."""

    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, check_alignment=True):
    """Zip readers into tuple samples (flattening tuple elements)."""

    def _flatten(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise RuntimeError("readers have different lengths")
                yield sum((_flatten(o) for o in outputs), ())
        else:
            for outputs in zip(*rs):
                yield sum((_flatten(o) for o in outputs), ())

    return reader


class _End:
    pass


_END = _End()


def _prefetch_iter(source_gen_fn, size, stall_window=None,
                   stall_what="prefetch consumer"):
    """Shared bounded-queue prefetch: propagates producer exceptions to the
    consumer and unblocks/stops the producer if the consumer abandons the
    iteration (no leaked threads stuck on q.put).

    stall_window (seconds, optional): bound the consumer's wait for the
    next staged batch — a producer that wedges without raising (hung I/O,
    a deadlocked transform) raises `StallError` with a queue
    state dump after the window instead of hanging the training loop
    forever."""
    q: queue.Queue = queue.Queue(maxsize=size)
    err: list = []
    stop = threading.Event()

    def fill():
        try:
            for d in source_gen_fn():
                while not stop.is_set():
                    try:
                        q.put(d, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=fill, daemon=True)
    t.start()

    def _get_bounded():
        import time

        deadline = time.monotonic() + stall_window
        while True:
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise StallError(
                        stall_what, stall_window,
                        {"queue_depth": q.qsize(), "queue_capacity": size,
                         "producer_alive": t.is_alive()})

    try:
        while True:
            e = (_get_bounded() if stall_window and stall_window > 0
                 else q.get())
            if e is _END:
                if err:
                    raise err[0]
                return
            yield e
    finally:
        stop.set()


def buffered(reader, size):
    """Prefetch up to `size` samples in a background thread. Producer
    exceptions re-raise in the consumer (a swallowed error would read as a
    silently short epoch)."""

    def buffered_reader():
        yield from _prefetch_iter(reader, size)

    return buffered_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                return
            yield item

    return firstn_reader


def cache(reader):
    """Materialize the full reader in memory on first COMPLETE pass. The
    cache commits atomically at the end of a pass, so a partially-consumed
    first iteration (e.g. peeking one sample) never poisons later epochs."""
    state = {"data": None}

    def cached_reader():
        if state["data"] is None:
            collecting = []
            for item in reader():
                collecting.append(item)
                yield item
            state["data"] = collecting
        else:
            yield from state["data"]

    return cached_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with `process_num` worker THREADS
    (reference uses threads too despite the name). Order-preserving mode
    tags samples with sequence ids."""

    end = object()

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)
        errors: list = []
        stop = threading.Event()

        def _put(q, item) -> bool:
            """Bounded put that gives up when the consumer abandoned us."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def read_into():
            try:
                for i, sample in enumerate(reader()):
                    if not _put(in_q, (i, sample)):
                        return
            except BaseException as e:
                errors.append(e)
            finally:
                # always deliver every worker its end marker, even after an
                # error — a missing sentinel deadlocks the whole pipeline
                for _ in range(process_num):
                    if not _put(in_q, end):
                        return

        def work():
            try:
                while not stop.is_set():
                    try:
                        item = in_q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if item is end:
                        return
                    i, sample = item
                    if not _put(out_q, (i, mapper(sample))):
                        return
            except BaseException as e:
                errors.append(e)
            finally:
                _put(out_q, end)

        threading.Thread(target=read_into, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True) for _ in range(process_num)]
        for w in workers:
            w.start()

        try:
            finished = 0
            if order:
                pending: dict = {}
                next_i = 0
                while finished < process_num:
                    item = out_q.get()
                    if item is end:
                        finished += 1
                        continue
                    i, mapped = item
                    pending[i] = mapped
                    while next_i in pending:
                        yield pending.pop(next_i)
                        next_i += 1
                for i in sorted(pending):
                    yield pending[i]
            else:
                while finished < process_num:
                    item = out_q.get()
                    if item is end:
                        finished += 1
                        continue
                    yield item[1]
            if errors:
                raise errors[0]
        finally:
            stop.set()

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """API-parity shim: runs the readers with thread workers (python
    multiprocessing brings no benefit for numpy-producing readers feeding
    one process's device; the reference targets CPU-bound python
    preprocessing)."""
    return buffered(chain(*readers), queue_size)
