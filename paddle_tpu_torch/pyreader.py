"""PyReader / DataLoader: background-thread prefetch feeding the executor
(the JAX package's pyreader.py; the reference's fluid/reader.py PyReader
and buffered_reader.cc).

One background thread fills a bounded queue with ready feed dicts (the
LoDTensorBlockingQueue equivalent); with use_double_buffer=True (the
default, and the reference's buffered_reader) a second one,
pipeline.DeviceLoader, stages the next FLAGS_device_prefetch_depth batches
into device memory on a side CUDA stream, so the host-to-device copy
overlaps the running step and the consumer gets device tensors on `place`
(CUDA unless the caller names another). use_double_buffer=False keeps the
plain host-queue prefetch (numpy batches, placed by Executor.run).
`iterable=True` mode only (the reference itself deprecated the start/reset
reader-op protocol)."""
from __future__ import annotations

from .data_feeder import DataFeeder
from .executor import resolve_device
from .reader import _prefetch_iter

__all__ = ["PyReader", "DataLoader"]


class PyReader:
    def __init__(self, feed_list=None, capacity=64, use_double_buffer=True,
                 iterable=True, return_list=False, place=None):
        if not iterable:
            raise NotImplementedError(
                "non-iterable PyReader (start/reset protocol) is not "
                "supported; iterate the reader object instead")
        self.feed_list = feed_list
        self.capacity = capacity
        self.use_double_buffer = use_double_buffer
        self.return_list = return_list
        self._feeder = DataFeeder(feed_list) if feed_list else None
        self._source = None  # callable -> generator of feed dicts
        self.place = resolve_device(place) if use_double_buffer else None

    # -- decoration (reference reader.py:214-372) ---------------------------
    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        from . import reader as _reader

        self.decorate_sample_list_generator(
            _reader.batch(sample_generator, batch_size, drop_last), places)

    def decorate_sample_list_generator(self, reader, places=None):
        """reader: generator of SAMPLE LISTS (paddle.batch output)."""
        if self._feeder is None:
            raise ValueError("feed_list is required for sample-list mode")

        def gen():
            for samples in reader():
                yield self._feeder.feed(samples)

        self._source = gen

    def decorate_batch_generator(self, reader, places=None):
        """reader: generator of ready feed dicts (or tuples matching
        feed_list order)."""

        def gen():
            for item in reader():
                if isinstance(item, dict):
                    yield item
                else:
                    yield {v.name: a for v, a in zip(self.feed_list, item)}

        self._source = gen

    # -- iteration ----------------------------------------------------------
    def __call__(self):
        return self.__iter__()

    def __iter__(self):
        if self._source is None:
            raise RuntimeError("decorate_* must be called before iterating")
        if self.use_double_buffer:
            from .pipeline import DeviceLoader

            # two stages, mirroring the reference's queue + buffered_reader:
            # the host queue (capacity) absorbs reader jitter cheaply in
            # numpy; the DeviceLoader holds only a few batches on the card
            source, capacity = self._source, self.capacity
            it = iter(DeviceLoader(
                lambda: _prefetch_iter(source, capacity),
                feed_vars=self.feed_list, device=self.place))
        else:
            it = _prefetch_iter(self._source, self.capacity)
        try:
            for d in it:
                if self.return_list:
                    yield [d[v.name] for v in self.feed_list]
                else:
                    yield d
        finally:
            it.close()  # an abandoned iteration stops the threads


class DataLoader:
    """fluid.io.DataLoader facade (2.x-style entry the reference was growing
    toward); from_generator mirrors PyReader."""

    @staticmethod
    def from_generator(feed_list=None, capacity=64, use_double_buffer=True,
                       iterable=True, return_list=False, place=None):
        return PyReader(feed_list, capacity, use_double_buffer, iterable,
                        return_list, place)
