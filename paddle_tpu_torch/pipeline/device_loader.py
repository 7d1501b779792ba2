"""DeviceLoader: a background thread that stages batches into device
memory ahead of the consumer (the JAX package's pipeline/device_loader.py).

While the device runs step i, the thread copies the feeds of steps
i+1..i+K (K = depth) to the card: each host array is cast to its var's
feed dtype, copied into pinned host memory and from there to the device
with `non_blocking=True` on a side CUDA stream of the thread's own, and an
event is recorded on that stream after the batch. The consumer's current
stream waits on the event before the batch is handed out, and each tensor
is `record_stream`ed to the consumer's stream, so the caching allocator
does not reuse its memory while the step may still read it. On a CPU
device placement is `torch.from_numpy`. The thread/queue contract is
`reader._prefetch_iter`'s: producer exceptions re-raise in the consumer
and an abandoned iteration stops the producer. The consumer's wait for the
next batch is bounded by the resilience watchdog's window
(`stall_window_s()`, FLAGS_watchdog_stall_s): a producer that wedges raises
`StallError` with the queue's state in the consumer. The producer passes
the `pipeline_stall` fault site once a batch and parks on an injected
fault, so that path is testable on a healthy host.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import flags, profiler
from ..core.selected_rows import is_selected_rows
from ..reader import _prefetch_iter

__all__ = ["DeviceLoader", "default_placement", "StagedBatch"]


class StagedBatch(dict):
    """A placed feed dict whose device copies were issued on `stream` and
    are complete at `event` (both None on the CPU)."""

    stream = None
    event = None

    def ready(self) -> dict:
        """Make the caller's current stream wait for the copies and mark
        every staged tensor as used by it; returns the plain feed dict."""
        if self.event is not None:
            consumer = torch.cuda.current_stream(self.event.device)
            consumer.wait_event(self.event)
            for v in self.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(consumer)
        return dict(self)


def placement(dtype_of, device, passthrough=()) -> callable:
    """A placement fn: `dtype_of(name)` gives the numpy dtype a host array
    of that feed is cast to (None: left as it is). Tensors, SelectedRows
    and the feeds named in `passthrough` (host-side values such as the
    tiered embeddings' resolution ticket) pass through. Records
    `pipeline.device_put` per array."""
    dev = torch.device(device)
    state = {}

    def place(feed: dict) -> StagedBatch:
        out = StagedBatch()
        stream = None
        if dev.type == "cuda":
            # the producer thread selects the device and copies on a side
            # stream of its own, made on its first batch
            torch.cuda.set_device(dev)
            stream = state.get("stream")
            if stream is None:
                stream = state["stream"] = torch.cuda.Stream(dev)
        for name, v in feed.items():
            if isinstance(v, torch.Tensor) or is_selected_rows(v) or \
                    name in passthrough:
                out[name] = v
                continue
            arr = np.asarray(v)
            dt = dtype_of(name)
            if dt is not None:
                arr = arr.astype(dt, copy=False)
            t0 = time.perf_counter()
            host = torch.from_numpy(np.ascontiguousarray(arr)
                                    if arr.ndim else arr)
            if stream is None:
                out[name] = host
            else:
                host = host.pin_memory()
                with torch.cuda.stream(stream):
                    out[name] = host.to(dev, non_blocking=True)
            profiler.record_stage("pipeline.device_put",
                                  time.perf_counter() - t0)
        if stream is not None:
            out.stream = stream
            out.event = torch.cuda.Event()
            out.event.record(stream)
        return out

    return place


def default_placement(feed_vars=None, device=None):
    """Placement fn for `DeviceLoader`: cast each host array to its feed
    var's feed dtype (the cast Executor.run applies) and stage it on
    `device` (CUDA unless the caller names another; with none named and no
    CUDA present this raises)."""
    from ..executor import resolve_device

    dtypes = {v.name: v.np_feed_dtype for v in (feed_vars or [])}
    return placement(dtypes.get, resolve_device(device))


class DeviceLoader:
    """Iterate `source` (a zero-arg callable returning a generator of feed
    dicts) with up to `depth` batches staged in device memory ahead of the
    consumer. Usable directly in a `for feed in loader:` loop."""

    def __init__(self, source, depth: int | None = None, placement=None,
                 feed_vars=None, device=None):
        if depth is None:
            depth = int(flags.get_flag("device_prefetch_depth"))
        self._source = source
        self.depth = max(1, int(depth))
        self._place = placement or default_placement(feed_vars, device)

    def __iter__(self):
        from ..resilience.faults import InjectedFault, fault_point
        from ..resilience.watchdog import stall_window_s

        source, place = self._source, self._place

        def staged():
            it = iter(source())
            while True:
                try:
                    fault_point("pipeline_stall")
                except InjectedFault:
                    # simulated wedge: the producer parks (a hung-I/O stand-
                    # in) so the consumer-side stall watchdog must fire; the
                    # parked daemon thread ends with the process
                    threading.Event().wait()
                t0 = time.perf_counter()
                try:
                    feed = next(it)
                except StopIteration:
                    return
                profiler.record_stage("pipeline.host_ingest",
                                      time.perf_counter() - t0)
                try:
                    staged_feed = place(feed)
                except (ValueError, TypeError):
                    # corrupt record: the batch died in the dtype cast —
                    # under FLAGS_feed_skip_corrupt count it and keep
                    # prefetching instead of ending the epoch
                    if not flags.get_flag("feed_skip_corrupt"):
                        raise
                    profiler.bump("feed.skip_corrupt")
                    continue
                yield staged_feed

        batches = _prefetch_iter(staged, self.depth,
                                 stall_window=stall_window_s() or None,
                                 stall_what="DeviceLoader batch wait")
        try:
            for feed in batches:
                yield feed.ready() if isinstance(feed, StagedBatch) else feed
        finally:
            batches.close()  # an abandoned iteration stops the producer

    # reader-creator calling convention (paddle readers are zero-arg callables)
    __call__ = __iter__
