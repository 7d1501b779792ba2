"""DataFeeder: convert python sample lists into batched numpy feed dicts
(the JAX package's data_feeder.py; the reference's fluid/data_feeder.py).

The reference builds LoDTensors for ragged sequences; here ragged fields are
padded to the batch max (plus an optional companion '<name>_len' length
vector in place of the LoD), the padding contract of the sequence ops.

Shape bucketing (FLAGS_feed_bucketing or an explicit bucket_size) rounds
the feed shapes to a small set, so every batch of an epoch, the ragged
tail included, has one shape (the JAX package compiles one executable per
shape; the port's eager steps need it only where a program must see one
shape, and for parity):
  * the batch dim pads up to the bucket size (explicit bucket_size, else the
    largest batch seen so far) with zero rows;
  * ragged sample dims round up to the next power of two;
  * a float32 [bucket, 1] row mask lands in the feed under ROW_MASK_NAME
    (1.0 real row / 0.0 padding). Loss/metric ops must honor it for exact
    numerics: `sum(per_row * mask) / sum(mask)` reproduces the unpadded
    result bit-for-bit on the real rows (tests/test_torch_data.py).
"""
from __future__ import annotations

import numpy as np

from . import flags, profiler
from .framework import Variable

__all__ = ["DataFeeder", "ROW_MASK_NAME", "pad_feed_to_bucket"]

# the row-mask convention shared by DataFeeder and the Dataset runtime: any
# program that wants exact numerics under bucketing declares a data var with
# this name, shape [1], dtype float32, and weights its per-row losses by it
ROW_MASK_NAME = "batch_mask"


def _tuned_extent(var_name: str, dim: int, raw: int, default_extent: int) -> int:
    """Bucket-boundary resolution through the autotuner (tuning/): the
    pow2/HWM default is the analytic prior, a swept-DB entry (keyed by the
    raw extent it buckets) overrides it, and sweep mode records every
    boundary actually exercised. An override below the raw extent is
    invalid (rows would be dropped) and falls through to the default."""
    from . import tuning

    if tuning.mode() == "off":
        return default_extent
    key = tuning.canonical_key(
        "feed_bucket", tuning.bucket_key(var_name, dim, raw), "-",
        tuning.device_kind())
    decision, _tier = tuning.decide(
        "feed_bucket", key,
        prior=lambda: {"pad_to": default_extent},
        default={"pad_to": default_extent},
        validate=lambda dd: isinstance(dd.get("pad_to"), int)
        and dd["pad_to"] >= raw)
    return int(decision.get("pad_to", default_extent))


def pad_feed_to_bucket(feed: dict, bucket: int,
                       mask_name: str = ROW_MASK_NAME) -> dict:
    """Pad every array's leading (batch) dim up to `bucket` rows with zeros
    and attach the [bucket, 1] float32 row mask. Always emits the mask — a
    feed whose key set changes between full and ragged batches would defeat
    the one shape bucketing exists for."""
    rows = next((np.asarray(v).shape[0] for v in feed.values()), bucket)
    bucket = _tuned_extent("<batch>", 0, rows, bucket)
    out = {}
    for name, v in feed.items():
        arr = np.asarray(v)
        if arr.shape[0] < bucket:
            pad = np.zeros((bucket - arr.shape[0],) + arr.shape[1:], arr.dtype)
            arr = np.concatenate([arr, pad])
        out[name] = arr
    mask = np.zeros((bucket, 1), np.float32)
    mask[:rows] = 1.0
    out[mask_name] = mask
    return out


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None, pad_ragged=True,
                 emit_lengths=False, bucket_size=None,
                 mask_name=ROW_MASK_NAME):
        self.feed_vars: list[Variable] = list(feed_list)
        self.place = place
        self.pad_ragged = pad_ragged
        self.emit_lengths = emit_lengths
        self.bucket_size = bucket_size
        self.mask_name = mask_name
        self._bucket_hwm = 0  # largest batch seen; the implicit bucket size

    def _bucketing(self) -> bool:
        return self.bucket_size is not None or flags.get_flag("feed_bucketing")

    def feed(self, iterable) -> dict:
        """iterable: list of samples; each sample is a tuple/list with one
        entry per feed var. Returns {var_name: batched ndarray}.

        Under FLAGS_feed_skip_corrupt a sample whose ndarray conversion or
        dtype cast raises (corrupt record) is dropped and counted on the
        profiler 'feed.skip_corrupt' counter instead of killing the epoch;
        a batch of ONLY corrupt samples still raises."""
        samples = list(iterable)
        if not samples:
            raise ValueError("DataFeeder.feed got an empty batch")
        if flags.get_flag("feed_skip_corrupt"):
            samples = self._drop_corrupt(samples)
        bucketing = self._bucketing()
        out = {}
        for i, var in enumerate(self.feed_vars):
            cols = [np.asarray(s[i]) for s in samples]
            # id/label vars declared int64 batch straight to int32 (the
            # port's runtime dtype): explicit at the feed boundary
            dtype = var.np_feed_dtype
            shapes = {c.shape for c in cols}
            if len(shapes) == 1:
                arr = np.stack(cols).astype(dtype, copy=False)
            elif self.pad_ragged:
                arr = _pad_stack(cols, dtype, round_ragged=bucketing,
                                 var_name=var.name)
                if self.emit_lengths:
                    out[var.name + "_len"] = np.asarray(
                        [c.shape[0] for c in cols], np.int32)
            else:
                raise ValueError(
                    f"ragged samples for '{var.name}' and pad_ragged=False")
            # vars declared with trailing dim 1 (labels [1]) accept scalars
            want_rank = len(var.shape)
            if arr.ndim == want_rank - 1:
                arr = arr[..., None]
            out[var.name] = arr
        if bucketing:
            self._bucket_hwm = max(self._bucket_hwm, len(samples))
            bucket = max(self.bucket_size or 0, self._bucket_hwm)
            out = pad_feed_to_bucket(out, bucket, self.mask_name)
        return out

    def _drop_corrupt(self, samples):
        """Pre-validate each sample field-by-field against its feed var's
        dtype; the survivors carry already-converted ndarrays so the batch
        build below never re-hits the corruption."""
        good, bad = [], 0
        for s in samples:
            try:
                good.append(tuple(
                    np.asarray(s[i]).astype(v.np_feed_dtype, copy=False)
                    for i, v in enumerate(self.feed_vars)))
            except (ValueError, TypeError, IndexError, OverflowError):
                bad += 1
        if bad:
            profiler.bump("feed.skip_corrupt", bad)
        if not good:
            raise ValueError(
                f"DataFeeder.feed: every sample in the batch ({bad}) failed "
                f"ndarray conversion (FLAGS_feed_skip_corrupt)")
        return good


def _pad_stack(cols, dtype, round_ragged=False, var_name=""):
    rank = cols[0].ndim
    maxes = [max(c.shape[d] for c in cols) for d in range(rank)]
    if round_ragged:
        # bucket ragged dims to the next power of two so consecutive batches
        # with nearby max lengths share one shape; uniform dims keep their
        # exact extent (they are part of the model's shape)
        maxes = [_tuned_extent(var_name, d + 1, m, _round_up_pow2(m))
                 if len({c.shape[d] for c in cols}) > 1 else m
                 for d, m in enumerate(maxes)]
    out = np.zeros([len(cols)] + maxes, dtype)
    for i, c in enumerate(cols):
        sl = tuple(slice(0, s) for s in c.shape)
        out[(i,) + sl] = c
    return out
