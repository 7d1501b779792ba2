"""Oxford-102 flowers (reference python/paddle/dataset/flowers.py:136):
samples are (image [3*224*224] float32 flattened CHW, label 0..101).

Real data: 102flowers.tgz + imagelabels.mat + setid.mat under
DATA_HOME/flowers (the reference's triple) — parsed only when scipy/PIL are
available. Zero-egress fallback: deterministic synthetic images whose class
determines the color statistics, so classifiers have learnable signal.
"""
from __future__ import annotations

import numpy as np

from .common import locate

__all__ = ["train", "test", "valid", "is_synthetic"]

_CLASSES = 102
_SYN_TRAIN, _SYN_TEST = 1024, 128
_SHAPE = (3, 224, 224)


def is_synthetic() -> bool:
    return locate("flowers", "102flowers.tgz") is None


def _synthetic(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        label = int(rng.integers(0, _CLASSES))
        # per-class channel means + noise
        means = np.array([(label * 37 % 97) / 97.0,
                          (label * 53 % 89) / 89.0,
                          (label * 71 % 83) / 83.0], np.float32)
        img = (means[:, None, None]
               + 0.1 * rng.standard_normal(_SHAPE).astype(np.float32))
        yield img.reshape(-1), label


def _real(split):
    import tarfile

    try:
        from scipy.io import loadmat
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "parsing real flowers data needs scipy (imagelabels.mat)") from e
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("parsing real flowers data needs PIL") from e
    import io

    labels = loadmat(locate("flowers", "imagelabels.mat"))["labels"][0]
    setid = loadmat(locate("flowers", "setid.mat"))
    # The reference deliberately swaps the official splits (flowers.py
    # TRAIN_FLAG='tstid', TEST_FLAG='trnid'): the official test set is the
    # large one, so training uses it.
    key = {"train": "tstid", "test": "trnid", "valid": "valid"}[split]
    wanted = set(int(i) for i in setid[key][0])
    with tarfile.open(locate("flowers", "102flowers.tgz"), "r:gz") as tf:
        for m in tf.getmembers():
            name = m.name.split("/")[-1]
            if not name.startswith("image_"):
                continue
            idx = int(name[6:11])
            if idx not in wanted:
                continue
            img = Image.open(io.BytesIO(tf.extractfile(m).read()))
            # the reference pipeline: resize_short(256) -> center_crop(224)
            # -> CHW (paddle.dataset.image.simple_transform)
            from . import image as img_utils

            arr = img_utils.simple_transform(
                np.asarray(img.convert("RGB")), 256, 224,
                is_train=False) / 255.0
            yield arr.reshape(-1), int(labels[idx - 1]) - 1


def _reader(split, n, seed, mapper=None, cycle=False):
    def reader():
        while True:
            it = _synthetic(n, seed) if is_synthetic() else _real(split)
            for sample in it:
                yield mapper(sample) if mapper is not None else sample
            if not cycle:
                return

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader("train", _SYN_TRAIN, 0, mapper, cycle)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader("test", _SYN_TEST, 1, mapper, cycle)


def valid(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader("valid", _SYN_TEST, 2, mapper, cycle)
