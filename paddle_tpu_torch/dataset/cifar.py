"""CIFAR-10/100 (reference python/paddle/dataset/cifar.py): samples are
(image: float32[3072] in [0,1], label: int64)."""
from __future__ import annotations

import pickle
import tarfile

import numpy as np

from .common import locate

__all__ = ["train10", "test10", "train100", "test100", "is_synthetic"]

_SYN_TRAIN, _SYN_TEST = 4096, 512


def is_synthetic() -> bool:
    return locate("cifar", "cifar-10-python.tar.gz") is None


def _read_batches(tar_path: str, want_train: bool, label_key: str):
    with tarfile.open(tar_path, "r:gz") as tf:
        for member in tf.getmembers():
            name = member.name
            is_train = "data_batch" in name or "train" in name.split("/")[-1]
            is_test = "test" in name.split("/")[-1]
            if (want_train and is_train) or (not want_train and is_test):
                d = pickle.load(tf.extractfile(member), encoding="bytes")
                data = d[b"data"].astype(np.float32) / 255.0
                labels = next(
                    (v for k in (label_key.encode(), b"labels", b"fine_labels")
                     if (v := d.get(k)) is not None),
                    None,
                )
                if labels is None:
                    raise KeyError(
                        f"no label key in cifar batch: {sorted(d.keys())}")
                for row, lab in zip(data, labels):
                    yield row, int(lab)


def _synthetic(n, classes, seed):
    rng = np.random.default_rng(seed)
    protos = rng.random((classes, 3072)).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int64)
    imgs = np.clip(protos[labels] * 0.6 + rng.random((n, 3072)).astype(np.float32) * 0.4,
                   0.0, 1.0).astype(np.float32)
    for i in range(n):
        yield imgs[i], int(labels[i])


def _reader(archive, want_train, classes, label_key, seed):
    def reader():
        path = locate("cifar", archive)
        if path:
            yield from _read_batches(path, want_train, label_key)
        else:
            yield from _synthetic(_SYN_TRAIN if want_train else _SYN_TEST,
                                  classes, seed)

    return reader


def train10():
    return _reader("cifar-10-python.tar.gz", True, 10, "labels", 0)


def test10():
    return _reader("cifar-10-python.tar.gz", False, 10, "labels", 1)


def train100():
    return _reader("cifar-100-python.tar.gz", True, 100, "fine_labels", 2)


def test100():
    return _reader("cifar-100-python.tar.gz", False, 100, "fine_labels", 3)
