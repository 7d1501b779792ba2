"""MNIST (reference python/paddle/dataset/mnist.py): samples are
(image: float32[784] in [-1,1], label: int64 scalar)."""
from __future__ import annotations

import gzip
import struct

import numpy as np

from .common import locate

__all__ = ["train", "test", "is_synthetic"]

_TRAIN_N, _TEST_N = 8192, 1024  # synthetic sizes (real: 60000/10000)


def is_synthetic() -> bool:
    return locate("mnist", "train-images-idx3-ubyte.gz") is None


def _parse_idx(images_path: str, labels_path: str):
    with gzip.open(images_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad idx3 magic {magic}"
        imgs = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    with gzip.open(labels_path, "rb") as f:
        magic, n2 = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad idx1 magic {magic}"
        labels = np.frombuffer(f.read(), np.uint8)
    imgs = imgs.astype(np.float32) / 127.5 - 1.0
    return imgs, labels.astype(np.int64)


def _synthetic(n, seed):
    rng = np.random.default_rng(seed)
    # 10 fixed class prototypes + noise: learnable, deterministic
    protos = rng.standard_normal((10, 784)).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int64)
    imgs = np.clip(protos[labels] * 0.5 +
                   rng.standard_normal((n, 784)).astype(np.float32) * 0.3,
                   -1.0, 1.0).astype(np.float32)
    return imgs, labels


def _reader(split: str):
    def reader():
        img_f = locate("mnist", f"{split}-images-idx3-ubyte.gz")
        lbl_f = locate("mnist", f"{split}-labels-idx1-ubyte.gz")
        if img_f and lbl_f:
            imgs, labels = _parse_idx(img_f, lbl_f)
        else:
            n = _TRAIN_N if split == "train" else _TEST_N
            imgs, labels = _synthetic(n, seed=0 if split == "train" else 1)
        for i in range(len(labels)):
            yield imgs[i], int(labels[i])

    return reader


def train():
    return _reader("train")


def test():
    return _reader("t10k") if locate("mnist", "t10k-images-idx3-ubyte.gz") \
        else _reader("test")
