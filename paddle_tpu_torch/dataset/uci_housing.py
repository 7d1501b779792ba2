"""UCI housing regression (reference python/paddle/dataset/uci_housing.py):
samples are (features: float32[13] normalized, price: float32[1])."""
from __future__ import annotations

import numpy as np

from .common import locate

__all__ = ["train", "test", "is_synthetic"]

_N = 506  # real dataset size; synthetic matches


def is_synthetic() -> bool:
    return locate("uci_housing", "housing.data") is None


def _load():
    path = locate("uci_housing", "housing.data")
    if path:
        data = np.loadtxt(path).astype(np.float32)
        feats, prices = data[:, :-1], data[:, -1:]
    else:
        rng = np.random.default_rng(42)
        feats = rng.standard_normal((_N, 13)).astype(np.float32)
        w = rng.standard_normal((13, 1)).astype(np.float32)
        prices = (feats @ w + rng.standard_normal((_N, 1)).astype(np.float32) * 0.1
                  + 22.0).astype(np.float32)
    mu, sigma = feats.mean(0), feats.std(0) + 1e-8
    feats = (feats - mu) / sigma
    return feats, prices


def _reader(lo, hi):
    def reader():
        feats, prices = _load()
        n = len(feats)
        for i in range(int(lo * n), int(hi * n)):
            yield feats[i], prices[i]

    return reader


def train():
    return _reader(0.0, 0.8)


def test():
    return _reader(0.8, 1.0)
