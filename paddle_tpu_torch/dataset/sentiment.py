"""NLTK movie-review sentiment (reference
python/paddle/dataset/sentiment.py:116): samples are
(word_ids tuple, label 0/1); get_word_dict() gives the frequency-ranked
vocabulary.

Real data: movie_reviews.zip (NLTK corpus layout, pos/neg folders of .txt)
under DATA_HOME/sentiment. Zero-egress fallback: deterministic synthetic
reviews whose word distribution differs by class.
"""
from __future__ import annotations

import re
import zipfile

import numpy as np

from .common import locate

__all__ = ["train", "test", "get_word_dict", "is_synthetic"]

_VOCAB = 2000
_SYN_TRAIN, _SYN_TEST = 1600, 400
_TOKEN = re.compile(r"[a-z]+")


def is_synthetic() -> bool:
    return locate("sentiment", "movie_reviews.zip") is None


_cache: dict = {}


def get_word_dict() -> dict:
    if "wd" in _cache:
        return _cache["wd"]
    path = locate("sentiment", "movie_reviews.zip")
    if path:
        freq: dict = {}
        with zipfile.ZipFile(path) as zf:
            for n in zf.namelist():
                if n.endswith(".txt"):
                    for w in _TOKEN.findall(
                            zf.read(n).decode("latin1").lower()):
                        freq[w] = freq.get(w, 0) + 1
        wd = {w: i for i, w in enumerate(
            sorted(freq, key=lambda w: (-freq[w], w)))}
    else:
        wd = {f"w{i}": i for i in range(_VOCAB)}
    _cache["wd"] = wd
    return wd


def _real_samples():
    if "samples" in _cache:
        return _cache["samples"]
    wd = get_word_dict()
    path = locate("sentiment", "movie_reviews.zip")
    samples = []
    with zipfile.ZipFile(path) as zf:
        for n in sorted(zf.namelist()):
            m = re.search(r"(pos|neg)/[^/]+\.txt$", n)
            if m:
                ids = [wd[w] for w in _TOKEN.findall(
                    zf.read(n).decode("latin1").lower()) if w in wd]
                samples.append((tuple(ids), int(m.group(1) == "pos")))
    rng = np.random.default_rng(0)
    rng.shuffle(samples)
    _cache["samples"] = samples
    return samples


def _synthetic(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        label = int(rng.integers(0, 2))
        length = int(rng.integers(10, 120))
        # class-conditional token distribution: pos reviews skew low ids
        base = 0 if label else _VOCAB // 2
        ids = (base + rng.integers(0, _VOCAB // 2, length)).tolist()
        yield tuple(ids), label


def _reader(split, n, seed):
    def reader():
        if is_synthetic():
            yield from _synthetic(n, seed)
            return
        samples = _real_samples()
        cut = int(len(samples) * 0.8)
        chosen = samples[:cut] if split == "train" else samples[cut:]
        yield from chosen

    return reader


def train():
    return _reader("train", _SYN_TRAIN, 0)


def test():
    return _reader("test", _SYN_TEST, 1)
