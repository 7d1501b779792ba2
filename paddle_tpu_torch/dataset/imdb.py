"""IMDB sentiment (reference python/paddle/dataset/imdb.py): samples are
(token_ids: int64 list, label: int64 0/1). word_dict() gives the vocab."""
from __future__ import annotations

import re
import tarfile

import numpy as np

from .common import locate

__all__ = ["train", "test", "word_dict", "is_synthetic"]

_VOCAB = 5147  # synthetic vocab size (reference build_dict cutoff ~5147)
_SYN_TRAIN, _SYN_TEST = 2048, 256
_TOKEN = re.compile(r"[a-z]+")


def is_synthetic() -> bool:
    return locate("imdb", "aclImdb_v1.tar.gz") is None


_word_dict_cache: dict = {}


def word_dict() -> dict:
    path = locate("imdb", "aclImdb_v1.tar.gz")
    key = path or "<synthetic>"
    if key in _word_dict_cache:
        return _word_dict_cache[key]
    if path:
        freq: dict = {}
        with tarfile.open(path, "r:gz") as tf:
            for m in tf.getmembers():
                if re.match(r"aclImdb/train/(pos|neg)/.*\.txt$", m.name):
                    text = tf.extractfile(m).read().decode("utf-8", "ignore").lower()
                    for w in _TOKEN.findall(text):
                        freq[w] = freq.get(w, 0) + 1
        words = sorted(freq, key=lambda w: (-freq[w], w))
        d = {w: i for i, w in enumerate(words)}
    else:
        d = {f"w{i}": i for i in range(_VOCAB - 1)}
    d["<unk>"] = len(d)
    _word_dict_cache[key] = d
    return d


def _parse(path, split, wd):
    unk = wd["<unk>"]
    with tarfile.open(path, "r:gz") as tf:
        for m in tf.getmembers():
            mm = re.match(rf"aclImdb/{split}/(pos|neg)/.*\.txt$", m.name)
            if mm:
                text = tf.extractfile(m).read().decode("utf-8", "ignore").lower()
                ids = [wd.get(w, unk) for w in _TOKEN.findall(text)]
                yield ids, int(mm.group(1) == "pos")


def _synthetic(n, seed, vocab=_VOCAB):
    rng = np.random.default_rng(seed)
    # class-dependent token distributions so the task is learnable
    for _ in range(n):
        label = int(rng.integers(0, 2))
        length = int(rng.integers(16, 128))
        lo, hi = (0, vocab // 2) if label == 0 else (vocab // 2, vocab)
        ids = rng.integers(lo, hi, length).tolist()
        yield ids, label


def _reader(split, seed, word_idx=None):
    def reader():
        path = locate("imdb", "aclImdb_v1.tar.gz")
        if path:
            yield from _parse(path, split, word_idx or word_dict())
        else:
            vocab = (max(word_idx.values()) + 1) if word_idx else _VOCAB
            yield from _synthetic(_SYN_TRAIN if split == "train" else _SYN_TEST,
                                  seed, vocab)

    return reader


def train(word_idx=None):
    """word_idx: optional custom vocabulary dict {word: id} (reference
    imdb.py train(word_idx)); ids are emitted from it so they never exceed
    the caller's embedding table."""
    return _reader("train", 0, word_idx)


def test(word_idx=None):
    return _reader("test", 1, word_idx)
