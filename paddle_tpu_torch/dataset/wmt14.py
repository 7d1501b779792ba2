"""WMT14 fr-en translation (reference python/paddle/dataset/wmt14.py:112):
samples are (src_ids, trg_ids, trg_ids_next) with trg_ids = [<s>] + trg and
trg_ids_next = trg + [<e>] — same contract as wmt16, different corpus.

Real data: wmt14.tgz under DATA_HOME/wmt14 with members containing the split
name, lines "src\ttrg". Zero-egress fallback: deterministic synthetic
parallel corpus.
"""
from __future__ import annotations

import tarfile

import numpy as np

from .common import locate

__all__ = ["train", "test", "get_dict", "is_synthetic"]

_DICT_SIZE = 30000
_SYN_TRAIN, _SYN_TEST = 2048, 256
BOS, EOS, UNK = 0, 1, 2


def is_synthetic() -> bool:
    return locate("wmt14", "wmt14.tgz") is None


def get_dict(dict_size: int = _DICT_SIZE, reverse=False):
    """Returns (src_dict, trg_dict) (reference wmt14.get_dict)."""
    def mk(lang):
        d = {"<s>": BOS, "<e>": EOS, "<unk>": UNK}
        for i in range(3, dict_size):
            d[f"{lang}{i}"] = i
        return {v: k for k, v in d.items()} if reverse else d

    return mk("fr"), mk("en")


def _parse_real(path, split, dict_size):
    src_dict, trg_dict = get_dict(dict_size)
    with tarfile.open(path, "r:gz") as tf:
        for m in tf.getmembers():
            if split not in m.name.split("/")[-1] or not m.isfile():
                continue
            for raw in tf.extractfile(m).read().decode(
                    "utf-8", "ignore").splitlines():
                if "\t" not in raw:
                    continue
                s, t = raw.split("\t", 1)
                src = [src_dict.get(w, UNK) for w in s.split()]
                trg = [trg_dict.get(w, UNK) for w in t.split()]
                if src and trg:
                    yield src, [BOS] + trg, trg + [EOS]


def _synthetic(n, dict_size, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        length = int(rng.integers(4, 40))
        src = rng.integers(3, dict_size, length).tolist()
        trg = [3 + ((t - 3 + 11) % (dict_size - 3)) for t in src]
        yield src, [BOS] + trg, trg + [EOS]


def _reader(split, n, seed, dict_size):
    def reader():
        path = locate("wmt14", "wmt14.tgz")
        if path:
            yield from _parse_real(path, split, dict_size)
        else:
            yield from _synthetic(n, dict_size, seed)

    return reader


def train(dict_size=_DICT_SIZE):
    return _reader("train", _SYN_TRAIN, 0, dict_size)


def test(dict_size=_DICT_SIZE):
    return _reader("test", _SYN_TEST, 1, dict_size)
