"""WMT16 en-de translation (reference python/paddle/dataset/wmt16.py:142):
samples are (src_ids, trg_ids, trg_ids_next) int64 lists where
trg_ids = [<s>] + trg and trg_ids_next = trg + [<e>] — decoder input second,
next-token labels third, matching the reference tuple order.

Real data: place wmt16.tar.gz under DATA_HOME/wmt16; members whose names
contain the split ("train"/"val"/"test") are parsed as UTF-8 lines
"src sentence\ttrg sentence". Zero-egress fallback: deterministic synthetic
parallel corpus with the same tuple contract."""
from __future__ import annotations

import tarfile

import numpy as np

from .common import locate

__all__ = ["train", "test", "validation", "get_dict", "is_synthetic"]

_SRC_VOCAB = 2000
_TRG_VOCAB = 2000
_SYN_TRAIN, _SYN_TEST = 2048, 256
BOS, EOS, UNK = 0, 1, 2


def is_synthetic() -> bool:
    return locate("wmt16", "wmt16.tar.gz") is None


def get_dict(lang: str, dict_size: int | None = None, reverse=False):
    size = dict_size or (_SRC_VOCAB if lang == "en" else _TRG_VOCAB)
    d = {"<s>": BOS, "<e>": EOS, "<unk>": UNK}
    path = locate("wmt16", f"{lang}.dict")
    if path:
        with open(path, encoding="utf-8") as f:
            for line in f:
                w = line.strip()
                if w and w not in d and len(d) < size:
                    d[w] = len(d)
    else:
        for i in range(3, size):
            d[f"{lang}{i}"] = i
    return {v: k for k, v in d.items()} if reverse else d


def _parse_real(path, split, src_dict, trg_dict):
    with tarfile.open(path, "r:gz") as tf:
        for m in tf.getmembers():
            base = m.name.split("/")[-1]
            if split not in base or not m.isfile():
                continue
            for raw in tf.extractfile(m).read().decode("utf-8", "ignore").splitlines():
                if "\t" not in raw:
                    continue
                src_s, trg_s = raw.split("\t", 1)
                src = [src_dict.get(w, UNK) for w in src_s.split()]
                trg = [trg_dict.get(w, UNK) for w in trg_s.split()]
                if src and trg:
                    yield src, [BOS] + trg, trg + [EOS]


def _synthetic(n, src_vocab, trg_vocab, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        length = int(rng.integers(4, 50))
        src = rng.integers(3, src_vocab, length).tolist()
        # deterministic "translation": shifted token ids, same length
        trg = [3 + ((t - 3 + 7) % (trg_vocab - 3)) for t in src]
        yield src, [BOS] + trg, trg + [EOS]


def _reader(split, n, seed, src_vocab, trg_vocab):
    def reader():
        path = locate("wmt16", "wmt16.tar.gz")
        if path:
            yield from _parse_real(path, split, get_dict("en", src_vocab),
                                   get_dict("de", trg_vocab))
        else:
            yield from _synthetic(n, src_vocab, trg_vocab, seed)

    return reader


def train(src_dict_size=_SRC_VOCAB, trg_dict_size=_TRG_VOCAB, src_lang="en"):
    return _reader("train", _SYN_TRAIN, 0, src_dict_size, trg_dict_size)


def test(src_dict_size=_SRC_VOCAB, trg_dict_size=_TRG_VOCAB, src_lang="en"):
    return _reader("test", _SYN_TEST, 1, src_dict_size, trg_dict_size)


def validation(src_dict_size=_SRC_VOCAB, trg_dict_size=_TRG_VOCAB, src_lang="en"):
    return _reader("val", _SYN_TEST, 2, src_dict_size, trg_dict_size)
