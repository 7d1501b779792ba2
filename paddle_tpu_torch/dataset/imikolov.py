"""PTB language modeling / imikolov (reference
python/paddle/dataset/imikolov.py:99): NGRAM mode yields n-gram tuples of
word ids (the word2vec training data); SEQ mode yields (src_seq, trg_seq)
shifted pairs.

Real data: simple-examples.tgz under DATA_HOME/imikolov (PTB layout).
Zero-egress fallback: deterministic synthetic corpus with Zipf-ish unigram
statistics.
"""
from __future__ import annotations

import tarfile

import numpy as np

from .common import locate

__all__ = ["train", "test", "build_dict", "DataType", "is_synthetic"]

_VOCAB = 2000
_SYN_SENTS_TRAIN, _SYN_SENTS_TEST = 2048, 256


class DataType:
    NGRAM = 1
    SEQ = 2


def is_synthetic() -> bool:
    return locate("imikolov", "simple-examples.tgz") is None


def build_dict(min_word_freq: int = 50) -> dict:
    path = locate("imikolov", "simple-examples.tgz")
    if path:
        # reference contract: count ptb.train.txt AND ptb.valid.txt, add one
        # '<s>'/'<e>' per line, keep words with freq strictly > threshold,
        # assign ids by (-frequency, word), then append only '<unk>'
        freq: dict = {}
        with tarfile.open(path, "r:gz") as tf:
            for m in tf.getmembers():
                if m.name.endswith(("ptb.train.txt", "ptb.valid.txt")):
                    for line in tf.extractfile(m).read().decode(
                            "utf-8").splitlines():
                        for w in line.split() + ["<s>", "<e>"]:
                            freq[w] = freq.get(w, 0) + 1
        words = sorted(
            ((w, c) for w, c in freq.items() if c > min_word_freq),
            key=lambda wc: (-wc[1], wc[0]))
        d = {w: i for i, (w, _) in enumerate(words)}
        d["<unk>"] = len(d)
    else:
        d = {f"w{i}": i for i in range(_VOCAB - 3)}
        d["<s>"] = len(d)
        d["<unk>"] = len(d)
        d["<e>"] = len(d)
    return d


def _sentences(split, n, seed, word_idx):
    path = locate("imikolov", "simple-examples.tgz")
    if path:
        unk = word_idx["<unk>"]
        fname = f"ptb.{split}.txt"
        with tarfile.open(path, "r:gz") as tf:
            for m in tf.getmembers():
                if m.name.endswith(fname):
                    for line in tf.extractfile(m).read().decode(
                            "utf-8").splitlines():
                        yield [word_idx.get(w, unk) for w in line.split()]
        return
    rng = np.random.default_rng(seed)
    v = len(word_idx)
    for _ in range(n):
        length = int(rng.integers(5, 30))
        # Zipf-ish draw: squared uniform concentrates mass on low ids
        yield (np.minimum((rng.random(length) ** 2) * v, v - 1)
               .astype(np.int64).tolist())


def _reader(split, n, seed, word_idx, ngram_n, data_type):
    def reader():
        s_, e = word_idx["<s>"], word_idx["<e>"]
        for sent in _sentences(split, n, seed, word_idx):
            if data_type == DataType.NGRAM:
                # reference wraps sentences ['<s>'] + l + ['<e>']
                l = [s_] + sent + [e]
                if len(l) >= ngram_n:
                    for i in range(ngram_n, len(l) + 1):
                        yield tuple(l[i - ngram_n:i])
            else:
                # reference SEQ: src = [<s>] + l, trg = l + [<e>],
                # skipping sentences longer than n (when n > 0)
                src, trg = [s_] + sent, sent + [e]
                if ngram_n > 0 and len(src) > ngram_n:
                    continue
                yield src, trg

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader("train", _SYN_SENTS_TRAIN, 0, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader("test", _SYN_SENTS_TEST, 1, word_idx, n, data_type)
