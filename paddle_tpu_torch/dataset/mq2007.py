"""LETOR MQ2007 learning-to-rank dataset (reference
python/paddle/dataset/mq2007.py): LETOR-format lines
``rel qid:N 1:v1 2:v2 ... 46:v46 #docid ...`` grouped by query.

Readers mirror the reference's three formats:
  * pointwise — (feature [46], score)
  * pairwise  — (d_high [46], d_low [46]) for every rel_a > rel_b pair
  * listwise  — (label_list, feature_list) per query

Real data: Fold1/train.txt & Fold1/vali.txt & Fold1/test.txt under
DATA_HOME/MQ2007 (the reference's unzipped layout) — served by `train()`,
`vali()` and `test()` respectively. Zero-egress fallback: synthetic queries
whose relevance is a noisy linear function of the features, so rankers have
learnable signal.
"""
from __future__ import annotations

import numpy as np

from .common import locate

__all__ = ["train", "vali", "test", "Query", "QueryList", "is_synthetic"]

_N_FEATS = 46
_SYN_QUERIES = {"train": 120, "vali": 30, "test": 30}


class Query:
    """One judged document: relevance score, query id, feature vector
    (reference mq2007.py:50)."""

    def __init__(self, query_id=-1, relevance_score=-1, feature_vector=None,
                 description=""):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = feature_vector or []
        self.description = description

    def __str__(self):
        feats = " ".join(f"{i + 1}:{v}" for i, v in
                         enumerate(self.feature_vector))
        return f"{self.relevance_score} qid:{self.query_id} {feats}"

    @classmethod
    def parse(cls, line: str) -> "Query":
        body, _, desc = line.partition("#")
        parts = body.split()
        rel = int(parts[0])
        qid = int(parts[1].split(":")[1])
        feats = [float(p.split(":")[1]) for p in parts[2:]]
        return cls(qid, rel, feats, desc.strip())


class QueryList:
    """All docs of one query id (reference mq2007.py:106)."""

    def __init__(self, querylist=None):
        self.querylist = querylist or []
        self.query_id = self.querylist[0].query_id if self.querylist else -1

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def _correct_ranking_(self):
        self.querylist.sort(key=lambda q: q.relevance_score, reverse=True)

    def append(self, query: Query):
        self.querylist.append(query)
        self.query_id = query.query_id


def _synthetic_queries(tag: str):
    rng = np.random.default_rng({"train": 7, "vali": 9, "test": 8}[tag])
    w = np.random.default_rng(99).standard_normal(_N_FEATS)
    for qid in range(_SYN_QUERIES[tag]):
        ql = QueryList()
        for _ in range(int(rng.integers(5, 15))):
            f = rng.random(_N_FEATS)
            score = float(f @ w + rng.standard_normal() * 0.5)
            rel = int(np.clip(np.digitize(score, [-0.5, 1.0]), 0, 2))
            ql.append(Query(qid, rel, list(f.astype(float))))
        yield ql


def _file_queries(path: str):
    cur: QueryList | None = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            q = Query.parse(line)
            if cur is None or q.query_id != cur.query_id:
                if cur is not None and len(cur):
                    yield cur
                cur = QueryList()
            cur.append(q)
    if cur is not None and len(cur):
        yield cur


def _queries(tag: str):
    fname = {"train": "Fold1/train.txt", "vali": "Fold1/vali.txt",
             "test": "Fold1/test.txt"}[tag]
    path = locate("MQ2007", fname)
    return _file_queries(path) if path else _synthetic_queries(tag)


def is_synthetic() -> bool:
    return locate("MQ2007", "Fold1/train.txt") is None


def _reader(tag: str, format: str):
    def pointwise():
        for ql in _queries(tag):
            for q in ql:
                yield (np.array(q.feature_vector, np.float32),
                       np.array([q.relevance_score], np.float32))

    def pairwise():
        for ql in _queries(tag):
            docs = list(ql)
            for i, a in enumerate(docs):
                for b in docs[i + 1:]:
                    if a.relevance_score == b.relevance_score:
                        continue
                    hi, lo = ((a, b) if a.relevance_score >
                              b.relevance_score else (b, a))
                    yield (np.array(hi.feature_vector, np.float32),
                           np.array(lo.feature_vector, np.float32))

    def listwise():
        for ql in _queries(tag):
            labels = [float(q.relevance_score) for q in ql]
            feats = [np.array(q.feature_vector, np.float32) for q in ql]
            yield labels, feats

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[format]


def train(format="pairwise"):
    return _reader("train", format)


def vali(format="pairwise"):
    """The Fold1/vali.txt validation split (reference LETOR layout)."""
    return _reader("vali", format)


def test(format="pairwise"):
    return _reader("test", format)
