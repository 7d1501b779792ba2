"""MovieLens-1M recommendation (reference python/paddle/dataset/movielens.py):
each sample is user features + movie features + [[rating]] —
[user_id, gender_id, age_id, job_id, movie_id, category_ids, title_ids,
[rating]] matching the reference's `usr.value() + mov.value() + [[rating]]`
(movielens.py:166).

Real data: place ml-1m.zip under DATA_HOME/movielens (reference layout:
users.dat/movies.dat/ratings.dat '::'-separated). Zero-egress fallback:
deterministic synthetic interactions with the same id spaces.
"""
from __future__ import annotations

import re
import zipfile

import numpy as np

from .common import locate

__all__ = [
    "train", "test", "get_movie_title_dict", "max_movie_id", "max_user_id",
    "max_job_id", "age_table", "movie_categories", "is_synthetic",
]

age_table = [1, 18, 25, 35, 45, 50, 56]

_SYN_USERS, _SYN_MOVIES = 500, 400
_SYN_CATS, _SYN_TITLE_WORDS = 18, 1500
_SYN_TRAIN, _SYN_TEST = 4096, 512
_SYN_JOBS = 21


def is_synthetic() -> bool:
    return locate("movielens", "ml-1m.zip") is None


def max_user_id() -> int:
    return _SYN_USERS if is_synthetic() else _real()["max_user"]


def max_movie_id() -> int:
    return _SYN_MOVIES if is_synthetic() else _real()["max_movie"]


def max_job_id() -> int:
    return _SYN_JOBS - 1


def movie_categories() -> list[str]:
    if is_synthetic():
        return [f"cat{i}" for i in range(_SYN_CATS)]
    return sorted(_real()["categories"])


def get_movie_title_dict() -> dict:
    if is_synthetic():
        return {f"t{i}": i for i in range(_SYN_TITLE_WORDS)}
    return _real()["title_dict"]


_cache: dict = {}


def _real():
    if _cache:
        return _cache
    path = locate("movielens", "ml-1m.zip")
    users, movies, ratings = {}, {}, []
    categories, title_words = set(), {}
    with zipfile.ZipFile(path) as zf:
        def _lines(name):
            for n in zf.namelist():
                if n.endswith(name):
                    return zf.read(n).decode("latin1").splitlines()
            return []

        for line in _lines("users.dat"):
            uid, gender, age, job, _ = line.split("::")
            # reference UserInfo.value(): 0 if male else 1
            users[int(uid)] = [int(uid), int(gender != "M"),
                              age_table.index(int(age)), int(job)]
        for line in _lines("movies.dat"):
            mid, title, cats = line.split("::")
            words = re.findall(r"[a-z0-9]+", title.lower())
            for w in words:
                title_words.setdefault(w, len(title_words))
            cat_list = cats.strip().split("|")
            categories.update(cat_list)
            movies[int(mid)] = (words, cat_list)
        cat_idx = {c: i for i, c in enumerate(sorted(categories))}
        for line in _lines("ratings.dat"):
            uid, mid, r, _ = line.split("::")
            uid, mid = int(uid), int(mid)
            if uid in users and mid in movies:
                words, cat_list = movies[mid]
                ratings.append(
                    users[uid]
                    + [mid, [cat_idx[c] for c in cat_list],
                       [title_words[w] for w in words], [float(r)]])
    _cache.update(
        max_user=max(users), max_movie=max(movies),
        categories=categories, title_dict=title_words, samples=ratings)
    return _cache


def _synthetic(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        uid = int(rng.integers(1, _SYN_USERS + 1))
        mid = int(rng.integers(1, _SYN_MOVIES + 1))
        cats = rng.integers(0, _SYN_CATS, int(rng.integers(1, 4))).tolist()
        title = rng.integers(0, _SYN_TITLE_WORDS,
                             int(rng.integers(1, 6))).tolist()
        # deterministic preference structure so models can actually learn
        rating = 1.0 + ((uid * 7 + mid * 13) % 9) / 2.0
        yield [uid, int(uid % 2), int(uid % len(age_table)),
               int(uid % _SYN_JOBS), mid, cats, title, [rating]]


def _reader(split, n, seed):
    def reader():
        if is_synthetic():
            yield from _synthetic(n, seed)
            return
        samples = _real()["samples"]
        # reference __initialize_meta_info__ shuffles then splits 9:1
        rng = np.random.default_rng(0)
        idx = rng.permutation(len(samples))
        cut = int(len(samples) * 0.9)
        chosen = idx[:cut] if split == "train" else idx[cut:]
        for i in chosen:
            yield samples[i]

    return reader


def train():
    return _reader("train", _SYN_TRAIN, 0)


def test():
    return _reader("test", _SYN_TEST, 1)
