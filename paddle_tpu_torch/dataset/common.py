"""Shared dataset plumbing (reference python/paddle/dataset/common.py:
DATA_HOME, download, md5file). Nothing is downloaded: `locate` finds a
pre-placed file under DATA_HOME or returns None. DATA_HOME is read from
PADDLE_TPU_DATA_HOME at import, as in the JAX package."""
from __future__ import annotations

import os

__all__ = ["DATA_HOME", "locate"]

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu", "dataset"),
)


def locate(module: str, filename: str) -> str | None:
    for base in (os.path.join(DATA_HOME, module), DATA_HOME):
        p = os.path.join(base, filename)
        if os.path.exists(p):
            return p
    return None
