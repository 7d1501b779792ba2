"""Host-side weighted averaging of fetched batch metrics (the JAX package's
average.py, a copy: it is numpy only). `WeightedAverage` accumulates
(value, weight) pairs, typically per-batch losses fetched from
`Executor.run` with their batch sizes, and reports their running weighted
mean. Nothing here touches the device.
"""
from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_or_matrix(x) -> bool:
    return isinstance(x, (int, float, complex, np.number, np.ndarray))


class WeightedAverage:
    """reference average.py:36 — add(value, weight), eval(); reset() clears."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError(
                "The 'value' must be a number(int, float) or a numpy ndarray")
        if not _is_number_or_matrix(weight):
            raise ValueError("The 'weight' must be a number(int, float)")
        value = np.mean(np.asarray(value, dtype=np.float64))
        weight = float(np.asarray(weight, dtype=np.float64).reshape(-1)[0])
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage")
        if self.denominator == 0:
            raise ValueError("The total weight is zero, can not average")
        return self.numerator / self.denominator
