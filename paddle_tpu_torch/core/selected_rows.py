"""SelectedRows: a sparse row set {rows, values} of a dense [height, ...]
tensor (the JAX package's core/selected_rows.py).

`rows[i]` is the dense row index of `values[i]`; duplicates are allowed and
merge by addition. `rows` has a fixed length K (the lookups of a batch), so
a sparse gradient never depends on the data for its shape. The executor
carries one through its environment like a tensor (a sparse embedding
gradient, the `sum` of several) and never writes one to the scope.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SelectedRows", "is_selected_rows"]


class SelectedRows:
    def __init__(self, rows, values, height: int):
        self.rows = rows          # int32 [K]
        self.values = values      # [K, width...]
        self.height = int(height)  # the dense dim-0 extent

    def to_dense(self) -> torch.Tensor:
        """Add the rows into a dense [height, ...] zero tensor (duplicates
        merge). `index_add_` takes int64 indices: the cast runs on the
        device."""
        dense = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                            dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add_(0, self.rows.long(), self.values)

    def merged(self):
        """Host-side merge of duplicate rows -> (unique_rows, summed
        values) as numpy arrays."""
        rows = np.asarray(_host(self.rows))
        vals = np.asarray(_host(self.values))
        uniq, inv = np.unique(rows, return_inverse=True)
        out = np.zeros((len(uniq),) + vals.shape[1:], vals.dtype)
        np.add.at(out, inv, vals)
        return uniq, out

    def __repr__(self):
        return (f"SelectedRows(rows={tuple(getattr(self.rows, 'shape', ()))}, "
                f"values={tuple(getattr(self.values, 'shape', ()))}, "
                f"height={self.height})")


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def is_selected_rows(v) -> bool:
    return isinstance(v, SelectedRows)
