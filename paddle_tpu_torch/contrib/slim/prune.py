"""Magnitude pruning: one-shot weight masking, the mask re-applied during
training, and a loss-sensitivity sweep to pick per-parameter ratios (the
JAX package's contrib/slim/prune.py, after the reference's slim/prune
SensitivePruneStrategy and StructurePruner).

  * `MagnitudePruner.prune_weights` zeroes the lowest-|w| entries (or whole
    output columns in structured mode) in the scope and stores a
    `<p>@prune_mask` there;
  * `MagnitudePruner.apply` also appends `p = p * mask` after the program's
    optimizer ops, so an update cannot bring a pruned weight back;
  * `sensitivity` measures the eval metric per (param, ratio).

The masks are chosen on the host in numpy (a rank selection, so exactly k
entries go, ties and all), the JAX package's selection entry for entry;
the masked weights stay tensors on the scope's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework import default_main_program

__all__ = ["MagnitudePruner", "sensitivity"]


class MagnitudePruner:
    def __init__(self, structured: bool = False):
        # structured=True prunes whole output columns (axis -1 groups, the
        # fc/conv filter analogue) by their L2 norm; False prunes elements
        self.structured = structured

    def _mask(self, w: np.ndarray, ratio: float) -> np.ndarray:
        if ratio <= 0:
            return np.ones_like(w, dtype=np.float32)
        # rank-based selection prunes exactly k entries: a magnitude
        # threshold would overshoot on ties (many exact zeros, or a
        # constant tensor pruning to nothing)
        if self.structured and w.ndim >= 2:
            norms = np.sqrt((w.astype(np.float64) ** 2).reshape(
                -1, w.shape[-1]).sum(axis=0))
            k = int(np.floor(ratio * norms.size))
            if k == 0:
                return np.ones_like(w, dtype=np.float32)
            col_mask = np.ones(norms.size, np.float32)
            col_mask[np.argpartition(norms, k - 1)[:k]] = 0.0
            return np.broadcast_to(col_mask, w.shape).astype(np.float32)
        flat = np.abs(w).reshape(-1)
        k = int(np.floor(ratio * flat.size))
        if k == 0:
            return np.ones_like(w, dtype=np.float32)
        mask = np.ones(flat.size, np.float32)
        mask[np.argpartition(flat, k - 1)[:k]] = 0.0
        return mask.reshape(w.shape)

    def prune_weights(self, scope, params, ratios) -> dict:
        """Zero the masked entries in `scope`; returns {param: mask} (numpy).
        `ratios` is a float (uniform) or {param: float}."""
        masks = {}
        for p in params:
            r = ratios[p] if isinstance(ratios, dict) else float(ratios)
            w = scope.find_var(p)
            m = self._mask(w.detach().cpu().numpy(), r)
            mt = torch.as_tensor(m, device=w.device)
            scope.set_var(p, (w * mt).to(w.dtype))
            scope.set_var(p + "@prune_mask", mt)
            masks[p] = m
        return masks

    def apply(self, params, ratios, scope, program=None):
        """prune_weights, then keep the pruned weights pruned through
        training: appends `p = elementwise_mul(p, mask)` after the existing
        ops (the optimizer's update among them), so each step re-zeroes."""
        program = program or default_main_program()
        masks = self.prune_weights(scope, params, ratios)
        block = program.global_block
        for p in params:
            mname = p + "@prune_mask"
            if not block.has_var(mname):
                v = block.var(p)
                block.create_var(name=mname, shape=v.shape, dtype="float32",
                                 persistable=True)
            block.append_op("elementwise_mul", {"X": [p], "Y": [mname]},
                            {"Out": [p]}, {"axis": -1})
        return masks


def sensitivity(program, scope, exe, params, eval_fn, ratios=(0.1, 0.3, 0.5),
                pruner: MagnitudePruner | None = None) -> dict:
    """The eval metric per (param, ratio): prunes one param at a time in a
    scratch copy of its value, calls `eval_fn() -> float` (higher is
    better), restores it; returns {param: {ratio: metric}}."""
    pruner = pruner or MagnitudePruner()
    out: dict = {}
    for p in params:
        orig = scope.find_var(p).clone()
        out[p] = {}
        for r in ratios:
            m = pruner._mask(orig.detach().cpu().numpy(), float(r))
            scope.set_var(p, (orig * torch.as_tensor(m, device=orig.device)
                              ).to(orig.dtype))
            out[p][float(r)] = float(eval_fn())
        scope.set_var(p, orig)
    return out
