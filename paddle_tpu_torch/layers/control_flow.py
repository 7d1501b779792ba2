"""Control-flow layers (the JAX package's layers/control_flow.py). Only the
comparison the learning-rate schedules use is ported; While, cond, Switch
and the RNNs wait for the control-flow slice (ROADMAP Queue 1, book models,
nets, control flow, io and inference)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["less_than"]


def less_than(x, y, cond=None, force_cpu=None):
    """x < y elementwise, a bool var (or into `cond`)."""
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op("less_than", {"X": [x], "Y": [y]}, {"Out": [cond]}, {})
    return cond
