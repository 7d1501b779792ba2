"""Gradient clipping appended during apply_gradients (the JAX package's
clip.py, whole). The global-norm clip builds its reduction as ops in the
program."""
from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops"]


class BaseGradientClipAttr:
    def _create_operators(self, param, grad, helper):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _create_operators(self, param, grad, helper):
        out = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op("clip", inputs={"X": [grad]}, outputs={"Out": [out]},
                         attrs={"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad, helper):
        out = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op("clip_by_norm", inputs={"X": [grad]},
                         outputs={"Out": [out]},
                         attrs={"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_all(self, params_grads, helper):
        from .layers import nn as L
        from .layers import tensor as T

        sq_norms = []
        for _, g in params_grads:
            if g is None:
                continue
            sq = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op("squared_l2_norm", inputs={"X": [g]},
                             outputs={"Out": [sq]})
            sq_norms.append(sq)
        global_sq = helper.create_variable_for_type_inference(sq_norms[0].dtype)
        helper.append_op("sum", inputs={"X": sq_norms},
                         outputs={"Out": [global_sq]})
        global_norm = L.sqrt(global_sq)
        clip_var = T.fill_constant([1], "float32", self.clip_norm)
        # scale = clip / max(clip, global_norm)
        factor = L.elementwise_div(clip_var,
                                   L.elementwise_max(global_norm, clip_var))
        return [(p, g if g is None else L.elementwise_mul(g, factor))
                for p, g in params_grads]


_global_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_clip
    _global_clip = clip


def append_gradient_clip_ops(params_grads):
    helper = LayerHelper("gradient_clip")
    if isinstance(_global_clip, GradientClipByGlobalNorm):
        return _global_clip._clip_all(params_grads, helper)
    out = []
    for p, g in params_grads:
        clip_attr = getattr(p, "gradient_clip_attr", None) or _global_clip
        if g is None or clip_attr is None:
            out.append((p, g))
            continue
        out.append(clip_attr._create_operators(p, g, helper))
    return out
