"""Weight-decay regularizers appended during apply_gradients (the JAX
package's regularizer.py, whole)."""
from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, helper):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, helper):
        decay = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op("scale", inputs={"X": [param]},
                         outputs={"Out": [decay]},
                         attrs={"scale": self._coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, helper):
        sign = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op("sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decay = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op("scale", inputs={"X": [sign]},
                         outputs={"Out": [decay]},
                         attrs={"scale": self._coeff})
        return decay


def append_regularization_ops(params_grads, regularization=None):
    """grad += coeff * decay(param) for each param; a parameter's own
    regularizer (ParamAttr) overrides the optimizer's."""
    out = []
    helper = LayerHelper("regularization")
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if reg is None or grad is None:
            out.append((param, grad))
            continue
        decay = reg.append_regularization_op(param, grad, helper)
        new_grad = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op("sum", inputs={"X": [grad, decay]},
                         outputs={"Out": [new_grad]})
        out.append((param, new_grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
