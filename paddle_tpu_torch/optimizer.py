"""Optimizers: a program transformation that appends the backward pass and
one update op per parameter (the JAX package's optimizer.py :57-193,
:481-541).

`minimize(loss)` = `append_backward` + clip + regularization + the update
ops, with the learning rate and the accumulators created as persistable
vars in both the main and the startup program under the JAX package's
names, so both packages build identical training programs. Ported: the
`Optimizer` base, SGD, Momentum and Adam, and the minimize-time graph
passes (passes.py) that `backward` runs before `append_backward`. The JAX
package's dygraph path, the tuner hook and the numeric guardrails are not:
at their default flags they leave a program unchanged.
"""
from __future__ import annotations

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import Program, Variable, default_main_program
from .initializer import Constant
from .layer_helper import LayerHelper
from .passes import apply_minimize_passes
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
           "Adam", "AdamOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map: dict[Program, Variable] = {}
        # accumulator name -> {param name -> Variable}
        self._accumulators: dict[str, dict[str, Variable]] = {}
        self.helper: LayerHelper | None = None

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        helper = LayerHelper("learning_rate")
        self._learning_rate_map[program] = helper.create_or_get_global_variable(
            unique_name.generate("learning_rate"), [1], "float32",
            initializer=Constant(float(self._learning_rate)))

    def _global_learning_rate(self, program=None) -> Variable:
        return self._learning_rate_map[program or default_main_program()]

    def _create_param_lr(self, param):
        base_lr = self._global_learning_rate()
        mult = (param.optimize_attr.get("learning_rate", 1.0)
                if param.optimize_attr else 1.0)
        if mult == 1.0:
            return base_lr
        from .layers import nn as L

        return L.scale(base_lr, scale=float(mult))

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, dtype="float32", fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators.get(name, {}):
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_or_get_global_variable(
            unique_name.generate(f"{param.name}_{name}"),
            shape if shape is not None else list(param.shape), dtype,
            initializer=Constant(fill_value))
        var.is_opt_state = True
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- the transformation pipeline ----------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        # the graph rewrites come first: append_backward must see the fused
        # ops, whose grad ops it then emits
        apply_minimize_passes(default_main_program())
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        """clip -> regularize -> one update op per parameter."""
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self._create_optimization_pass(params_grads)

    def _create_optimization_pass(self, params_grads):
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        block = default_main_program().global_block
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = [self._append_optimize_op(block, (param, grad))
               for param, grad in params_grads
               if grad is not None and getattr(param, "trainable", True)]
        self._finish_update()
        return ops

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            "momentum",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Velocity": [velocity.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name],
                     "VelocityOut": [velocity.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super().__init__(learning_rate, regularization, name)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        return block.append_op(
            "adam",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
