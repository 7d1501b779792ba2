"""Optimizers: a program transformation that appends the backward pass and
one update op per parameter (the JAX package's optimizer.py).

`minimize(loss)` = `append_backward` + clip + regularization + the update
ops, with the learning rate and the accumulators created as persistable
vars in both the main and the startup program under the JAX package's
names, so both packages build identical training programs. The learning
rate is a float or a schedule's var (layers/learning_rate_scheduler.py).
Ported: the `Optimizer` base and its twelve optimizers (SGD, Momentum,
DGCMomentum, LarsMomentum, Adagrad, Adam, Adamax, DecayedAdagrad,
Adadelta, RMSProp, Ftrl, Lamb), the ModelAverage, Lookahead and
ExponentialMovingAverage wrappers, and the minimize-time graph passes
(passes.py) that `backward` runs before `append_backward`. Not ported:
PipelineOptimizer (it raises), the dygraph path and the tuner hook, which
at its default flags leaves a program unchanged. Under
FLAGS_guard_numerics `apply_gradients` appends the numeric guard's health
sentinel (resilience/guardrails.py) after clip and regularization.

The wrappers' apply/restore swap values in a scope the caller names (the
port has no global scope); their averages are computed on the device.
"""
from __future__ import annotations

import contextlib

import torch

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import (Program, Variable, default_main_program,
                        default_startup_program)
from .initializer import Constant
from .layer_helper import LayerHelper
from .passes import apply_minimize_passes
from .tuning import on_minimize
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
           "DGCMomentumOptimizer", "Adagrad", "AdagradOptimizer", "Adam",
           "AdamOptimizer", "Adamax", "AdamaxOptimizer", "DecayedAdagrad",
           "DecayedAdagradOptimizer", "Adadelta", "AdadeltaOptimizer",
           "RMSProp", "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "Lamb",
           "LambOptimizer", "LarsMomentum", "LarsMomentumOptimizer",
           "ModelAverage", "LookaheadOptimizer", "ExponentialMovingAverage",
           "RecomputeOptimizer", "PipelineOptimizer"]


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
        # the numeric guardrail (resilience/guardrails.py) builds its health
        # vector over the loss: record it on the program (the AMP decorator
        # overwrites it with the unscaled loss)
        default_main_program()._guard_loss_name = loss.name
        # the tuning DB loads here: a corrupt file warns once, attached to
        # the minimize call, and the passes' decisions below resolve
        # against one snapshot; the program is stamped with the tuning mode
        on_minimize(default_main_program())
        # the graph rewrites come first: append_backward must see the fused
        # ops, whose grad ops it then emits
        apply_minimize_passes(default_main_program())
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        """clip -> regularize -> [health sentinel] -> one update op per
        parameter. Under FLAGS_guard_numerics every gradient goes through
        the health sentinel after clipping (a NaN that a global-norm clip
        smeared over all grads is still caught), so a bad step's update
        ops see zeros."""
        from .resilience import guardrails

        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        if guardrails.enabled():
            params_grads = guardrails.append_health_sentinel(params_grads)
        ops = self._create_optimization_pass(params_grads)
        # the StepGuard's rewind rung backs the LR off through the scope:
        # record where the LR lives (a schedule's LR var qualifies too)
        program = default_main_program()
        if program in self._learning_rate_map:
            program._guard_lr_name = self._global_learning_rate().name
        return ops

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


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep gradient compression momentum (optimizer.py:316): each step the
    `dgc` op keeps the top (1 - sparsity) of the momentum-corrected,
    locally accumulated gradient by magnitude, and a plain `sgd` applies
    it (the momentum already lives in dgc_u). The sparsity ramps up on the
    device from the program's own `@DGC_COUNTER@`."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None,
                 regularization=None, name=None):
        super().__init__(learning_rate, momentum, use_nesterov,
                         regularization, name)
        self.type = "dgc_momentum"
        sp = (list(sparsity) if isinstance(sparsity, (list, tuple))
              else [sparsity])
        self._sparsity_ramp = [float(x) for x in sp]
        self._sparsity = self._sparsity_ramp[-1]
        self._rampup_begin_step = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))

    def _dgc_step_counter(self):
        """The program's float32 dgc step counter, shared by every dgc op;
        its one increment precedes them, so the first run reads 0."""
        helper = LayerHelper("dgc_counter")
        name = "@DGC_COUNTER@"
        existed = name in default_main_program().global_block.vars
        counter = helper.create_or_get_global_variable(
            name, [1], "float32", initializer=Constant(-1.0))
        if not existed:
            helper.append_op("increment", {"X": [counter]},
                             {"Out": [counter]}, {"step": 1.0})
        return counter

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        u = self._get_accumulator("dgc_u", param)
        v = self._get_accumulator("dgc_v", param)
        step = self._dgc_step_counter()
        helper = LayerHelper("dgc")
        sparse_grad = helper.create_variable_for_type_inference(grad.dtype)
        cur_sparsity = helper.create_or_get_global_variable(
            unique_name.generate(f"{param.name}_dgc_sparsity"), [1],
            "float32", initializer=Constant(0.0))
        block.append_op(
            "dgc",
            inputs={"Grad": [grad.name], "U": [u.name], "V": [v.name],
                    "CurrentStep": [step.name]},
            outputs={"GradOut": [sparse_grad.name], "UOut": [u.name],
                     "VOut": [v.name], "Sparsity": [cur_sparsity.name]},
            attrs={"momentum": self._momentum, "sparsity": self._sparsity,
                   "sparsity_ramp": self._sparsity_ramp,
                   "rampup_begin_step": self._rampup_begin_step,
                   "rampup_step": self._rampup_step,
                   "use_nesterov": self._use_nesterov})
        return block.append_op(
            "sgd",
            inputs={"Param": [param.name], "Grad": [sparse_grad.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name]}, attrs={})


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Velocity": [velocity.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name],
                     "VelocityOut": [velocity.name]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return block.append_op(
            "adagrad",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment": [moment.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name], "MomentOut": [moment.name]},
            attrs={"epsilon": self._epsilon})


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


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        inf_norm = self._get_accumulator("inf_norm", param)
        return block.append_op(
            "adamax",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment": [moment.name], "InfNorm": [inf_norm.name],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc",
                                                       param).name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name], "MomentOut": [moment.name],
                     "InfNormOut": [inf_norm.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self):
        """beta1_pow *= beta1, one scale op per parameter after every
        update op (the JAX package's order)."""
        block = default_main_program().global_block
        for b1p in self._accumulators.get("beta1_pow_acc", {}).values():
            block.append_op("scale", inputs={"X": [b1p.name]},
                            outputs={"Out": [b1p.name]},
                            attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment": [moment.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name], "MomentOut": [moment.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        ag = self._get_accumulator("avg_squared_grad", param)
        au = self._get_accumulator("avg_squared_update", param)
        return block.append_op(
            "adadelta",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "AvgSquaredGrad": [ag.name],
                    "AvgSquaredUpdate": [au.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name],
                     "AvgSquaredGradOut": [ag.name],
                     "AvgSquaredUpdateOut": [au.name]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        mom = self._get_accumulator("momentum", param)
        ms = self._get_accumulator("mean_square", param)
        mg = self._get_accumulator("mean_grad", param)
        return block.append_op(
            "rmsprop",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment": [mom.name], "MeanSquare": [ms.name],
                    "MeanGrad": [mg.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name], "MomentOut": [mom.name],
                     "MeanSquareOut": [ms.name], "MeanGradOut": [mg.name]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return block.append_op(
            "ftrl",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "SquaredAccumulator": [sq.name],
                    "LinearAccumulator": [lin.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, regularization=None,
                 name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "lamb"
        self._weight_decay = lamb_weight_decay
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
            "lamb",
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
                    "LearningRate": [self._create_param_lr(param).name]},
            outputs={"ParamOut": [param.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon,
                   "weight_decay": self._weight_decay})


class RecomputeOptimizer:
    """Activation recompute (gradient checkpointing). `_set_checkpoints`
    names the segment boundaries (typically each transformer layer's
    output, `transformer.last_layer_outputs`); at minimize() the forward
    block is split after the ops that write them, each segment of two ops
    or more moves into a sub-block behind one `recompute` op, and the
    derived `recompute_grad` replays the segment under autograd. Only the
    segments' outputs stay live between the forward and the backward.

        opt = RecomputeOptimizer(pt.optimizer.Adam(1e-4))
        opt._set_checkpoints([layer1_out, layer2_out, ...])
        opt.minimize(loss)

    An op that draws random numbers would draw others in the replay, so a
    segment holding one is rejected. A kernel-backed op runs its
    torch.autograd.Function in the replay. The segment's persistable
    outputs (batch norm's running statistics) leave the forward run only:
    the replay's are discarded, so the statistics move once a step."""

    def __init__(self, optimizer):
        self._inner = optimizer
        self._checkpoints = []

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        self._rewrite(loss)
        return self._inner.backward(loss, startup_program, parameter_list,
                                    no_grad_set)

    def apply_gradients(self, params_grads):
        return self._inner.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        self._rewrite(loss)
        return self._inner.minimize(loss, startup_program, parameter_list,
                                    no_grad_set)

    def _rewrite(self, loss):
        """Move each checkpointed segment into a sub-block behind a
        `recompute` op, op for op as the JAX package's rewrite does."""
        from .framework import Operator
        from .ops.registry import get_op_def, has_op

        if not self._checkpoints:
            return
        program = loss.block.program
        block = program.global_block
        ck_set = {getattr(c, "name", c) for c in self._checkpoints}
        if getattr(program, "_recompute_done", False):
            return

        segments, cur, matched_any = [], [], False
        for op in block.ops:
            cur.append(op)
            if any(n in ck_set for n in op.output_names):
                matched_any = True
                segments.append(cur)
                cur = []
        if cur:
            segments.append(cur)   # the tail (the loss head) stays inline
        if not matched_any:
            raise ValueError(
                "RecomputeOptimizer: no checkpoint variable matched any op "
                "output in this program — the checkpoints likely came from a "
                "different program build (transformer.last_layer_outputs "
                "holds the MOST RECENT build's vars)")
        # reads_after[si]: the names read in the segments after si
        reads_after = [set() for _ in segments]
        acc: set = set()
        for si in range(len(segments) - 1, -1, -1):
            reads_after[si] = set(acc)
            acc.update(n for op in segments[si] for n in op.input_names if n)

        def _persistable(n):
            try:
                return block.var(n).persistable
            except KeyError:
                return False

        new_ops = []
        for si, seg in enumerate(segments[:-1]):
            wrap = [op for op in seg if op.type not in ("feed", "fetch")]
            new_ops.extend(op for op in seg if op.type in ("feed", "fetch"))
            if len(wrap) < 2:
                new_ops.extend(wrap)
                continue
            for op in wrap:
                if has_op(op.type) and get_op_def(op.type).needs_rng:
                    raise ValueError(
                        f"RecomputeOptimizer: op '{op.type}' consumes RNG "
                        "inside a recompute segment — its replay would draw "
                        "different numbers. Move it out of the segment "
                        "(e.g. dropout=0 under recompute).")
            # insertion-ordered, so the slots do not depend on hashing
            defined: dict = {}
            ext_reads = []
            for op in wrap:
                for n in op.input_names:
                    if n and n not in defined and n not in ext_reads:
                        ext_reads.append(n)
                for n in op.output_names:
                    if n:
                        defined[n] = True
            # persistable outputs (running statistics, counters) surface
            # even when nothing later reads them: the executor writes the
            # scope back from the top block's outputs only
            outs = [n for n in defined if n in reads_after[si]
                    or n in ck_set or _persistable(n)]
            sub = program._create_block()
            for op in wrap:
                sub.ops.append(op)
                op.block = sub
            program._rollback()
            new_ops.append(Operator(
                block, "recompute", {"Deps": list(ext_reads)},
                {"Out": list(outs)},
                {"sub_block": sub.idx, "dep_names": list(ext_reads),
                 "out_names": list(outs)}))
        new_ops.extend(segments[-1])
        if not any(op.type == "recompute" for op in new_ops):
            raise ValueError(
                "RecomputeOptimizer: checkpoints matched but produced no "
                "recompute segment — each non-tail segment needs >= 2 ops "
                "(is the checkpoint the program's last op, e.g. the loss?)")
        block.ops[:] = new_ops
        program._recompute_done = True


class PipelineOptimizer:
    """Pipeline-parallel training (the JAX package's optimizer.py:1141).

    Wraps an inner optimizer; `minimize` cuts the forward program at the
    `cut_list` variables into stages and attaches a microbatch plan
    (parallel/pipeline.py) as `program._pipeline`. `Executor.run` of the
    program then runs the whole schedule: each microbatch's forward, the
    rematerialised backward with the gradients summed, one step of the
    inner optimizer on their mean.

    `place_list` gives one device a stage (CUDAPlace, CPUPlace, an int
    CUDA ordinal, a device name or a torch.device): its parameters and
    state live there and boundary tensors move device to device.
    `schedule` is "1f1b" or "gpipe" (None: FLAGS_pipeline_schedule).
    `concurrency_list`, `queue_size`, `sync_steps` and `start_cpu_core_id`
    are accepted for the reference API's sake; the host drives the
    schedule in place of section threads and scope queues.

    An inner optimizer under `contrib.mixed_precision.decorate` rewrites
    the forward program to its low dtype first (AMP's cast pass), so the
    stages run mixed precision and update the fp32 master weights; loss
    scaling does not reach the stage programs and raises (bf16, the
    decorator's default, needs none)."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0, num_microbatches=4, schedule=None):
        self._inner_opt = optimizer
        self._cut_list = cut_list or []
        self._place_list = place_list
        self._num_microbatches = num_microbatches
        self._schedule = schedule

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .parallel.pipeline import build_pipeline_plan

        if isinstance(self._inner_opt._learning_rate, Variable):
            raise NotImplementedError(
                "PipelineOptimizer does not support LR-scheduler Variables "
                "yet: the scheduler ops live in the sliced forward program "
                "and would never run for the stage update programs. Use a "
                "float learning rate.")
        cuts = []
        for group in self._cut_list:
            cuts.extend(group if isinstance(group, (list, tuple)) else [group])
        program = loss.block.program
        inner = self._inner_opt
        from .contrib.mixed_precision.decorator import \
            OptimizerWithMixedPrecision

        if isinstance(inner, OptimizerWithMixedPrecision):
            from .contrib.mixed_precision.fp16_lists import \
                apply_tuning_overrides
            from .contrib.mixed_precision.fp16_utils import rewrite_program

            if inner._use_dynamic or inner._init_loss_scaling != 1.0:
                raise NotImplementedError(
                    "PipelineOptimizer over decorate(...) with loss scaling: "
                    "the scaling ops would not reach the stage programs; "
                    "decorate with init_loss_scaling=1.0 and no dynamic "
                    "scaling (bf16 needs none)")
            rewrite_program(program, apply_tuning_overrides(inner._amp_lists),
                            inner._dest_dtype)
            inner = inner._optimizer
        program._pipeline = build_pipeline_plan(
            program, loss, cuts, inner, self._num_microbatches,
            startup_program, devices=self._place_list,
            schedule=self._schedule)
        return [], []


def _swap_guard(swap_in, swap_out, need_restore):
    @contextlib.contextmanager
    def guard():
        swap_in()
        try:
            yield
        finally:
            if need_restore:
                swap_out()
    return guard()


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging (optimizer.py:942). Build it after
    the training optimizer's minimize(): it appends one increment of its
    update counter and one `model_average_accum` op per parameter to the
    main program. `with model_average.apply(exe, scope=scope):` swaps the
    parameters in `scope` for their window averages, sum / cnt computed on
    the device (a parameter whose count is 0 keeps its value), and restores
    them on exit (or call restore())."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._params = list(default_main_program().all_parameters())
        self.helper = LayerHelper(self.__class__.__name__)
        block = default_main_program().global_block
        total = self.helper.create_or_get_global_variable(
            unique_name.generate("ma_total_updates"), [1], "float32",
            initializer=Constant(0.0))
        block.append_op("increment", {"X": [total.name]},
                        {"Out": [total.name]}, {"step": 1.0})
        for p in self._params:
            s = self._add_accumulator("ma_sum", p, dtype=p.dtype)
            c = self._add_accumulator("ma_cnt", p, shape=[1])
            block.append_op(
                "model_average_accum",
                inputs={"Param": [p.name], "Sum": [s.name], "Cnt": [c.name],
                        "TotalUpdates": [total.name]},
                outputs={"SumOut": [s.name], "CntOut": [c.name]},
                attrs={"max_average_window": float(max_average_window),
                       "min_average_window": float(min_average_window),
                       "average_window_rate": float(average_window_rate)})
        self._backup: dict = {}
        self._scope = None

    def _average_in(self):
        for p in self._params:
            s = self._scope.find_var(self._accumulators["ma_sum"][p.name].name)
            c = self._scope.find_var(self._accumulators["ma_cnt"][p.name].name)
            cur = self._scope.find_var(p.name)
            self._backup[p.name] = cur
            self._scope.set_var(p.name, torch.where(c > 0, s / c, cur)
                                .to(cur.dtype))

    def apply(self, executor=None, need_restore=True, *, scope):
        self._scope = scope
        return _swap_guard(self._average_in, self.restore, need_restore)

    def restore(self, executor=None):
        for name, val in self._backup.items():
            self._scope.set_var(name, val)
        self._backup = {}


class LookaheadOptimizer:
    """Lookahead (optimizer.py:1017; Zhang et al. 2019): the inner optimizer
    updates the fast weights every step; every k steps the slow weights
    move alpha of the way to them and overwrite them. The slow copies start
    equal to the parameters through `assign` ops in the startup program."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if inner_optimizer is None:
            raise ValueError("inner optimizer cannot be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha should be in [0.0, 1.0]")
        if not (isinstance(k, int) and k > 0):
            raise ValueError("k should be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ops, pgs = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        helper = LayerHelper("lookahead")
        block = default_main_program().global_block
        step = helper.create_or_get_global_variable(
            unique_name.generate("lookahead_step"), [1], "float32",
            initializer=Constant(0.0))
        # one increment, then every parameter's sync reads the same tick
        block.append_op("increment", {"X": [step.name]},
                        {"Out": [step.name]}, {"step": 1.0})
        for p, g in pgs:
            if g is None:
                continue
            slow = helper.create_or_get_global_variable(
                unique_name.generate(p.name + "_slow"), list(p.shape),
                p.dtype, initializer=None)
            default_startup_program().global_block.append_op(
                "assign", {"X": [p.name]}, {"Out": [slow.name]}, {})
            block.append_op(
                "lookahead",
                inputs={"Param": [p.name], "SlowParam": [slow.name],
                        "Step": [step.name]},
                outputs={"ParamOut": [p.name], "SlowOut": [slow.name]},
                attrs={"alpha": self.alpha, "k": float(self.k)})
        return ops, pgs


class ExponentialMovingAverage:
    """EMA of the parameters (optimizer.py:1062). `update()` appends a step
    counter's increment and shadow = decay shadow + (1 - decay) param, as
    scale and sum ops, to the main program; `apply(exe, scope=scope)` is a
    context manager that swaps the bias-corrected shadows, shadow / (1 -
    decay^max(step, 1)) computed on the device, into the parameters of
    `scope` and restores them on exit (or call restore())."""

    def __init__(self, decay=0.999, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._shadows: dict[str, Variable] = {}
        self._step_var: Variable | None = None
        self._backup: dict = {}
        self._scope = None

    def update(self):
        block = default_main_program().global_block
        helper = LayerHelper(self._name)
        self._step_var = helper.create_or_get_global_variable(
            f"{self._name}.step", [1], "float32", initializer=Constant(0.0))
        block.append_op("increment", inputs={"X": [self._step_var.name]},
                        outputs={"Out": [self._step_var.name]},
                        attrs={"step": 1.0})
        for param in default_main_program().all_parameters():
            shadow = helper.create_or_get_global_variable(
                f"{param.name}.{self._name}", list(param.shape),
                param.dtype.value)
            self._shadows[param.name] = shadow
            tmp = helper.create_variable_for_type_inference(param.dtype)
            block.append_op("scale", inputs={"X": [shadow.name]},
                            outputs={"Out": [tmp.name]},
                            attrs={"scale": self._decay})
            tmp2 = helper.create_variable_for_type_inference(param.dtype)
            block.append_op("scale", inputs={"X": [param.name]},
                            outputs={"Out": [tmp2.name]},
                            attrs={"scale": 1.0 - self._decay})
            block.append_op("sum", inputs={"X": [tmp.name, tmp2.name]},
                            outputs={"Out": [shadow.name]})

    def _shadows_in(self):
        # the correction in float64, rounded to fp32 before it divides, as
        # the JAX package's host arithmetic does
        step = self._scope.find_var(self._step_var.name).reshape(()).double()
        correction = (1.0 - self._decay ** torch.clamp(step, min=1.0)).float()
        for pname, shadow in self._shadows.items():
            s = self._scope.find_var(shadow.name)
            self._backup[pname] = self._scope.find_var(pname)
            self._scope.set_var(pname, (s / correction).to(s.dtype))

    def apply(self, executor=None, need_restore=True, *, scope):
        self._scope = scope
        return _swap_guard(self._shadows_in, self.restore, need_restore)

    def restore(self, executor=None):
        for name, val in self._backup.items():
            self._scope.set_var(name, val)
        self._backup = {}


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
