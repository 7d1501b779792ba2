"""The AMP optimizer decorator (the JAX package's
contrib/mixed_precision/decorator.py, whole).

`decorate(optimizer)` returns a wrapper whose minimize() rewrites the
forward program to low precision, scales the loss, unscales and checks the
gradients, and keeps the loss scale by the dynamic state machine when asked
to. The defaults are the JAX package's: bfloat16 with loss scaling off,
since bf16 has float32's exponent range. A step whose gradients hold an
inf or a nan zeroes every gradient (branchless; the moments still decay).

Under FLAGS_guard_numerics the decorator names the unscaled loss and the
found-inf flag to the numeric guard (resilience/guardrails.py): the health
sentinel judges the unscaled loss, and AMP's @FOUND_INF@ ORs into its
verdict, so the two skips share one verdict.
"""
from __future__ import annotations

from ...framework import default_main_program
from ...initializer import Constant
from ...layer_helper import LayerHelper
from ...layers import nn as L
from .fp16_lists import AutoMixedPrecisionLists, apply_tuning_overrides
from .fp16_utils import rewrite_program

__all__ = ["decorate", "OptimizerWithMixedPrecision"]


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio, dest_dtype):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest_dtype = dest_dtype
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        """Rewrite first, then the inner optimizer's backward (which runs
        the minimize-time graph passes and append_backward on the
        rewritten program)."""
        self._amp_lists = apply_tuning_overrides(self._amp_lists)
        rewrite_program(default_main_program(), self._amp_lists,
                        self._dest_dtype)
        helper = LayerHelper("loss_scaling")
        # rank 0, so that elementwise_mul with a scalar loss is rank-legal
        self._loss_scaling = helper.create_or_get_global_variable(
            "@LOSS_SCALING@", [], "float32",
            initializer=Constant(self._init_loss_scaling))
        needs_scaling = self._use_dynamic or self._init_loss_scaling != 1.0
        scaled = (L.elementwise_mul(loss, self._loss_scaling)
                  if needs_scaling else loss)
        params_grads = self._optimizer.backward(
            scaled, startup_program, parameter_list, no_grad_set)
        params_grads = self._unscale_and_check(params_grads, helper,
                                               needs_scaling)
        # the health sentinel must judge the UNSCALED loss (the scaled one
        # moves with the dynamic scale, poisoning its spike EMA); the inner
        # backward recorded the scaled name
        default_main_program()._guard_loss_name = loss.name
        return params_grads

    def _unscale_and_check(self, params_grads, helper, needs_scaling):
        if not self._use_dynamic:
            if needs_scaling:
                inv = 1.0 / self._init_loss_scaling
                params_grads = [(p, L.scale(g, scale=inv))
                                for p, g in params_grads]
            return params_grads
        grads = [g for _, g in params_grads]
        found_inf = helper.create_or_get_global_variable(
            "@FOUND_INF@", [1], "bool", initializer=Constant(0.0))
        unscaled = [helper.create_variable_for_type_inference(g.dtype)
                    for g in grads]
        helper.append_op(
            "check_finite_and_unscale",
            {"X": [g.name for g in grads],
             "Scale": [self._loss_scaling.name]},
            {"Out": [u.name for u in unscaled],
             "FoundInfinite": [found_inf.name]},
            {},
        )
        # AMP's verdict, for the numeric guard's sentinel (see backward)
        default_main_program()._guard_found_inf_name = found_inf.name
        good = helper.create_or_get_global_variable(
            "@GOOD_STEPS@", [1], "int32", initializer=Constant(0.0))
        bad = helper.create_or_get_global_variable(
            "@BAD_STEPS@", [1], "int32", initializer=Constant(0.0))
        helper.append_op(
            "update_loss_scaling",
            {"PrevLossScaling": [self._loss_scaling.name],
             "InGoodSteps": [good.name], "InBadSteps": [bad.name],
             "FoundInfinite": [found_inf.name]},
            {"LossScaling": [self._loss_scaling.name],
             "OutGoodSteps": [good.name], "OutBadSteps": [bad.name]},
            {"incr_every_n_steps": self._incr_every_n_steps,
             "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
             "incr_ratio": self._incr_ratio,
             "decr_ratio": self._decr_ratio},
        )
        return [(p, u) for (p, _), u in zip(params_grads, unscaled)]

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self._optimizer.apply_gradients(params_grads)
        return opt_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5,
             use_dynamic_loss_scaling=False, dest_dtype="bfloat16"):
    """Wrap `optimizer` for mixed-precision training. The defaults are
    bf16 with loss scaling off; pass dest_dtype='float16' and
    use_dynamic_loss_scaling=True for the fp16 regime."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dest_dtype)
