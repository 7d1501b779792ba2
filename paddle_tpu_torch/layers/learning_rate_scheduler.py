"""Learning-rate schedules as ops in the main program over a step counter
(the JAX package's layers/learning_rate_scheduler.py, whole).

Call one before building the optimizer and pass the returned var as its
`learning_rate`. The schedule is ordinary [1]-sized fp32 ops computed from
the persistable `@LR_DECAY_COUNTER@`, which one increment op advances at
the start of every executor run; the learning rate stays on the device, and
the AMP rewrite leaves the chain in fp32 (it reads no low-precision var).
"""
from __future__ import annotations

import math

from ..framework import Variable, default_main_program
from ..initializer import Constant
from ..layer_helper import LayerHelper
from . import nn as L
from . import tensor as T
from .control_flow import less_than

__all__ = [
    "noam_decay", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "cosine_decay", "linear_lr_warmup",
]

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _unary(op_type, x):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, {"X": [x]}, {"Out": [out]}, {})
    return out


def _decay_step_counter(begin: int = 0):
    """The program's float32 step counter. It starts at begin - 1 and its
    increment precedes every read, so the first run reads `begin`. A
    program has one counter and one increment however many schedules
    compose (linear_lr_warmup(polynomial_decay(...)) must not step twice),
    so schedules with different origins (noam_decay starts at 1, the others
    at 0) cannot share one program."""
    helper = LayerHelper("global_step_counter")
    program = default_main_program()
    existed = _COUNTER_NAME in program.global_block.vars
    if existed:
        prev_begin = getattr(program.global_block.vars[_COUNTER_NAME],
                             "_lr_counter_begin", begin)
        if prev_begin != begin:
            raise ValueError(
                f"schedulers with different step-counter origins (begin="
                f"{prev_begin} vs {begin}) cannot share one program: the "
                f"shared {_COUNTER_NAME} would be off by one for one of them "
                f"(noam_decay starts at 1, other schedules at 0)")
    counter = helper.create_or_get_global_variable(
        _COUNTER_NAME, [1], "float32", initializer=Constant(float(begin) - 1.0))
    counter._lr_counter_begin = begin
    if not existed:
        helper.append_op("increment", {"X": [counter]}, {"Out": [counter]},
                         {"step": 1.0})
    return counter


def noam_decay(d_model, warmup_steps):
    step = _decay_step_counter(1)
    a = L.pow(step, -0.5)
    b = L.scale(step, scale=float(warmup_steps) ** -1.5)
    return L.scale(L.elementwise_min(a, b), scale=float(d_model) ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    ratio = L.scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = _unary("floor", ratio)
    base = T.fill_constant([1], "float32", float(decay_rate))
    return L.scale(L.elementwise_pow(base, ratio), scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    ratio = L.scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = _unary("floor", ratio)
    return L.scale(L.exp(L.scale(ratio, scale=-float(decay_rate))),
                   scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    ratio = L.scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = _unary("floor", ratio)
    denom = L.scale(ratio, scale=float(decay_rate), bias=1.0)
    return L.scale(_unary("reciprocal", denom), scale=float(learning_rate))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    step = _decay_step_counter()
    if cycle:
        div = _unary("ceil", L.scale(step, scale=1.0 / decay_steps))
        # at step 0 ceil(0) = 0: the first cycle's divisor is 1
        div = L.elementwise_max(div, T.fill_constant([1], "float32", 1.0))
        decay_var = L.scale(div, scale=float(decay_steps))
    else:
        decay_var = T.fill_constant([1], "float32", float(decay_steps))
        step = L.elementwise_min(step, decay_var)
    frac = L.elementwise_div(step, decay_var)
    base = L.pow(L.scale(frac, scale=-1.0, bias=1.0), float(power))
    return L.scale(base, scale=float(learning_rate) - float(end_learning_rate),
                   bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = _decay_step_counter()
    helper = LayerHelper("piecewise_decay")
    lr = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "piecewise_decay", {"Step": [step]}, {"Out": [lr]},
        {"boundaries": [float(b) for b in boundaries],
         "values": [float(v) for v in values]})
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _decay_step_counter()
    epoch = _unary("floor", L.scale(step, scale=1.0 / step_each_epoch))
    cosv = _unary("cos", L.scale(epoch, scale=math.pi / epochs))
    return L.scale(cosv, scale=0.5 * float(learning_rate),
                   bias=0.5 * float(learning_rate))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear warmup from start_lr to end_lr over warmup_steps, then the
    wrapped schedule (a float or a var), blended branchlessly by the
    in-warmup flag."""
    step = _decay_step_counter()
    if not isinstance(learning_rate, Variable):
        learning_rate = T.fill_constant([1], "float32", float(learning_rate))
    frac = L.elementwise_min(L.scale(step, scale=1.0 / warmup_steps),
                             T.fill_constant([1], "float32", 1.0))
    warm = L.scale(frac, scale=float(end_lr) - float(start_lr),
                   bias=float(start_lr))
    in_warmup = L.cast(less_than(step, T.fill_constant(
        [1], "float32", float(warmup_steps))), "float32")
    a = L.elementwise_mul(warm, in_warmup)
    b = L.elementwise_mul(learning_rate, L.scale(in_warmup, scale=-1.0,
                                                 bias=1.0))
    return L.elementwise_add(a, b)
