"""Optimizer update ops (the JAX package's optimizer_ops.py), and the AMP
ops that check and unscale the gradients and keep the loss scale. The executor
writes each output back to the scope entry of the same name (ParamOut is
Param), so a run leaves the updated state in the scope."""
from __future__ import annotations

import torch

from .registry import ExecContext, register_op


@register_op("adam", grad="none")
def adam(ctx: ExecContext):
    """Dense Adam in the JAX package's form (optimizer_ops.py:84-105): the
    bias corrections fold into the step size, lr_t = lr sqrt(1 - b2^t) /
    (1 - b1^t), and epsilon is added to sqrt(v) outside them — not
    torch.optim.Adam's placement. Moments are fp32."""
    p, g = ctx.input("Param"), _dense_grad(ctx)
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p_in, b2p_in = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1p, b2p = b1p_in.reshape(()), b2p_in.reshape(())
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = ctx.input("LearningRate").reshape(()) * torch.sqrt(1 - b2p) / (1 - b1p)
    gf = g.float()
    m1n = b1 * m1 + (1 - b1) * gf
    m2n = b2 * m2 + (1 - b2) * torch.square(gf)
    p_new = p.float() - lr * (m1n / (torch.sqrt(m2n) + eps))
    return {
        "ParamOut": p_new.to(p.dtype),
        "Moment1Out": m1n,
        "Moment2Out": m2n,
        "Beta1PowOut": (b1p * b1).reshape(b1p_in.shape),
        "Beta2PowOut": (b2p * b2).reshape(b2p_in.shape),
    }


def _dense_grad(ctx: ExecContext):
    """The op's Grad, which must be dense: SelectedRows (sparse row)
    gradients are not ported."""
    g = ctx.input("Grad")
    if g.layout != torch.strided:
        raise NotImplementedError(
            f"{ctx.op.type} with sparse (SelectedRows) gradients is not "
            f"ported yet (ROADMAP Queue 1 item 8, data pipeline and "
            f"embeddings)")
    return g


@register_op("sgd", grad="none")
def sgd(ctx: ExecContext):
    """Dense p - lr g (the JAX package's optimizer_ops.py:36)."""
    p, g = ctx.input("Param"), _dense_grad(ctx)
    lr = ctx.input("LearningRate").reshape(())
    return {"ParamOut": p - (lr * g).to(p.dtype)}


@register_op("momentum", grad="none")
def momentum(ctx: ExecContext):
    """v' = mu v + g; p' = p - lr v', or with use_nesterov
    p' = p - (g + mu v') lr (the JAX package's optimizer_ops.py:55)."""
    p, g, v = ctx.input("Param"), _dense_grad(ctx), ctx.input("Velocity")
    mu = ctx.attr("mu")
    lr = ctx.input("LearningRate").reshape(())
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new.to(p.dtype), "VelocityOut": v_new.to(v.dtype)}


@register_op("check_finite_and_unscale", grad="none")
def check_finite_and_unscale(ctx: ExecContext):
    """The AMP gradient check: every X divided by Scale, and FoundInfinite
    [1] set when any X holds an inf or a nan; then every output is zero, so
    the optimizer's step moves no parameter. Branchless, as the JAX op
    (optimizer_ops.py:293)."""
    xs = ctx.inputs("X")
    inv = 1.0 / ctx.input("Scale").reshape(())
    found = torch.zeros((), dtype=torch.bool, device=inv.device)
    for x in xs:
        found = found | ~torch.isfinite(x).all()
    outs = [torch.where(found, torch.zeros_like(x), x * inv.to(x.dtype))
            for x in xs]
    return {"Out": outs, "FoundInfinite": found.reshape(1)}


@register_op("update_loss_scaling", grad="none")
def update_loss_scaling(ctx: ExecContext):
    """The dynamic loss-scale state machine (the JAX op,
    optimizer_ops.py:309): after incr_every_n_steps finite steps in a row
    the scale is multiplied by incr_ratio; after decr_every_n_nan_or_inf
    steps with an inf by decr_ratio, floored at 1.0. Branchless."""
    scale = ctx.input("PrevLossScaling").reshape(())
    good = ctx.input("InGoodSteps").reshape(()).to(torch.int32)
    bad = ctx.input("InBadSteps").reshape(()).to(torch.int32)
    found = ctx.input("FoundInfinite").reshape(()).to(torch.bool)
    incr_n = ctx.attr("incr_every_n_steps", 1000)
    decr_n = ctx.attr("decr_every_n_nan_or_inf", 2)
    incr_ratio = ctx.attr("incr_ratio", 2.0)
    decr_ratio = ctx.attr("decr_ratio", 0.5)
    zero = torch.zeros_like(good)
    good_next = torch.where(found, zero, good + 1)
    bad_next = torch.where(found, bad + 1, zero)
    do_incr = ~found & (good_next >= incr_n)
    do_decr = found & (bad_next >= decr_n)
    new_scale = torch.where(do_incr, scale * incr_ratio, scale)
    new_scale = torch.where(do_decr, torch.clamp(scale * decr_ratio, min=1.0),
                            new_scale)
    good_next = torch.where(do_incr, zero, good_next)
    bad_next = torch.where(do_decr, zero, bad_next)
    return {"LossScaling": new_scale.reshape(()),
            "OutGoodSteps": good_next.reshape(1),
            "OutBadSteps": bad_next.reshape(1)}
