"""Optimizer update ops (the JAX package's optimizer_ops.py). The executor
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
