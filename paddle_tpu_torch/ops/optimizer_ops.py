"""Optimizer update ops (the JAX package's optimizer_ops.py), and the AMP
ops that check and unscale the gradients and keep the loss scale.

The JAX ops mark the outputs that alias their inputs (`stateful_outputs=`,
ParamOut is Param) so that XLA donates those buffers. Here nothing more is
needed: the executor writes every output to the env entry of its var's
name, and back to the scope for persistable vars, so a later op of the
same run reads the new value and the run leaves the updated state in the
scope. The dense ops compute in fp32 and write the parameter back in its
own dtype; moments stay fp32. None reads a value back to the host: the
schedule's learning rate, the beta powers and the step counters stay
device tensors, and every data-dependent choice is a `torch.where`.
sgd and adam also take a SelectedRows (sparse) gradient; every other
update op raises NotImplementedError on one."""
from __future__ import annotations

import torch

from ..core.selected_rows import is_selected_rows
from .registry import ExecContext, register_op


@register_op("adam", grad="none")
def adam(ctx: ExecContext):
    """Adam in the JAX package's form (optimizer_ops.py:84-105): the bias
    corrections fold into the step size, lr_t = lr sqrt(1 - b2^t) /
    (1 - b1^t), and epsilon is added to sqrt(v) outside them — not
    torch.optim.Adam's placement. Moments are fp32.

    With a SelectedRows grad the update is lazy whatever `lazy_mode` says,
    as in the JAX op: the rows merge by sum into a [V, W] gradient and a
    touched mask over the table (`index_add_` / `index_fill_`, no host
    sync), and only touched rows' moments and parameters move; untouched
    rows come out bit for bit as they went in. The beta powers advance
    every step."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p_in, b2p_in = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1p, b2p = b1p_in.reshape(()), b2p_in.reshape(())
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = ctx.input("LearningRate").reshape(()) * torch.sqrt(1 - b2p) / (1 - b1p)
    if is_selected_rows(g):
        rows = g.rows.long()
        merged = torch.zeros((p.shape[0],) + tuple(g.values.shape[1:]),
                             dtype=torch.float32, device=p.device)
        merged.index_add_(0, rows, g.values.float())
        touched = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
        touched.index_fill_(0, rows, True)
        tmask = touched.reshape((-1,) + (1,) * (p.dim() - 1))
        m1n = torch.where(tmask, b1 * m1 + (1 - b1) * merged, m1)
        m2n = torch.where(tmask, b2 * m2 + (1 - b2) * torch.square(merged), m2)
        pf = p.float()
        p_new = torch.where(tmask, pf - lr * (m1n / (torch.sqrt(m2n) + eps)),
                            pf)
    else:
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


def _reject_sparse(ctx: ExecContext):
    """The op's Grad, which must be dense: only sgd and adam take a
    SelectedRows (the JAX package's `_reject_sparse`, optimizer_ops.py:25,
    which its momentum calls; here every other update op does)."""
    g = ctx.input("Grad")
    if is_selected_rows(g):
        raise NotImplementedError(
            f"op '{ctx.op.type}' does not support SelectedRows (sparse) "
            f"gradients; use SGD for is_sparse embeddings, or "
            f"is_sparse=False (a dense index_add_)")
    return g


@register_op("sgd", grad="none")
def sgd(ctx: ExecContext):
    """Dense p - lr g (the JAX package's optimizer_ops.py:36), or with a
    SelectedRows grad the row update: p.index_add(rows, -lr values) on a
    copy, duplicates adding up and untouched rows keeping their bits."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = ctx.input("LearningRate").reshape(())
    if is_selected_rows(g):
        return {"ParamOut": p.index_add(0, g.rows.long(),
                                        -(lr * g.values).to(p.dtype))}
    return {"ParamOut": p - (lr * g).to(p.dtype)}


@register_op("momentum", grad="none")
def momentum(ctx: ExecContext):
    """v' = mu v + g; p' = p - lr v', or with use_nesterov
    p' = p - (g + mu v') lr (the JAX package's optimizer_ops.py:55)."""
    p, g, v = ctx.input("Param"), _reject_sparse(ctx), ctx.input("Velocity")
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
    (optimizer_ops.py:293). Under tensor parallelism (`Operator.tp_found`)
    the flag is taken over every rank's shards."""
    xs = ctx.inputs("X")
    inv = 1.0 / ctx.input("Scale").reshape(())
    found = torch.zeros((), dtype=torch.bool, device=inv.device)
    for x in xs:
        found = found | ~torch.isfinite(x).all()
    ring = getattr(ctx.op, "tp_found", None)
    if ring is not None:
        # some X are this rank's shards (the tensor-parallel rewrite's
        # mark): the flag is OR-reduced over the tp ranks before it zeroes
        # anything, so every rank skips the step any shard poisoned
        from .collective_ops import AXIS_ENV_KEY, _all_reduce

        g = (ctx.env.get(AXIS_ENV_KEY) or {}).get(ring)
        if g is None:
            raise RuntimeError(f"check_finite_and_unscale: marked to reduce "
                               f"its flag over ring {ring}, which this run "
                               f"binds to no group")
        found = _all_reduce(g, found.to(torch.float32).reshape(1), "max",
                            "tp found inf").reshape(()) > 0
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


def _lr(ctx: ExecContext):
    return ctx.input("LearningRate").reshape(())


@register_op("adamax", grad="none")
def adamax(ctx: ExecContext):
    """Adam with the infinity norm (optimizer_ops.py:115). Beta1Pow is not
    an output: the optimizer scales it by beta1 in a separate op after the
    update ops."""
    p, g = ctx.input("Param"), _reject_sparse(ctx).float()
    m, inf = ctx.input("Moment"), ctx.input("InfNorm")
    b1p = ctx.input("Beta1Pow").reshape(())
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    p_new = p.float() - (_lr(ctx) / (1 - b1p)) * (m_new / (inf_new + eps))
    return {"ParamOut": p_new.to(p.dtype), "MomentOut": m_new,
            "InfNormOut": inf_new}


@register_op("adagrad", grad="none")
def adagrad(ctx: ExecContext):
    """m' = m + g^2; p' = p - lr g / (sqrt(m') + eps) (optimizer_ops.py:134)."""
    p, g = ctx.input("Param"), _reject_sparse(ctx).float()
    m_new = ctx.input("Moment") + torch.square(g)
    p_new = p.float() - _lr(ctx) * g / (torch.sqrt(m_new)
                                        + ctx.attr("epsilon", 1e-6))
    return {"ParamOut": p_new.to(p.dtype), "MomentOut": m_new}


@register_op("decayed_adagrad", grad="none")
def decayed_adagrad(ctx: ExecContext):
    """Adagrad with a decaying moment, m' = decay m + (1 - decay) g^2
    (optimizer_ops.py:145)."""
    p, g = ctx.input("Param"), _reject_sparse(ctx).float()
    decay = ctx.attr("decay", 0.95)
    m_new = decay * ctx.input("Moment") + (1 - decay) * torch.square(g)
    p_new = p.float() - _lr(ctx) * g / (torch.sqrt(m_new)
                                        + ctx.attr("epsilon", 1e-6))
    return {"ParamOut": p_new.to(p.dtype), "MomentOut": m_new}


@register_op("adadelta", grad="none")
def adadelta(ctx: ExecContext):
    """Adadelta (optimizer_ops.py:157): no learning rate enters the step."""
    p, g = ctx.input("Param"), _reject_sparse(ctx).float()
    ag, au = ctx.input("AvgSquaredGrad"), ctx.input("AvgSquaredUpdate")
    rho, eps = ctx.attr("rho", 0.95), ctx.attr("epsilon", 1e-6)
    ag_new = rho * ag + (1 - rho) * torch.square(g)
    update = -torch.sqrt((au + eps) / (ag_new + eps)) * g
    au_new = rho * au + (1 - rho) * torch.square(update)
    return {"ParamOut": (p.float() + update).to(p.dtype),
            "AvgSquaredGradOut": ag_new, "AvgSquaredUpdateOut": au_new}


@register_op("rmsprop", grad="none")
def rmsprop(ctx: ExecContext):
    """RMSProp with momentum, optionally centered (optimizer_ops.py:177);
    when not centered MeanGrad passes through to MeanGradOut unchanged."""
    p, g = ctx.input("Param"), _reject_sparse(ctx).float()
    rho, eps = ctx.attr("decay", 0.95), ctx.attr("epsilon", 1e-6)
    ms_new = rho * ctx.input("MeanSquare") + (1 - rho) * torch.square(g)
    if ctx.attr("centered", False):
        mg_new = rho * ctx.input("MeanGrad") + (1 - rho) * g
        denom = ms_new - torch.square(mg_new) + eps
    else:
        mg_new = ctx.input("MeanGrad")
        denom = ms_new + eps
    mom_new = (ctx.attr("momentum", 0.0) * ctx.input("Moment")
               + _lr(ctx) * g / torch.sqrt(denom))
    out = {"ParamOut": (p.float() - mom_new).to(p.dtype),
           "MomentOut": mom_new, "MeanSquareOut": ms_new}
    if mg_new is not None:
        out["MeanGradOut"] = mg_new
    return out


@register_op("ftrl", grad="none")
def ftrl(ctx: ExecContext):
    """FTRL-proximal (optimizer_ops.py:208), with the JAX op's square-root
    branch for lr_power = -0.5. It divides by the learning rate: a
    schedule at 0 gives inf here as in the JAX op."""
    p_in = ctx.input("Param")
    p, g = p_in.float(), _reject_sparse(ctx).float()
    sq, lin = ctx.input("SquaredAccumulator"), ctx.input("LinearAccumulator")
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    lr = _lr(ctx)
    new_sq = sq + torch.square(g)
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
        denom = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    new_lin = lin + g - sigma * p
    pre_shrink = (l1 * torch.sign(new_lin) - new_lin) / denom
    p_new = torch.where(torch.abs(new_lin) > l1, pre_shrink,
                        torch.zeros_like(p))
    return {"ParamOut": p_new.to(p_in.dtype), "SquaredAccumOut": new_sq,
            "LinearAccumOut": new_lin}


def _whole_norms(ctx: ExecContext, *ts):
    """The L2 norms of `ts` over the whole parameter. Where the
    tensor-parallel rewrite marked the op (`Operator.tp_norms`: the
    parameter is this rank's shard) the squared sums are summed over the
    tp ranks before the root, in one collective."""
    sq = torch.stack([torch.sum(torch.square(t)) for t in ts])
    ring = getattr(ctx.op, "tp_norms", None)
    if ring is not None:
        from .collective_ops import AXIS_ENV_KEY, _all_reduce

        g = (ctx.env.get(AXIS_ENV_KEY) or {}).get(ring)
        if g is None:
            raise RuntimeError(f"{ctx.op.type}: marked to sum its norms over "
                               f"ring {ring}, which this run binds to no "
                               f"group")
        sq = _all_reduce(g, sq, "sum", "tp norms")
    return tuple(torch.sqrt(sq))


@register_op("lamb", grad="none")
def lamb(ctx: ExecContext):
    """LAMB (optimizer_ops.py:237; You et al. 2019): the Adam direction plus
    decoupled weight decay, r = m^ / (sqrt(v^) + eps) + wd p, scaled by the
    trust ratio |p| / |r| (1 where either norm is 0). Under AMP Param is the
    fp32 master, so both norms are fp32 reductions over the whole
    parameter."""
    p_in = ctx.input("Param")
    p, g = p_in.float(), _reject_sparse(ctx).float()
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p_in, b2p_in = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1p, b2p = b1p_in.reshape(()), b2p_in.reshape(())
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps, wd = ctx.attr("epsilon", 1e-6), ctx.attr("weight_decay", 0.01)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    r = (m1n / (1 - b1p)) / (torch.sqrt(m2n / (1 - b2p)) + eps) + wd * p
    p_norm, r_norm = _whole_norms(ctx, p, r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    p_new = p - _lr(ctx) * trust * r
    return {"ParamOut": p_new.to(p_in.dtype), "Moment1Out": m1n,
            "Moment2Out": m2n,
            "Beta1PowOut": (b1p * b1).reshape(b1p_in.shape),
            "Beta2PowOut": (b2p * b2).reshape(b2p_in.shape)}


@register_op("lars_momentum", grad="none")
def lars_momentum(ctx: ExecContext):
    """LARS momentum (optimizer_ops.py:269): a layer-wise learning rate
    lr coeff |p| / (|g| + wd |p| + 1e-9), lr itself where either norm is
    0."""
    p_in = ctx.input("Param")
    p, g = p_in.float(), _reject_sparse(ctx).float()
    mu = ctx.attr("mu")
    coeff = ctx.attr("lars_coeff", 0.001)
    wd = ctx.attr("lars_weight_decay", 0.0005)
    lr = _lr(ctx)
    p_norm, g_norm = _whole_norms(ctx, p, g)
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm + 1e-9),
                           lr)
    v_new = mu * ctx.input("Velocity") + local_lr * (g + wd * p)
    return {"ParamOut": (p - v_new).to(p_in.dtype), "VelocityOut": v_new}


def _quantile(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """jnp.quantile(a, q) of a 1-D a (method "linear") with q a device
    scalar: sorted, then the two order statistics around q (n - 1)
    gathered by device indices and interpolated, so neither q nor the
    index reaches the host (torch.quantile checks q on the host and
    refuses more than 2^24 elements). The position and the interpolation
    run in float64, numpy's precision: the JAX op's float32 position
    rounds once n - 1 is past 2^24, and agrees with this one below. NaN
    if a holds a NaN (sort puts it last), as jnp.quantile."""
    n = a.numel()
    s = torch.sort(a).values
    pos = q.double() * (n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w = pos - lo

    def at(i):
        return s.index_select(0, i.clamp(0, n - 1).long().reshape(1)).double()

    out = (at(lo) * (1 - w) + at(hi) * w).reshape(())
    return torch.where(torch.isnan(s[-1]), s[-1].double(), out)


@register_op("dgc", grad="none")
def dgc(ctx: ExecContext):
    """Deep gradient compression (optimizer_ops.py:406; Lin et al. 2017):
    momentum correction u = m u + g, local accumulation v = v + u (v + g +
    m u with Nesterov), the threshold at the sparsity quantile of |v|; the
    entries at or past it leave as GradOut and are cleared from u and v
    (error feedback). With CurrentStep the sparsity follows the ramp on the
    device: 0 before rampup_begin_step, then the sparsity_ramp list across
    rampup_step steps, holding its last value."""
    g, u, v = _reject_sparse(ctx), ctx.input("U"), ctx.input("V")
    m = float(ctx.attr("momentum", 0.9))
    step = ctx.input("CurrentStep")
    if step is not None:
        ramp = [float(x) for x in (ctx.attr("sparsity_ramp", None)
                                   or [ctx.attr("sparsity", 0.999)])]
        begin = float(ctx.attr("rampup_begin_step", 0))
        width = float(max(1, ctx.attr("rampup_step", 1)))
        rel = step.reshape(()).float() - begin
        idx = torch.clamp(torch.floor(rel * len(ramp) / width), 0,
                          len(ramp) - 1).long().reshape(1)
        sparsity = torch.where(rel < 0, 0.0, ctx.const(
            "sparsity_ramp", ramp).index_select(0, idx).reshape(()))
    else:
        sparsity = torch.full((), float(ctx.attr("sparsity", 0.999)),
                              device=g.device)
    u = m * u + g
    if ctx.attr("use_nesterov", False):
        v = v + (g + m * u)
    else:
        v = v + u
    thr = _quantile(torch.abs(v).reshape(-1).float(), sparsity).to(v.dtype)
    mask = torch.abs(v) >= thr
    return {"GradOut": torch.where(mask, v, 0),
            "UOut": torch.where(mask, 0, u), "VOut": torch.where(mask, 0, v),
            "Sparsity": sparsity.reshape(1)}


@register_op("model_average_accum", grad="none")
def model_average_accum(ctx: ExecContext):
    """ModelAverage's window (optimizer_ops.py:463): Sum += Param and Cnt
    += 1, restarted from Param when Cnt passes clip(TotalUpdates rate,
    min_average_window, max_average_window)."""
    p, s, cnt = ctx.input("Param"), ctx.input("Sum"), ctx.input("Cnt")
    total = ctx.input("TotalUpdates")
    max_w = float(ctx.attr("max_average_window", 10000))
    min_w = float(ctx.attr("min_average_window", 10000))
    rate = float(ctx.attr("average_window_rate", 0.15))
    limit = (max_w if total is None
             else torch.clamp(total.reshape(()) * rate, min_w, max_w))
    cnt2 = cnt + 1.0
    reset = cnt2 > limit
    return {"SumOut": torch.where(reset, p, s + p),
            "CntOut": torch.where(reset, 1.0, cnt2)}


@register_op("lookahead", grad="none")
def lookahead(ctx: ExecContext):
    """Lookahead's sync (optimizer_ops.py:491; Zhang et al. 2019): every k
    steps slow += alpha (fast - slow) and fast = slow. Step is advanced
    once a run by its own increment op."""
    fast, slow = ctx.input("Param"), ctx.input("SlowParam")
    step = ctx.input("Step").reshape(())
    sync = torch.remainder(step, float(ctx.attr("k", 5))) == 0.0
    new_slow = torch.where(sync, slow + float(ctx.attr("alpha", 0.5))
                           * (fast - slow), slow)
    return {"ParamOut": torch.where(sync, new_slow.to(fast.dtype), fast),
            "SlowOut": new_slow}


@register_op("health_sentinel", grad="none")
def health_sentinel(ctx: ExecContext):
    """The numeric guard's in-graph health vector and branchless bad-step
    skip (the JAX op, optimizer_ops.py:339; resilience/guardrails.py).
    Inputs are the post-clip gradients X, the Loss, State = [ema, seen]
    and, under AMP with dynamic loss scaling, its FoundInfinite. A step
    whose loss or gradients are non-finite, or whose finite loss exceeds
    spike_factor times the loss EMA, has every gradient zeroed (SGD then
    leaves the parameters bit for bit, the moment optimizers only decay
    their moments), and the verdict is the device vector

        Health = [loss, global_grad_norm, nonfinite, bad]   (fp32 [4])

    The EMA advances on good steps only. SelectedRows gate their values.

    The JAX op tests every element with isfinite; here one
    `torch._foreach_norm` pass gives each gradient's norm (a multi-tensor
    launch on the card), and a non-finite element makes its norm, so the
    global norm, non-finite: `~isfinite(gnorm)`, which the JAX op ORs in
    too, is the same verdict. Each gradient then costs one `torch.where`
    (never `0 * g`, which keeps a NaN). Nothing is read to the host: the
    executor reads Health after the step's completion token."""
    from ..core.selected_rows import SelectedRows

    xs = ctx.inputs("X")
    loss = ctx.input("Loss")
    state = ctx.input("State").reshape(-1).float()
    spike_factor = float(ctx.attr("spike_factor", 0.0))
    ema_decay = float(ctx.attr("ema_decay", 0.9))

    loss32 = loss.float().mean()         # a scalar whatever the loss's rank
    vals = [x.values if is_selected_rows(x) else x for x in xs]
    if vals:
        norms = torch._foreach_norm(vals, 2, dtype=torch.float32)
        gnorm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        gnorm = torch.zeros((), device=loss32.device)
    nonfinite = ~torch.isfinite(loss32) | ~torch.isfinite(gnorm)
    found = ctx.input("FoundInfinite")
    if found is not None:
        nonfinite = nonfinite | (found.reshape(()) != 0)

    ema, seen = state[0], state[1]
    bad = nonfinite
    if spike_factor > 0.0:
        bad = bad | ((seen > 0) & torch.isfinite(loss32)
                     & (loss32 > spike_factor * ema))

    # a zero tensor on the device: a Python 0.0 in torch.where costs a
    # fill launch a gradient on the card
    zeros = {}

    def gated(v):
        if v.dtype not in zeros:
            zeros[v.dtype] = torch.zeros((), dtype=v.dtype, device=v.device)
        return torch.where(bad, zeros[v.dtype], v)

    def gate(x):
        if is_selected_rows(x):
            return SelectedRows(x.rows, gated(x.values), x.height)
        return gated(x)

    ema_next = torch.where(bad, ema, torch.where(
        seen > 0, ema_decay * ema + (1.0 - ema_decay) * loss32, loss32))
    seen_next = torch.where(bad, seen, seen + 1.0)
    health = torch.stack([loss32, gnorm, nonfinite.float(), bad.float()])
    return {"Out": [gate(x) for x in xs], "Health": health,
            "StateOut": torch.stack([ema_next, seen_next])}
