"""Control-flow ops (the JAX package's control_flow_ops.py): while,
conditional_block, static_rnn, switch_case and recompute, each running
sub-blocks of its program through `ExecContext.run_block`.

The JAX package lowers them to XLA's structured control flow
(`lax.while_loop`, `lax.cond`, `lax.scan`); here they are Python loops and
branches over eager ops:

* `while` reads its condition on the host once an iteration, and once to
  leave (`_read_cond`, counted in `while_op.host_syncs`; its iterations in
  `while_op.iterations`): the one host sync it is allowed. It has no
  grad, as in the JAX package.
* `conditional_block` reads its predicate on the host and runs one branch;
  `lax.cond` computes the branch it selects, too.
* `static_rnn` is a time-major loop; its grad is a replay under autograd,
  which recomputes the whole forward (XLA shares it with the forward
  through CSE; eager torch cannot).
* `switch_case` computes every case and merges them with first-true
  priority by `torch.where`, as the JAX op does: no host sync.
* `recompute` runs its segment in a child env, so the segment's interior
  never reaches the executor's env; `recompute_grad` is the derived replay,
  which recomputes the segment under autograd (the RecomputeOptimizer
  contract).

Shape inference never runs them (`infer=False`): their layers declare
their outputs, as the JAX layers do.
"""
from __future__ import annotations

import torch

from .registry import ExecContext, register_op


def _outer_env(ctx: ExecContext) -> dict:
    """The env a body starts from: the enclosing env, with the Deps rebound
    to their real names. A replayed grad hands the op its inputs under
    synthetic names (`__in_Deps_{i}`, registry.py); the body's ops read the
    real names, which travel in the `dep_names` attr."""
    env = dict(ctx.env)
    dep_names = ctx.attr("dep_names", None)
    if dep_names:
        for name, val in zip(dep_names, ctx.inputs("Deps")):
            if val is not None:
                env[name] = val
    return env


def _read_cond(t: torch.Tensor) -> bool:
    """A scalar condition's value on the host: one device sync."""
    return bool(t.reshape(()))


def _carry(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A loop-carried value in its entry dtype and shape (the XLA carry
    contract the JAX op keeps)."""
    return value.to(like.dtype).reshape(like.shape)


@register_op("while", grad="none", needs_rng=True, infer=False)
def while_op(ctx: ExecContext):
    """inputs: X = the carried var names, Condition = [cond var], Deps =
    the body's other outer reads; attrs: sub_block, dep_names; outputs:
    Out = the carried names. Each iteration runs the body on a child env
    and carries X (and the condition) into the next."""
    sub_idx = ctx.attr("sub_block")
    cond_name = ctx.op.inputs["Condition"][0]
    carry_names = list(ctx.op.inputs.get("X", []))
    if cond_name not in carry_names:
        carry_names.append(cond_name)
    env = _outer_env(ctx)
    init = {n: ctx.env[n] for n in carry_names}
    while True:
        while_op.host_syncs += 1
        if not _read_cond(env[cond_name]):
            break
        while_op.iterations += 1
        out = ctx.run_block(sub_idx, dict(env))
        env.update({n: _carry(out[n], init[n]) for n in carry_names})
    return {"Out": [env.get(n) for n in ctx.op.outputs.get("Out", [])]}


while_op.host_syncs = 0
while_op.iterations = 0


@register_op("conditional_block", needs_rng=True, infer=False)
def conditional_block(ctx: ExecContext):
    """inputs: Cond = [pred], Deps; attrs: sub_block (+ sub_block_false),
    dep_names; outputs: Out. The predicate is read on the host and one
    branch runs. With no false block, Out keeps its prior values when the
    predicate is false, so they must have values."""
    out_names = ctx.op.outputs.get("Out", [])
    env = _outer_env(ctx)
    if _read_cond(ctx.input("Cond")):
        idx = ctx.attr("sub_block")
    else:
        idx = ctx.attr("sub_block_false", None)
        if idx is None:
            missing = [n for n in out_names if n not in env]
            if missing:
                raise ValueError(
                    f"conditional_block outputs {missing} have no prior "
                    f"value for the false branch — assign them before the "
                    f"block or provide a false block")
            return {"Out": [env[n] for n in out_names]}
    env = ctx.run_block(idx, env)
    return {"Out": [env[n] for n in out_names]}


@register_op("static_rnn", needs_rng=True, infer=False)
def static_rnn(ctx: ExecContext):
    """inputs: StepInputs (time-major [T, ...]), InitMemories, Deps; attrs:
    sub_block, step_input_names, pre_names / post_names (memory pairs),
    output_names; outputs: Outputs (stacked [T, ...]), FinalMemories. The
    run's generator advances from step to step, so a random op in the body
    draws anew each step (the JAX op splits its key per step)."""
    sub_idx = ctx.attr("sub_block")
    step_in_names = list(ctx.attr("step_input_names", []))
    pre_names = list(ctx.attr("pre_names", []))
    post_names = list(ctx.attr("post_names", []))
    out_names = list(ctx.attr("output_names", []))
    xs = ctx.inputs("StepInputs")
    mems = ctx.inputs("InitMemories")
    base = _outer_env(ctx)
    ys: list[list] = [[] for _ in out_names]
    for t in range(xs[0].shape[0]):
        env = dict(base)
        env.update(zip(pre_names, mems))
        env.update((n, x[t]) for n, x in zip(step_in_names, xs))
        env = ctx.run_block(sub_idx, env)
        mems = [_carry(env[p], m) for p, m in zip(post_names, mems)]
        for y, n in zip(ys, out_names):
            y.append(env[n])
    return {"Outputs": [torch.stack(y) for y in ys],
            "FinalMemories": list(mems)}


@register_op("switch_case", needs_rng=True, infer=False)
def switch_case(ctx: ExecContext):
    """A first-true case ladder. inputs: Conds = [c1..cn], Deps; attrs:
    sub_blocks (one a case, the last the default when has_default),
    dep_names; outputs: Out (the outer vars the cases write). Every case
    runs; the results merge by torch.where from the last case up, so the
    first true case wins, with no host sync."""
    conds = [c.reshape(()).to(torch.bool) for c in ctx.inputs("Conds")]
    out_names = ctx.op.outputs.get("Out", [])
    base = _outer_env(ctx)
    branch_vals = []
    for idx in ctx.attr("sub_blocks"):
        env = ctx.run_block(idx, dict(base))
        branch_vals.append([env[n] for n in out_names])
    if ctx.attr("has_default", False):
        merged, cased = list(branch_vals[-1]), branch_vals[:-1]
    else:
        missing = [n for n in out_names if n not in base]
        if missing:
            raise ValueError(
                f"switch_case outputs {missing} have no prior value and no "
                f"default() case")
        merged, cased = [base[n] for n in out_names], branch_vals
    for cond, vals in reversed(list(zip(conds, cased))):
        merged = [torch.where(cond, v, m) for v, m in zip(vals, merged)]
    return {"Out": merged}


@register_op("recompute", needs_rng=True, infer=False)
def recompute(ctx: ExecContext):
    """An activation-recompute segment (optimizer.py RecomputeOptimizer).
    inputs: Deps = the segment's outer reads; attrs: sub_block, dep_names,
    out_names; outputs: Out = the segment's results read after it. The
    segment runs in a child env that is dropped with its interior; the
    derived `recompute_grad` replays this compute under autograd, one
    segment's activations live at a time."""
    env = ctx.run_block(ctx.attr("sub_block"), _outer_env(ctx))
    return {"Out": [env[n] for n in ctx.attr("out_names")]}
