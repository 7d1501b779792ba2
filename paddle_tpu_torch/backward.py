"""Autodiff by program transformation: `append_backward` and `gradients`.

The port's copy of the JAX package's backward.py: walk the forward ops in
reverse, emit one grad op per forward op through its grad maker, sum a
gradient that several consumers produce (`@RENAME@` temporaries and a `sum`
op), and return (param, grad var) pairs for the optimizer. The same sweep
names every var as the JAX package does, so both build identical training
programs. This file only orchestrates names and topology; the math lives in
the grad computes (ops/registry.py and the ops modules).
"""
from __future__ import annotations

from .core.types import is_floating
from .framework import Program, Variable, grad_var_name
from .ops.registry import default_grad_maker, get_op_def, has_op

__all__ = ["append_backward", "gradients"]


def _find_op_path(block, target_names) -> list[int]:
    """Indices of ops that (transitively) produce any target."""
    needed = {target_names} if isinstance(target_names, str) else set(target_names)
    path = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if any(n in needed for n in op.output_names):
            path.append(i)
            needed.update(n for n in op.input_names if n)
    path.reverse()
    return path


def _no_grad_names(block, no_grad_set) -> set:
    no_grad = set(no_grad_set or ())
    for v in block.vars.values():
        if v.stop_gradient and not v.persistable:
            no_grad.add(v.name)
    return no_grad


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append grad ops for `loss` to its program; return [(param, grad)]."""
    program: Program = loss.block.program
    block = program.global_block
    no_grad = _no_grad_names(block, no_grad_set)
    op_path = _find_op_path(block, loss.name)

    # seed: d loss / d loss = 1
    loss_grad = grad_var_name(loss.name)
    block.create_var(name=loss_grad, shape=loss.shape, dtype=loss.dtype)
    block.append_op("fill_constant", outputs={"Out": [loss_grad]},
                    attrs={"shape": list(loss.shape), "value": 1.0,
                           "dtype": loss.dtype.value})

    available = _backward_sweep(block, op_path, {loss_grad}, no_grad)

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters()
                  if getattr(p, "trainable", True)]
    return [(p, block.var(grad_var_name(p.name))) for p in params
            if grad_var_name(p.name) in available]


def _backward_sweep(block, op_path, seed_grads: set, no_grad: set) -> set:
    """Reverse sweep over `op_path` emitting grad ops; returns every grad var
    name made available. `seed_grads` are pre-seeded cotangent var names."""
    available = set(seed_grads)
    pending_sum: dict[str, list[str]] = {}  # fwd grad var -> partial names

    for op in reversed([block.ops[i] for i in op_path]):
        if not any(grad_var_name(n) in available for n in op.output_names):
            continue                            # no grad flows into this op
        opdef = get_op_def(op.type) if has_op(op.type) else None
        if opdef is None or opdef.no_grad:
            # a forward-only op ON the gradient path would silently freeze
            # every parameter upstream of it; pure sources are harmless
            if _has_differentiable_inputs(op, block, no_grad):
                raise RuntimeError(
                    f"op '{op.type}' lies on the gradient path but has no "
                    f"gradient; parameters upstream of it would silently "
                    f"stop training. Mark its inputs stop_gradient=True if "
                    f"this is intended.")
            continue
        maker = opdef.grad_maker or default_grad_maker
        for spec in maker(op, block, frozenset(no_grad)):
            # a grad var already produced by another consumer (or twice in
            # this spec) is emitted into a temp and summed into the original
            outputs, renames, local_seen = {}, [], set()
            for slot, names in spec["outputs"].items():
                new_names = []
                for n in names:
                    if n and (n in available or n in local_seen):
                        tmp = n + "@RENAME@" + str(len(pending_sum.get(n, [])))
                        pending_sum.setdefault(n, [n]).append(tmp)
                        renames.append((n, tmp))
                        new_names.append(tmp)
                    else:
                        if n:
                            local_seen.add(n)
                        new_names.append(n)
                outputs[slot] = new_names
            block.append_op(spec["type"], spec["inputs"], outputs,
                            spec.get("attrs", {}))
            available.update(n for names in outputs.values() for n in names if n)
            for orig, _ in renames:
                parts = pending_sum[orig]
                if len(parts) >= 2:
                    block.append_op("sum", inputs={"X": list(parts)},
                                    outputs={"Out": [orig]})
                    pending_sum[orig] = [orig]
    return available


def _has_differentiable_inputs(op, block, no_grad: set) -> bool:
    for n in op.input_names:
        if not n or n in no_grad:
            continue
        try:
            v = block.var(n)
        except KeyError:
            continue
        if is_floating(v.dtype) and not v.stop_gradient:
            return True
    return False


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of `targets` w.r.t. `inputs`: a var per input (None where no
    gradient reaches it). A missing target gradient seeds with ones."""
    tgts = list(targets) if isinstance(targets, (list, tuple)) else [targets]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    tgs = (list(target_gradients) if isinstance(target_gradients, (list, tuple))
           else [target_gradients] * len(tgts))
    if len(tgs) != len(tgts):
        raise ValueError(f"target_gradients has {len(tgs)} entries for "
                         f"{len(tgts)} targets")
    block = tgts[0].block.program.global_block
    # asking for d(target)/d(input) makes the input differentiable, data
    # vars included; restored after the sweep
    saved = [(v, v.stop_gradient) for v in ins]
    for v in ins:
        v.stop_gradient = False
    try:
        no_grad = _no_grad_names(block, no_grad_set)
        op_path = _find_op_path(block, {t.name for t in tgts})
        seeds = set()
        for t, tg in zip(tgts, tgs):
            g = grad_var_name(t.name)
            block.create_var(name=g, shape=t.shape, dtype=t.dtype)
            if tg is None:
                block.append_op("fill_any_like", inputs={"X": [t.name]},
                                outputs={"Out": [g]}, attrs={"value": 1.0})
            else:
                if len(tg.shape) != len(t.shape) or any(
                        td not in (-1, gd) and gd != -1
                        for td, gd in zip(t.shape, tg.shape)):
                    raise ValueError(
                        f"target_gradient for '{t.name}' has shape "
                        f"{tuple(tg.shape)}, expected {tuple(t.shape)}")
                block.append_op("assign", {"X": [tg.name]}, {"Out": [g]}, {})
            seeds.add(g)
        available = _backward_sweep(block, op_path, seeds, no_grad)
    finally:
        for v, sg in saved:
            v.stop_gradient = sg
    return [block.var(grad_var_name(v.name))
            if grad_var_name(v.name) in available
            and block.has_var(grad_var_name(v.name)) else None for v in ins]
