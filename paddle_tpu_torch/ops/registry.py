"""Operator registry: one torch compute function per op type, with shape
and dtype inference derived from the compute itself, and gradients.

Inference runs the compute on `device="meta"` tensors (no data, no device
work): a -1 batch dim is lowered through a sentinel extent and mapped back,
so programs stay batch-size-polymorphic at build time, as they are in the
JAX package (which runs the same dry-run through `jax.eval_shape`).

Gradients follow the JAX package's registry: every op `foo` has a
`foo_grad`, built by `default_grad_maker` (forward inputs plus one `@GRAD`
input per forward output, one `@GRAD` output per differentiable forward
input) unless the op registers its own maker. Its compute is either
registered by hand (`register_grad_compute`: the kernel-backed ops and the
fc product) or derived: a replay of the forward under `torch.autograd`.
JAX shares a replayed forward with the real one through XLA's CSE; eager
torch cannot, so replay is kept for the cheap ops and the control-flow ops
(whose bodies it replays op by op). A kernel call through ctypes has no
autograd graph: inside a replay, each kernel-backed op (fused_attention,
layer_norm, the cross entropy, the batch norms) runs a
torch.autograd.Function whose backward is its hand backward kernel. The
replay raises when a differentiable input reaches none of the op's
outputs.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.types import DType, is_floating, torch_feed_dtype

# sentinel extent substituted for -1 during meta-tensor inference (the
# JAX package's value, so both packages infer the same shapes)
_DYN = 8191


class ExecContext:
    """Runtime view of one op invocation: resolved input tensors + attrs,
    the device the op runs on, and the run's random generator. Inputs that
    name variables absent from the environment resolve to None (a grad op
    treats a missing output grad as zeros). `stash` is the executor's
    per-run store in which a forward op leaves tensors for its own grad op
    (keyed by an output var's name) that the program gives the grad op no
    slot for; it is None outside an executor run. `program` is the program
    the op belongs to, whose blocks a control-flow op runs (`run_block`);
    None where no block can run (shape inference). `decisions` is the
    prepared program's record of tuner decisions (the executor keeps one a
    program it prepared: {decision key: value}), shared by the program's
    sub-blocks and replays: an op resolves a decision at its first run in
    the program and reads it from there after, and so does its grad op;
    None in shape inference, which consults nothing."""

    def __init__(self, op, env: dict, device: torch.device,
                 generator: torch.Generator | None = None,
                 stash: dict | None = None, program=None,
                 decisions: dict | None = None):
        self.op = op
        self.env = env
        self.device = device
        self.generator = generator
        self.stash = stash
        self.program = program
        self.decisions = decisions

    def run_block(self, block_idx: int, env: dict) -> dict:
        """Run sub-block `block_idx`'s ops against `env` (a child env the
        caller made) and return it: the JAX package's `lowerer`. The block's
        ops share this op's generator and a stash of their own, dropped
        when the block ends; a control-flow op inside nests another run."""
        return run_block(self.program.blocks[block_idx], env, self.device,
                         self.generator, self.decisions)

    @property
    def is_meta(self) -> bool:
        return self.device.type == "meta"

    def draw(self, fn, shape):
        """fn(shape): a tensor of `shape` drawn from the run's generator.
        Where the with_data_parallel rewrite marked the op
        (`Operator.dp_draw` = (its ring, the draw's batch dim);
        parallel/sharding.py), fn draws the global batch's tensor, that dim
        times the ranks, and this rank keeps its rows: every rank draws the
        same numbers (one seed, one run counter), so its rows are the ones a
        one-process run over the global batch draws, and the generator
        advances as it does there. The sequence-parallel rewrite's
        `Operator.sp_draw` = (its ring, the sharded dim, its global extent)
        cuts the rank's rows of that dim the same way, after dp's."""
        marks = [getattr(self.op, m, None) for m in ("dp_draw", "sp_draw")]
        marks = [m for m in marks if m is not None]
        if not marks or self.is_meta:
            return fn(tuple(shape))
        from ..parallel.mesh import ceil_range

        shape, cuts = list(shape), []
        for mark in marks:
            g = (self.env.get("__axis_env__") or {}).get(mark[0])
            if g is None:
                raise RuntimeError(
                    f"{self.op.type}: marked to draw for the global tensor "
                    f"over ring {mark[0]}, which this run binds to no group")
            dim, n = mark[1], shape[mark[1]]
            if len(mark) > 2:
                # the sequence-parallel rewrite's mark: the dim's global
                # extent, split by GSPMD's ceil rule
                shape[dim] = mark[2]
                start = ceil_range(mark[2], g.size, g.index)[0]
            else:
                shape[dim], start = n * g.size, g.index * n
            cuts.append((dim, start, n))
        out = fn(tuple(shape))
        for dim, start, n in cuts:
            out = out.narrow(dim, start, n)
        return out.contiguous()

    def inputs(self, slot: str):
        return [self.env.get(n) for n in self.op.inputs.get(slot, [])]

    def input(self, slot: str, idx: int = 0):
        names = self.op.inputs.get(slot, [])
        if idx >= len(names):
            return None
        return self.env.get(names[idx])

    def has_input(self, slot: str) -> bool:
        names = self.op.inputs.get(slot, [])
        return bool(names) and any(n in self.env for n in names)

    def attr(self, name: str, default=None):
        return self.op.attrs.get(name, default)

    def const(self, name: str, values, dtype=torch.float32) -> torch.Tensor:
        """The list `values` (an attr's table: a schedule's boundaries, a
        sparsity ramp) as a tensor on the op's device, made once per op and
        device and kept on the op. Its copy does not wait on the device
        (non_blocking), so an op that gathers from it stays free of host
        syncs."""
        cache = getattr(self.op, "_consts", None)
        if cache is None:
            cache = self.op._consts = {}
        key = (name, str(self.device))
        if key not in cache:
            cache[key] = torch.tensor(values, dtype=dtype).to(self.device,
                                                              non_blocking=True)
        return cache[key]


class OpDef:
    def __init__(self, compute: Callable[[ExecContext], dict],
                 needs_rng: bool = False, grad_maker: Callable | None = None,
                 no_grad: bool = False, infer: bool = True,
                 host: bool = False):
        self.compute = compute
        self.needs_rng = needs_rng
        self.grad_maker = grad_maker
        self.no_grad = no_grad
        self.infer = infer
        # host=True: an op whose outputs depend on values read back to the
        # host (print, unique, py_func): it syncs by design, and shape
        # inference never runs it (nor its grad op), as in the JAX package
        self.host = host


_REGISTRY: dict[str, OpDef] = {}


def register_op(type: str, *, needs_rng: bool = False, grad=None,
                infer: bool = True, host: bool = False):
    """Decorator: register `compute` for op `type`. grad: None derives the
    grad op's compute by replay; "none" marks the op non-differentiable; a
    callable is the op's grad maker (op, block, no_grad_set) -> [op spec].
    infer=False: shape inference never runs the compute (a control-flow op,
    which reads a condition and runs blocks; its layer declares its
    outputs). host=True: a host op (OpDef.host): never inferred, its
    layer declares its outputs, and its compute may read the device.

    An op that writes state names the state's var as an output too (a
    batch norm's MeanOut, center_loss's CentersOut, spectral_norm's UOut
    and VOut): the executor writes the new value under that name, so each
    run of the program advances the state once."""

    def deco(compute):
        _REGISTRY[type] = OpDef(
            compute, needs_rng=needs_rng,
            grad_maker=grad if callable(grad) else None,
            no_grad=grad == "none", infer=infer, host=host)
        return compute

    return deco


def run_block(block, env: dict, device: torch.device,
              generator: torch.Generator | None = None,
              decisions: dict | None = None) -> dict:
    """Run `block`'s ops in order against `env`, writing each op's outputs
    into it, and return it. An op's failure is raised as an OpError that
    names the op and its creation stack."""
    from ..framework import OpError

    stash: dict = {}
    for op in block.ops:
        opdef = get_op_def(op.type)
        ctx = ExecContext(op, env, device,
                          generator if opdef.needs_rng else None, stash,
                          block.program, decisions)
        try:
            outs = opdef.compute(ctx)
        except Exception as e:  # noqa: BLE001 - re-raised with attribution
            raise OpError(op, e) from e
        for slot, val in outs.items():
            vals = val if isinstance(val, (list, tuple)) else [val]
            for n, t in zip(op.outputs.get(slot, []), vals):
                if n and t is not None:
                    env[n] = t
    return env


def register_grad_compute(fwd_type: str, host: bool = False):
    """Register a hand-written compute for `<fwd_type>_grad` (over replay);
    host=True for the grad of a host op (print_grad)."""

    def deco(compute):
        _REGISTRY[fwd_type + "_grad"] = OpDef(compute, no_grad=True, host=host)
        return compute

    return deco


def get_op_def(type: str) -> OpDef:
    if type in _REGISTRY:
        return _REGISTRY[type]
    if type.endswith("_grad") and type[: -len("_grad")] in _REGISTRY:
        d = OpDef(_make_replay_grad_compute(_REGISTRY[type[: -len("_grad")]]),
                  no_grad=True)
        _REGISTRY[type] = d
        return d
    raise KeyError(f"No op registered with type '{type}' in the torch port")


def has_op(type: str) -> bool:
    try:
        get_op_def(type)
        return True
    except KeyError:
        return False


# ---------------------------------------------------------------------------
# Derived gradient: replay the forward under torch.autograd.
# ---------------------------------------------------------------------------


class _ReplayOp:
    """The forward op as the replay sees it: its inputs renamed to the
    replay's leaf tensors, no outputs. `forward_outputs` names the forward
    op's output vars ({slot: [name]}, from the grad op's `@GRAD` inputs),
    the keys under which a forward that draws random numbers (cudnn_lstm's
    dropout) left them in the run's stash for its replay; only such an op
    (needs_rng) is replayed with the stash."""

    def __init__(self, type, inputs, attrs, forward_outputs=None):
        self.type = type
        self.inputs = inputs
        self.outputs = {}
        self.attrs = attrs
        self.forward_outputs = forward_outputs or {}


def _make_replay_grad_compute(fwd: OpDef):
    def grad_compute(ctx: ExecContext):
        op = ctx.op
        if ctx.is_meta:
            raise RuntimeError("grad ops infer their shapes from the forward vars")
        env, inputs, wanted = {}, {}, []
        for s, names in op.inputs.items():
            if s.endswith("@GRAD"):
                continue
            inputs[s] = []
            out_names = op.outputs.get(s + "@GRAD", [])
            for i, n in enumerate(names):
                t = ctx.env.get(n)
                if t is None:
                    continue
                key = f"__in_{s}_{i}"
                inputs[s].append(key)
                if i < len(out_names) and out_names[i] and t.is_floating_point():
                    t = t.detach().requires_grad_(True)
                    wanted.append((s, i, t))
                env[key] = t
        fwd_outs = {s[:-len("@GRAD")]: [n[:-len("@GRAD")] for n in names]
                    for s, names in op.inputs.items() if s.endswith("@GRAD")}
        if "__axis_env__" in ctx.env:
            # the run's ring -> group binding, for a marked replay's
            # collectives
            env["__axis_env__"] = ctx.env["__axis_env__"]
        replay = _ReplayOp(op.type[:-len("_grad")], inputs, op.attrs,
                           fwd_outs)
        from ..framework import _OP_MARKS

        for mark in _OP_MARKS:
            # a parallel rewrite's mark on the grad op holds for its replay
            if hasattr(op, mark):
                setattr(replay, mark, getattr(op, mark))
        with torch.enable_grad():
            outs = fwd.compute(ExecContext(replay, env,
                                           ctx.device, ctx.generator,
                                           stash=(ctx.stash if fwd.needs_rng
                                                  else None),
                                           program=ctx.program,
                                           decisions=ctx.decisions))
        ys, cots = [], []
        for s in sorted(outs):
            v = outs[s]
            gnames = op.inputs.get(s + "@GRAD", [])
            for j, y in enumerate(v if isinstance(v, (list, tuple)) else [v]):
                if y is None or not y.requires_grad:
                    continue
                g = ctx.env.get(gnames[j]) if j < len(gnames) else None
                ys.append(y)
                cots.append(torch.zeros_like(y) if g is None else g.to(y.dtype))
        grads = (torch.autograd.grad(ys, [t for _, _, t in wanted], cots,
                                     allow_unused=True)
                 if ys and wanted else [None] * len(wanted))
        result: dict[str, list] = {}
        for (s, i, _), g in zip(wanted, grads):
            if g is None:
                raise RuntimeError(
                    f"op '{op.type}': input slot '{s}' reaches no output of "
                    f"the replayed forward '{op.type[:-len('_grad')]}', whose "
                    f"compute has no autograd path (an opaque kernel?); "
                    f"register a grad compute for it instead of replaying")
            slot = s + "@GRAD"
            lst = result.setdefault(slot, [None] * len(op.outputs[slot]))
            lst[i] = g.detach()
        return {s: (v if len(v) != 1 else v[0]) for s, v in result.items()}

    return grad_compute


def under_autograd(*tensors) -> bool:
    """True where an op's compute runs inside a replayed grad: grad mode
    on and an input that asks for a gradient. The executor's own runs never
    are (its tensors ask for none), so a kernel-backed op there keeps its
    registered grad; inside a replay it runs a torch.autograd.Function
    whose backward is its hand backward kernel."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def default_grad_maker(op, block, no_grad_set=frozenset()):
    """The generic `<type>_grad` op spec mirroring the forward slots: forward
    inputs pass through; each forward output slot gets an `@GRAD` input
    slot; each differentiable forward input slot an `@GRAD` output slot."""
    from ..framework import grad_var_name

    inputs = {s: list(ns) for s, ns in op.inputs.items()}
    for s, ns in op.outputs.items():
        inputs[s + "@GRAD"] = [grad_var_name(n) for n in ns]
    outputs = {}
    for s, ns in op.inputs.items():
        gns = []
        for n in ns:
            try:
                v = block.var(n)
                diff = (is_floating(v.dtype) and not v.stop_gradient
                        and n not in no_grad_set)
            except KeyError:
                diff = False
            gns.append(grad_var_name(n) if diff else "")
        if any(gns):
            outputs[s + "@GRAD"] = gns
    if not outputs:
        return []
    return [{"type": op.type + "_grad", "inputs": inputs, "outputs": outputs,
             "attrs": dict(op.attrs)}]


# ---------------------------------------------------------------------------
# Shape/dtype inference on meta tensors.
# ---------------------------------------------------------------------------


def infer_op(op, block) -> None:
    """Set shapes/dtypes of `op`'s outputs, creating missing output vars, by
    running the compute on meta tensors (batch dim -1 -> sentinel -> -1).
    A grad op's outputs take their forward vars' shapes and dtypes."""
    if not has_op(op.type):
        return
    opdef = get_op_def(op.type)
    if opdef.host:
        return
    if op.type.endswith("_grad"):
        _infer_grad_from_forward(op, block)
        return
    if not opdef.infer:
        return
    env = {}
    for names in op.inputs.values():
        for n in names:
            if not n:
                continue
            try:
                v = block.var(n)
            except KeyError:
                continue
            shape = tuple(_DYN if d == -1 else d for d in v.shape)
            # 64-bit vars run as 32-bit (the feed rule), as JAX's inference
            # sees them with x64 off
            env[n] = torch.empty(shape, dtype=torch_feed_dtype(v.dtype),
                                 device="meta")
    ctx = ExecContext(op, env, torch.device("meta"))
    try:
        out = opdef.compute(ctx)
    except Exception as e:  # noqa: BLE001 - recorded, surfaced at run time
        # some ops legitimately cannot dry-run; the executor attaches this
        # record to the op's error if it later fails for real
        op._infer_error = f"{type(e).__name__}: {e}"
        return
    _write_inferred(op, block, out)


def _write_inferred(op, block, out: dict):
    for slot, val in out.items():
        names = op.outputs.get(slot, [])
        vals = val if isinstance(val, (list, tuple)) else [val]
        for n, t in zip(names, vals):
            if not n or t is None:
                continue
            shape = tuple(-1 if d == _DYN else int(d) for d in t.shape)
            dtype = DType.parse(t.dtype)
            try:
                v = block.var(n)
            except KeyError:
                block.create_var(name=n, shape=shape, dtype=dtype)
                continue
            v.shape = shape
            v.dtype = dtype


def _infer_grad_from_forward(op, block) -> None:
    """A grad var has the shape/dtype of its forward var."""
    from ..framework import GRAD_SUFFIX

    for names in op.outputs.values():
        for n in names:
            if not n or not n.endswith(GRAD_SUFFIX):
                continue
            try:
                fv = block.var(n[: -len(GRAD_SUFFIX)])
            except KeyError:
                continue
            if n in block.vars:
                block.vars[n].shape = fv.shape
                block.vars[n].dtype = fv.dtype
            else:
                block.create_var(name=n, shape=fv.shape, dtype=fv.dtype)
