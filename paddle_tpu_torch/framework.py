"""Declarative Program IR: Variable / Operator / Block / Program.

The port's copy of the JAX package's backend-free IR. Programs built here
serialize (`Program.to_dict`) to the same JSON as the JAX package's, so the
two packages can be held op for op against each other, and a program
serialized by one loads in the other (`Program.from_dict`).

`Variable.shape` may use -1 for the leading (batch) dim. Shape inference
runs through the port's op registry on `device="meta"` tensors.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Sequence

import numpy as np

from . import unique_name
from .core.types import DType, VarKind, np_dtype, np_feed_dtype

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "OpError",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "name_scope",
    "grad_var_name",
]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX

_PKG_DIR = __file__.rsplit("/", 1)[0] + "/"


def _capture_callstack():
    """Trimmed user-code creation stack for one Operator (frames inside this
    package are dropped), capped at 8 frames. FLAGS_op_callstack=0 skips."""
    from . import flags

    if not flags.get_flag("op_callstack"):
        return None
    import traceback

    frames = [(f, ln, fn, txt)
              for f, ln, fn, txt in traceback.extract_stack()[:-2]
              if not f.startswith(_PKG_DIR)]
    return frames[-8:]


_name_scope_stack: list[str] = []


class Variable:
    """A named, typed, statically-shaped value in a Block. Pure metadata:
    the runtime tensor lives in a Scope (executor.py) keyed by name."""

    def __init__(
        self,
        block: "Block",
        name: str | None = None,
        shape: Sequence[int] | None = None,
        dtype="float32",
        kind: VarKind = VarKind.DENSE_TENSOR,
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
        sharding: tuple | None = None,
    ):
        self.block = block
        self.name = name if name is not None else unique_name.generate("_generated_var")
        self.shape = tuple(int(s) for s in shape) if shape is not None else ()
        self.dtype = DType.parse(dtype)
        self.kind = kind
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.sharding = sharding  # kept for IR parity; the port never shards
        self.op: "Operator | None" = None  # op that (last) writes this var

    @property
    def np_dtype(self):
        return np_dtype(self.dtype)

    @property
    def np_feed_dtype(self):
        """Dtype FEED arrays cast to (int64/float64 narrow to 32 bits)."""
        return np_feed_dtype(self.dtype)

    def to_dict(self):
        d = {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": self.dtype.value,
            "kind": self.kind.value,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "sharding": list(self.sharding) if self.sharding else None,
            "is_parameter": isinstance(self, Parameter),
        }
        if getattr(self, "is_opt_state", False):
            d["is_opt_state"] = True  # optimizer accumulators, as in JAX's IR
        return d

    def __repr__(self):
        return (f"Var({self.name}: {self.dtype.value}{list(self.shape)}"
                + (", persistable" if self.persistable else "") + ")")

    # operator sugar: appends the elementwise op (or `scale` for a scalar
    # operand) to the current block, as the JAX package's Variable does
    def _binary(self, other, op_type, reverse=False):
        from .layers import nn as _nn

        x, y = (other, self) if reverse else (self, other)
        return _nn._elementwise_binary(op_type, x, y)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __neg__(self):
        from .layers import nn as _nn

        return _nn.scale(self, scale=-1.0)


class Parameter(Variable):
    """A trainable persistable Variable, with the per-parameter training
    attributes the optimizer reads (regularizer, clip, learning-rate
    multiplier in `optimize_attr`)."""

    def __init__(self, block, shape, dtype, trainable=True, regularizer=None,
                 gradient_clip_attr=None, do_model_average=None,
                 optimize_attr=None, **kwargs):
        self.trainable = trainable
        self.regularizer = regularizer
        self.gradient_clip_attr = gradient_clip_attr
        self.do_model_average = do_model_average
        self.optimize_attr = (optimize_attr if optimize_attr is not None
                              else {"learning_rate": 1.0})
        super().__init__(block, shape=shape, dtype=dtype, persistable=True, **kwargs)

    def __repr__(self):
        return f"Param({self.name}: {self.dtype.value}{list(self.shape)})"


# the marks the parallel rewrites leave on their clones' ops, outside the
# attrs (parallel/sharding.py, parallel/tensor_parallel.py): a clone of a
# clone keeps them
_OP_MARKS = ("dp_sync", "dp_draw", "tp_vocab", "tp_found", "tp_norms",
             "sp_halo", "sp_sync", "sp_draw", "global_reduce")


class Operator:
    """One op invocation: type + named input/output slots + attrs. Slots map
    slot name -> list of variable names; attrs are JSON-serializable."""

    def __init__(self, block: "Block", type: str, inputs=None, outputs=None,
                 attrs: dict[str, Any] | None = None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # creation stack + recorded shape-inference failure, attached to
        # later runtime errors (filled by Block.append_op)
        self._callstack: list | None = None
        self._infer_error: str | None = None

    def callstack_str(self) -> str:
        if not self._callstack:
            return "  <op creation stack not captured; FLAGS_op_callstack=0>"
        return "".join(f"  File \"{f}\", line {ln}, in {fn}\n    {txt}\n"
                       for f, ln, fn, txt in self._callstack).rstrip("\n")

    def input(self, slot: str) -> list[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> list[str]:
        return self.outputs.get(slot, [])

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    @property
    def input_names(self) -> list[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_names(self) -> list[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def to_dict(self):
        def _clean(v):
            if isinstance(v, np.integer):
                return int(v)
            if isinstance(v, np.floating):
                return float(v)
            if isinstance(v, (list, tuple)):
                return [_clean(x) for x in v]
            return v

        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs,
                "attrs": {k: _clean(v) for k, v in self.attrs.items()}}

    def __repr__(self):
        return f"Op({self.type}, in={self.inputs}, out={self.outputs})"


class OpError(RuntimeError):
    """An op failed to execute; carries the op's Python creation stack."""

    def __init__(self, op: "Operator", cause: BaseException):
        self.op = op
        self.cause = cause
        scope = op.attrs.get("op_namescope")
        parts = [f"Operator '{op.type}'"
                 + (f" (scope {scope})" if scope else "")
                 + f" failed: {type(cause).__name__}: {cause}",
                 f"  op: {op!r}"]
        if op._infer_error is not None:
            parts.append(f"  note: shape inference had already failed at "
                         f"build time with: {op._infer_error}")
        parts.append("Op creation stack (most recent call last):")
        parts.append(op.callstack_str())
        super().__init__("\n".join(parts))


class Block:
    """Ordered op list + var table."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: dict[str, Variable] = {}
        self.ops: list[Operator] = []

    @property
    def parent_block(self) -> "Block | None":
        return None if self.parent_idx < 0 else self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        return v

    def create_parameter(self, shape, dtype, **kwargs) -> Parameter:
        # parameters always live in the top block
        top = self.program.blocks[0]
        p = Parameter(top, shape, dtype, **kwargs)
        top.vars[p.name] = p
        return p

    def var(self, name: str) -> Variable:
        """Find a var here or in ancestor blocks."""
        b: Block | None = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise KeyError(f"Variable '{name}' not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def all_parameters(self) -> list[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        return self._insert_op(len(self.ops), type, inputs, outputs, attrs)

    def _insert_op(self, index: int, type: str, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        """Insert an op at `index` (the graph passes rewrite in place)."""
        op = Operator(self, type, inputs, outputs, attrs)
        op._callstack = _capture_callstack()
        if _name_scope_stack:
            op.attrs.setdefault("op_namescope", "/".join(_name_scope_stack))
        self.ops.insert(index, op)
        for name in op.output_names:
            if name in self.vars:
                self.vars[name].op = op
        # eager shape/dtype inference so layers can chain immediately
        from .ops.registry import infer_op

        infer_op(op, self)
        return op

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": {n: v.to_dict() for n, v in self.vars.items()},
                "ops": [op.to_dict() for op in self.ops]}


class Program:
    """A whole serializable program: a list of Blocks."""

    def __init__(self):
        self.blocks: list[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self.random_seed = 0

    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def _create_block(self, parent_idx: int | None = None) -> Block:
        """Append a sub-block (a control-flow body) whose parent is the
        current block, or `parent_idx`, and make it current."""
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def _rollback(self):
        """Make the current block's parent current again."""
        self._current_block_idx = self.current_block().parent_idx

    def all_parameters(self) -> list[Parameter]:
        return self.global_block.all_parameters()

    def list_vars(self):
        """Every var of every block, block by block."""
        for blk in self.blocks:
            yield from blk.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """A copy of the program: its blocks, a shallow copy of each var and
        each op with its attrs deep-copied, as the JAX package's clone makes
        it. With for_test=True every op that has an `is_test` attr, and
        every dropout, gets is_test=True. conv2d_bn (built at minimize by
        passes.fuse_conv_bn_stats) has no is_test attr, so a clone taken
        after minimize keeps its training-mode batch norm, as in the JAX
        package: take an inference clone before minimize."""
        p = Program.__new__(Program)
        p.blocks = [Block(p, b.idx, b.parent_idx) for b in self.blocks]
        p._current_block_idx = self._current_block_idx
        p.random_seed = self.random_seed
        for blk, nb in zip(self.blocks, p.blocks):
            for name, v in blk.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in blk.ops:
                nop = Operator(nb, op.type, op.inputs, op.outputs,
                               copy.deepcopy(op.attrs))
                nop._callstack = op._callstack
                nop._infer_error = op._infer_error
                for mark in _OP_MARKS:
                    if hasattr(op, mark):
                        setattr(nop, mark, getattr(op, mark))
                if for_test and ("is_test" in nop.attrs
                                 or nop.type == "dropout"):
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
        return p

    def to_dict(self):
        return {"version": 1, "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks]}

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program.__new__(Program)
        p.blocks = []
        p._current_block_idx = 0
        p.random_seed = d.get("random_seed", 0)
        for bd in d["blocks"]:
            p.blocks.append(Block(p, bd["idx"], bd["parent_idx"]))
        for bd, b in zip(d["blocks"], p.blocks):
            for name, vd in bd["vars"].items():
                common = dict(
                    name=vd["name"], kind=VarKind(vd["kind"]),
                    stop_gradient=vd["stop_gradient"],
                    is_data=vd.get("is_data", False),
                    sharding=tuple(vd["sharding"]) if vd.get("sharding") else None)
                if vd.get("is_parameter"):
                    v = Parameter(b, vd["shape"], vd["dtype"], **common)
                else:
                    v = Variable(b, shape=vd["shape"], dtype=vd["dtype"],
                                 persistable=vd["persistable"], **common)
                if vd.get("is_opt_state"):
                    v.is_opt_state = True
                b.vars[name] = v
            for od in bd["ops"]:
                b.ops.append(Operator(b, od["type"], od["inputs"],
                                      od["outputs"], od["attrs"]))
        return p

    def __repr__(self):
        n_ops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={n_ops})"


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, program
    return old


@contextlib.contextmanager
def name_scope(prefix: str):
    """Ops appended inside carry an `op_namescope` attr ("outer/inner"),
    visible in serialized programs and in OpError messages, as in the JAX
    package (framework.py:560). It does not reset the unique-name
    counters, or re-entering the same scope would collide parameter
    names."""
    _name_scope_stack.append(str(prefix))
    try:
        yield
    finally:
        _name_scope_stack.pop()


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Program | None = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
