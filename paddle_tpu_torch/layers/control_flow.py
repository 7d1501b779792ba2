"""Control-flow layers (the JAX package's layers/control_flow.py): the
comparisons and logical layers, While, cond, Switch, IfElse, StaticRNN and
DynamicRNN. Each builds the same sub-blocks and ops, with the same slots
and attrs, as the JAX layer; the port's ops (ops/control_flow_ops.py) run
them as Python loops and branches. DynamicRNN is the padding-based form of
the LoD walker: the full padded extent through one static_rnn, each row's
state frozen once t >= length."""
from __future__ import annotations

from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper

__all__ = ["While", "cond", "Switch", "IfElse", "StaticRNN", "DynamicRNN",
           "less_than", "less_equal",
           "greater_than", "greater_equal", "equal", "not_equal",
           "logical_and", "logical_or", "logical_not", "logical_xor"]


def _compare(op_type, x, y, cond=None):
    """A comparison into a new bool var, or into `cond` (a While loop
    re-assigns its condition through it)."""
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(op_type, {"X": [x], "Y": [y]}, {"Out": [cond]}, {})
    return cond


def less_than(x, y, cond=None, force_cpu=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def _logical(op_type, x, y, out=None):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    ins = {"X": [x]} if y is None else {"X": [x], "Y": [y]}
    helper.append_op(op_type, ins, {"Out": [out]}, {})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical("logical_and", x, y, out)


def logical_or(x, y, out=None, name=None):
    return _logical("logical_or", x, y, out)


def logical_xor(x, y, out=None, name=None):
    return _logical("logical_xor", x, y, out)


def logical_not(x, out=None, name=None):
    return _logical("logical_not", x, None, out)


class BlockGuard:
    """Enter a fresh sub-block of the main program."""

    def __init__(self, program=None):
        self.program = program or default_main_program()

    def __enter__(self):
        self.block = self.program._create_block()
        return self.block

    def __exit__(self, exc_type, *a):
        self.program._rollback()
        return False


def _block_io(sub_block, parent_block):
    """(reads-from-parent, writes-visible-in-parent) name sets."""
    defined_inside = set()
    reads, writes = [], []
    for op in sub_block.ops:
        for n in op.input_names:
            if n and n not in defined_inside and n not in reads:
                if parent_block.has_var(n) and n not in sub_block.vars:
                    reads.append(n)
        for n in op.output_names:
            if n:
                defined_inside.add(n)
                if (parent_block.has_var(n) and n not in sub_block.vars
                        and n not in writes):
                    writes.append(n)
    return reads, writes


class While:
    """A loop over a sub-block while a bool var holds:

        cond = L.less_than(i, n)
        w = While(cond)
        with w.block():
            ... body ops, must re-assign `cond` ...
    """

    def __init__(self, cond: Variable, is_test=False, name=None):
        if cond.dtype.value != "bool":
            raise TypeError("While condition must be a bool Variable")
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)

    def block(self):
        return _WhileGuard(self)


class _WhileGuard(BlockGuard):
    def __init__(self, while_op: While):
        super().__init__()
        self.while_op = while_op

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return super().__exit__(exc_type, *a)
        sub_block = self.block
        super().__exit__(exc_type, *a)
        parent = default_main_program().current_block()
        reads, writes = _block_io(sub_block, parent)
        cond_name = self.while_op.cond_var.name
        carried = [n for n in writes]
        if cond_name not in carried:
            carried.append(cond_name)
        # Deps: the names the body reads from the outer scope, listed as
        # inputs so a replay and the def-use analysis see them (the body
        # closes over them; they are not loop-carried)
        deps = [n for n in reads if n not in carried]
        parent.append_op(
            "while",
            {"X": carried, "Condition": [cond_name], "Deps": deps},
            {"Out": carried},
            {"sub_block": sub_block.idx, "dep_names": deps},
        )
        return False


def cond(pred: Variable, true_fn, false_fn=None, name=None):
    """Functional conditional: both branches are built into sub-blocks and
    the conditional_block op runs the one the predicate selects. Branch fns
    take no args and return a Variable or tuple of Variables of matching
    shapes/dtypes."""
    if false_fn is None:
        raise ValueError(
            "cond() requires both branches; for the run-only-if-true "
            "pattern use conditional_block with outputs assigned before "
            "the block")
    helper = LayerHelper("cond", name=name)
    program = default_main_program()

    with BlockGuard(program) as tb:
        t_out = true_fn()
        t_outs = list(t_out) if isinstance(t_out, (list, tuple)) else [t_out]
    with BlockGuard(program) as fb:
        f_out = false_fn()
        f_outs = list(f_out) if isinstance(f_out, (list, tuple)) else [f_out]
    if len(f_outs) != len(t_outs):
        raise ValueError("true_fn and false_fn must return the same arity")

    parent = program.current_block()
    # A branch that assigns to an outer-scope var cannot take conditional
    # effect: only declared return values propagate (the JAX op traces both
    # branches functionally). Fail loudly instead of discarding the write.
    # Checked BEFORE the bridge assigns below (which write the op's outputs).
    _, t_writes = _block_io(tb, parent)
    _, f_writes = _block_io(fb, parent)
    outer_writes = sorted(set(t_writes) | set(f_writes))
    if outer_writes:
        raise ValueError(
            f"cond() branch assigns to outer-scope variable(s) {outer_writes}; "
            "such writes are not propagated (both branches are traced "
            "functionally). Return the value from the branch fn instead.")
    outs = [
        parent.create_var(
            name=helper.name + f".out{i}", shape=v.shape, dtype=v.dtype
        )
        for i, v in enumerate(t_outs)
    ]
    # bridge: sub-block results assigned to the op's Out names inside blocks
    for blk, branch_outs in ((tb, t_outs), (fb, f_outs)):
        for o, src in zip(outs, branch_outs):
            blk.append_op("assign", {"X": [src.name]}, {"Out": [o.name]}, {})
    # Deps AFTER the bridge: a branch fn may return an outer-scope var
    # directly (its only read is the bridge assign itself), and it still must
    # reach the sub-block env via Deps/dep_names.
    deps, _ = _block_io(tb, parent)
    f_deps, _ = _block_io(fb, parent)
    deps = deps + [n for n in f_deps if n not in deps]
    parent.append_op(
        "conditional_block",
        {"Cond": [pred.name], "Deps": deps},
        {"Out": [o.name for o in outs]},
        {"sub_block": tb.idx, "sub_block_false": fb.idx, "dep_names": deps},
    )
    return outs[0] if len(outs) == 1 else outs


class Switch:
    """A first-true case ladder, used mainly by LR warmup schedules.

        with Switch() as switch:
            with switch.case(cond1):
                tensor.assign(a, lr)
            with switch.default():
                tensor.assign(b, lr)

    Each case body is built into a sub-block; the switch_case op computes
    every body and merges each written outer var with a nested first-true
    select, the functional form of "execute the first matching case". Case
    bodies must be side-effect-free beyond outer-var writes (true for every
    LR schedule)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._cases = []  # (cond var or None, sub_block)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        self._build()
        return False

    def case(self, condition):
        if self._cases and self._cases[-1][0] is None:
            raise ValueError("Switch: case() after default()")
        return _SwitchCase(self, condition)

    def default(self):
        return _SwitchCase(self, None)

    def _build(self):
        if not self._cases:
            raise ValueError("Switch: no cases")
        parent = default_main_program().current_block()
        conds = [c for c, _ in self._cases if c is not None]
        has_default = self._cases[-1][0] is None
        blocks = [b for _, b in self._cases]
        # union of outer vars written by any case: those are the outputs
        writes: list[str] = []
        deps: list[str] = []
        for _, blk in self._cases:
            r, w = _block_io(blk, parent)
            for n in w:
                if n not in writes:
                    writes.append(n)
            for n in r:
                if n not in deps:
                    deps.append(n)
        if not writes:
            raise ValueError(
                "Switch: no case assigns to an outer-scope variable")
        deps = [n for n in deps if n not in writes]
        parent.append_op(
            "switch_case",
            {"Conds": [c.name for c in conds], "Deps": deps},
            {"Out": writes},
            {"sub_blocks": [b.idx for b in blocks],
             "has_default": has_default,
             "dep_names": deps},
        )


class _SwitchCase:
    def __init__(self, switch, condition):
        self.switch = switch
        self.condition = condition

    def __enter__(self):
        self._guard = BlockGuard()
        self._block = self._guard.__enter__()
        return self

    def __exit__(self, exc_type, *a):
        self._guard.__exit__(exc_type, *a)
        if exc_type is None:
            self.switch._cases.append((self.condition, self._block))
        return False


class IfElse:
    """A per-row conditional. Both blocks compute on the full batch and the
    merge selects per row by the [B, 1] bool condition: the same results as
    splitting the batch whenever the blocks are row-wise (the documented
    contract; a cross-row reduction inside a block would see all rows).

        ie = IfElse(cond)                 # cond: [B, 1] bool
        with ie.true_block():
            ie.output(f(ie.input(x)))
        with ie.false_block():
            ie.output(g(ie.input(x)))
        out = ie()                         # [B, ...] row-merged
    """

    def __init__(self, cond: Variable, name=None):
        self._cond = cond
        self._outs = {True: [], False: []}
        self._in_branch: bool | None = None

    def _branch(self, flag: bool):
        import contextlib

        @contextlib.contextmanager
        def guard():
            self._in_branch = flag
            try:
                yield
            finally:
                self._in_branch = None

        return guard()

    def true_block(self):
        return self._branch(True)

    def false_block(self):
        return self._branch(False)

    def input(self, x: Variable) -> Variable:
        """The full batch flows through; selection happens at the merge."""
        if self._in_branch is None:
            raise RuntimeError("IfElse.input outside a block")
        return x

    def output(self, *outs):
        if self._in_branch is None:
            raise RuntimeError("IfElse.output outside a block")
        self._outs[self._in_branch].extend(outs)

    def __call__(self):
        from . import nn as _nn

        t, f = self._outs[True], self._outs[False]
        if len(t) != len(f):
            raise ValueError(
                f"IfElse: true block produced {len(t)} outputs, false block "
                f"{len(f)} — they must match")
        res = []
        for tv, fv in zip(t, f):
            cond = self._cond
            # align cond rank to the output ([B,1] vs [B,...]); where()
            # selects, so a NaN/inf in the dead branch cannot leak through
            while len(cond.shape) < len(tv.shape):
                cond = _nn.unsqueeze(cond, axes=[-1])
            res.append(_nn.where(cond, tv, fv))
        return res[0] if len(res) == 1 else res


class StaticRNN:
    """A recurrence over the time-major leading axis (the static_rnn op).

        rnn = StaticRNN()
        with rnn.step():
            word = rnn.step_input(x_seq)   # x_seq: time-major [T, B, D]
            prev = rnn.memory(init=h0)
            h = L.fc([word, prev], size=H, act="tanh")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()   # [T, B, H]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._guard = None
        self._step_inputs = []   # (outer var, inner var)
        self._memories = []      # (init var, pre var, post var or None@idx)
        self._outputs = []       # inner per-step vars
        self._built = False
        self._out_vars = None

    def step(self):
        self._guard = BlockGuard()
        return _StaticRNNGuard(self)

    # -- inside-step API ----------------------------------------------------
    def step_input(self, x: Variable) -> Variable:
        blk = default_main_program().current_block()
        inner = blk.create_var(
            name=self.helper.name + f".in{len(self._step_inputs)}",
            shape=x.shape[1:], dtype=x.dtype)
        self._step_inputs.append((x, inner))
        return inner

    def memory(self, init: Variable) -> Variable:
        blk = default_main_program().current_block()
        if init.name in blk.vars:
            raise ValueError(
                f"StaticRNN memory init '{init.name}' was created inside the "
                f"step block; create it before rnn.step() so it has a value "
                f"at loop entry")
        pre = blk.create_var(
            name=self.helper.name + f".mem{len(self._memories)}",
            shape=init.shape, dtype=init.dtype)
        self._memories.append([init, pre, None])
        return pre

    def update_memory(self, mem: Variable, new: Variable):
        for m in self._memories:
            if m[1].name == mem.name:
                m[2] = new
                return
        raise ValueError(f"{mem.name} is not a StaticRNN memory")

    def step_output(self, out: Variable):
        self._outputs.append(out)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    # -- finalize -----------------------------------------------------------
    def _build(self, sub_block):
        parent = default_main_program().current_block()
        for m in self._memories:
            if m[2] is None:
                raise ValueError(
                    f"memory {m[1].name} never update_memory()'d")
        if not self._step_inputs:
            raise ValueError("StaticRNN needs at least one step_input")
        T = self._step_inputs[0][0].shape[0]
        outs = []
        for i, o in enumerate(self._outputs):
            outs.append(parent.create_var(
                name=self.helper.name + f".out{i}",
                shape=(T,) + tuple(o.shape), dtype=o.dtype))
        finals = [
            parent.create_var(name=self.helper.name + f".final{i}",
                              shape=m[0].shape, dtype=m[0].dtype)
            for i, m in enumerate(self._memories)
        ]
        deps, _ = _block_io(sub_block, parent)
        inner = {i.name for _, i in self._step_inputs} | {m[1].name for m in self._memories}
        deps = [n for n in deps if n not in inner]
        parent.append_op(
            "static_rnn",
            {"StepInputs": [x.name for x, _ in self._step_inputs],
             "InitMemories": [m[0].name for m in self._memories],
             "Deps": deps},
            {"Outputs": [o.name for o in outs],
             "FinalMemories": [f.name for f in finals]},
            {"sub_block": sub_block.idx,
             "dep_names": deps,
             "step_input_names": [i.name for _, i in self._step_inputs],
             "pre_names": [m[1].name for m in self._memories],
             "post_names": [m[2].name for m in self._memories],
             "output_names": [o.name for o in self._outputs]},
        )
        self._out_vars = outs
        self._built = True

    def __call__(self):
        if not self._built:
            raise RuntimeError("call after the step() block closes")
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars


class _StaticRNNGuard:
    def __init__(self, rnn: StaticRNN):
        self.rnn = rnn

    def __enter__(self):
        self.block = self.rnn._guard.__enter__()
        return self.rnn

    def __exit__(self, exc_type, *a):
        self.rnn._guard.__exit__(exc_type, *a)
        if exc_type is None:
            self.rnn._build(self.block)
        return False


class DynamicRNN:
    """The padding-based DynamicRNN: the full padded [B, T, ...] extent runs
    through one static_rnn and each row's state freezes once `t >= length`:
      * memories stop updating (update_memory masks with t < length),
      * step outputs beyond a row's length are zeroed.
    Same observable semantics on the valid region, fixed shapes throughout.

        drnn = DynamicRNN()
        with drnn.block():
            w = drnn.step_input(x, length=lens)   # x: [B, T, D] batch-major
            h = drnn.memory(init=h0)
            h2 = L.fc([w, h], size=H, act="tanh")
            drnn.update_memory(h, h2)
            drnn.output(h2)
        out = drnn()   # [B, T, H], padded tail zeroed
    """

    def __init__(self, name=None):
        from . import nn as _nn  # local import; avoids a cycle at module load
        from . import tensor as _tensor

        self._nn = _nn
        self._tensor = _tensor
        self._rnn = StaticRNN(name=name)
        self._length = None
        self._t = None
        self._in_step = False
        self._output_ranks = []

    def block(self):
        return _DynamicRNNGuard(self)

    # -- inside-block API ----------------------------------------------------
    def _parent_block(self):
        prog = default_main_program()
        sub = prog.current_block()
        return prog.blocks[sub.parent_idx]

    def _parent_transpose(self, x: Variable):
        """Append a batch-major -> time-major transpose to the PARENT block
        (step_input is called inside the step sub-block, but the scan's
        sequence operand must exist outside it)."""
        parent = self._parent_block()
        perm = [1, 0] + list(range(2, len(x.shape)))
        shape = tuple(x.shape[i] for i in perm)
        out = parent.create_var(
            name=self._rnn.helper.name + f".tm{len(self._rnn._step_inputs)}",
            shape=shape, dtype=x.dtype)
        parent.append_op("transpose2", {"X": [x.name]}, {"Out": [out.name]},
                         {"axis": perm})
        return out

    def step_input(self, x: Variable, length: Variable | None = None):
        """x: batch-major [B, T, ...]; optional per-row valid length [B]."""
        if not self._in_step:
            raise RuntimeError("step_input must be called inside block()")
        if x.shape[0] is None or x.shape[0] < 0:
            raise ValueError(
                "DynamicRNN.step_input needs a static batch size (got "
                f"shape {x.shape}): set var.shape = (B, T, ...) before the "
                "block — per-step layers infer parameter shapes from it")
        if length is not None:
            if self._length is not None:
                raise ValueError("DynamicRNN already has a length input")
            self._length = length
            # per-step scalar time index, scanned alongside the data
            parent = self._parent_block()
            T = x.shape[1]
            t_seq = parent.create_var(
                name=self._rnn.helper.name + ".tseq", shape=(T,),
                dtype="int64")
            parent.append_op(
                "range", {}, {"Out": [t_seq.name]},
                {"start": 0.0, "end": float(T), "step": 1.0,
                 "dtype": "int64"})
            self._t_inner = self._rnn.step_input(t_seq)   # scalar per step
            self._len_inner = length
        return self._rnn.step_input(self._parent_transpose(x))

    def memory(self, init: Variable):
        return self._rnn.memory(init)

    def update_memory(self, mem: Variable, new: Variable):
        if self._length is not None:
            live = self._nn.cast(
                less_than(self._t_inner, self._len_inner), new.dtype)
            for _ in range(len(mem.shape) - 1):
                live = self._nn.unsqueeze(live, axes=[-1])
            new = self._nn.elementwise_add(
                self._nn.elementwise_mul(new, live),
                self._nn.elementwise_mul(mem, 1.0 - live))
        self._rnn.update_memory(mem, new)

    def output(self, *outs):
        for o in outs:
            rank = len(o.shape)  # recorded pre-mask: the mask ops' build
            # shapes can be unknown inside the sub-block
            if self._length is not None:
                live = self._nn.cast(
                    less_than(self._t_inner, self._len_inner), o.dtype)
                for _ in range(rank - 1):
                    live = self._nn.unsqueeze(live, axes=[-1])
                o = self._nn.elementwise_mul(o, live)
            self._rnn.step_output(o)
            self._output_ranks.append(rank)

    def __call__(self):
        outs = self._rnn()
        outs = outs if isinstance(outs, list) else [outs]
        # back to batch-major [B, T, ...]; rank from the recorded inner
        # step outputs (outer build shapes may be unknown when inference
        # failed inside the sub-block)
        res = []
        for o, inner_rank in zip(outs, self._output_ranks):
            rank = inner_rank + 1
            res.append(self._nn.transpose(
                o, perm=[1, 0] + list(range(2, rank))))
        return res[0] if len(res) == 1 else res


class _DynamicRNNGuard:
    def __init__(self, drnn: DynamicRNN):
        self.d = drnn

    def __enter__(self):
        d = self.d
        d._in_step = True
        d._guard = d._rnn.step()
        # pre-step plumbing happens lazily on first step_input
        d._entered = d._guard.__enter__()
        return d

    def __exit__(self, exc_type, *a):
        self.d._in_step = False
        return self.d._guard.__exit__(exc_type, *a)
