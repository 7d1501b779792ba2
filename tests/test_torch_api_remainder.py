"""The API remainder of the port held against the JAX package on the CPU:
every initializer's startup program (by `to_dict()`) and values or laws,
`name_scope`, the top-level names and the place objects."""
import types

import numpy as np
import pytest
import torch

import torch_parity as tp

import paddle_tpu as jpt
import paddle_tpu.initializer as jinit
import paddle_tpu_torch as tpt
import paddle_tpu_torch.initializer as tinit
from paddle_tpu.param_attr import ParamAttr as JAttr
from paddle_tpu_torch.framework import OpError
from paddle_tpu_torch.param_attr import ParamAttr as TAttr

ARRAY = np.arange(24, dtype=np.float32).reshape(6, 4) / 7.0
INITS = {  # name: (the initializer's arguments, the package module -> it)
    "Constant": lambda m: m.Constant(0.25),
    "Uniform": lambda m: m.Uniform(-0.3, 0.2, seed=3),
    "Normal": lambda m: m.Normal(0.1, 0.02, seed=4),
    "TruncatedNormal": lambda m: m.TruncatedNormal(0.0, 0.05, seed=5),
    "Xavier": lambda m: m.Xavier(),
    "Xavier_normal_fans": lambda m: m.Xavier(uniform=False, fan_in=30,
                                             fan_out=50, seed=6),
    "MSRA": lambda m: m.MSRA(),
    "MSRA_normal_fan_in": lambda m: m.MSRA(uniform=False, fan_in=20, seed=7),
    "NumpyArrayInitializer": lambda m: m.NumpyArrayInitializer(ARRAY),
    "ConstantInitializer": lambda m: m.ConstantInitializer(-1.5),
    "UniformInitializer": lambda m: m.UniformInitializer(0.0, 1.0),
    "NormalInitializer": lambda m: m.NormalInitializer(),
    "XavierInitializer": lambda m: m.XavierInitializer(uniform=False),
    "MSRAInitializer": lambda m: m.MSRAInitializer(),
}


def _conv_with(init_of):
    """A conv2d (weight [6, 4, 3, 3]) and an fc after it (weight [96, 5]),
    both weights under the initializer, so 4-D and 2-D fans are both
    drawn; the NumpyArrayInitializer goes on an fc of its array's shape."""
    def fn(pkg):
        L, attr = pkg["L"], (JAttr if pkg is tp.J else TAttr)
        mod = jinit if pkg is tp.J else tinit
        if init_of is INITS["NumpyArrayInitializer"]:
            x = L.data(name="x", shape=[6], dtype="float32")
            return L.fc(x, size=4, param_attr=attr(initializer=init_of(mod)))
        img = L.data(name="img", shape=[4, 6, 6], dtype="float32")
        c = L.conv2d(img, num_filters=6, filter_size=3,
                     param_attr=attr(initializer=init_of(mod)))
        return L.fc(c, size=5, param_attr=attr(initializer=init_of(mod)))
    return fn


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_startup_programs_equal_jax(name):
    (jm, js, _), (tm, ts, _) = (tp.build(p, _conv_with(INITS[name]))
                                for p in (tp.J, tp.T))
    assert ts.to_dict() == js.to_dict()
    assert tm.to_dict() == jm.to_dict()


@pytest.mark.parametrize("name", ["NumpyArrayInitializer", "Constant"])
def test_deterministic_initializers_give_jax_values(name):
    (jm, js, _), (tm, ts, _) = (tp.build(p, _conv_with(INITS[name]))
                                for p in (tp.J, tp.T))
    jscope, tscope = jpt.Scope(), tpt.Scope()
    jpt.Executor().run(js, scope=jscope)
    tpt.Executor(place="cpu").run(ts, scope=tscope)
    params = [p.name for p in tm.all_parameters()]
    assert params == [p.name for p in jm.all_parameters()]
    for n in params:
        np.testing.assert_array_equal(tscope.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)), n)
    if name == "NumpyArrayInitializer":
        w = [n for n in params if tscope.find_var(n).shape == ARRAY.shape]
        np.testing.assert_array_equal(tscope.find_var(w[0]).numpy(), ARRAY)


# fan_in 2304, fan_out 576: both packages take the fans as the JAX
# package's _fan_in_out does, shape[0] and shape[1] times the receptive field
LAW_SHAPE = [256, 64, 3, 3]


@pytest.mark.parametrize("name,law", [
    ("Xavier", ("uniform", (6.0 / (576 + 2304)) ** 0.5)),
    ("Xavier_normal_fans", ("normal", (2.0 / (30 + 50)) ** 0.5)),
    ("MSRA", ("uniform", (6.0 / 2304) ** 0.5)),
    ("MSRA_normal_fan_in", ("normal", (2.0 / 20) ** 0.5)),
])
def test_fan_initializers_draw_the_law_of_the_jax_fans(name, law):
    """The port draws from its own generator, so its values are the JAX
    package's in law only: the startup attrs name the same bounds or std
    (the to_dict test), and 147,456 draws fit that law: uniform within its
    bound, filling it, with std bound / sqrt(3); normal with its std, both
    within 2% (the draw's own spread is ~0.3%)."""
    kind, scale = law
    prog, startup = tpt.Program(), tpt.Program()
    startup.random_seed = 0
    with tpt.program_guard(prog, startup):
        block = startup.global_block
        var = block.create_parameter(shape=LAW_SHAPE, dtype="float32",
                                     name="w")
        INITS[name](tinit)(var, block)
    scope = tpt.Scope()
    tpt.Executor(place="cpu").run(startup, scope=scope)
    w = scope.find_var("w").numpy().astype(np.float64)
    if kind == "uniform":
        assert np.abs(w).max() <= scale and np.abs(w).max() > 0.99 * scale
        assert abs(w.std() - scale / 3 ** 0.5) < 0.02 * scale / 3 ** 0.5
    else:
        assert abs(w.std() - scale) < 0.02 * scale
    assert abs(w.mean()) < 0.02 * scale


def test_name_scope_tags_ops():
    """The counterpart of tests/test_diagnostics.py:98: ops appended inside
    nested scopes carry "outer/inner", and the program equals the JAX
    package's by to_dict()."""
    def build(pkg):
        L = pkg["L"]
        x = L.data(name="x", shape=[4], dtype="float32")
        with pkg["pt"].name_scope("encoder"):
            with pkg["pt"].name_scope("block1"):
                h = L.scale(x, 2.0)
            h = L.relu(h)
        return L.scale(h, 3.0)

    (jm, _, _), (tm, _, _) = (tp.build(p, build) for p in (tp.J, tp.T))
    ops = tm.global_block.ops
    assert [op.attrs.get("op_namescope") for op in ops] == \
        ["encoder/block1", "encoder", None]
    assert tm.to_dict() == jm.to_dict()


def test_op_error_names_the_scope():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.name_scope("head"):
        x = tpt.layers.data(name="x", shape=[4], dtype="float32")
        out = tpt.layers.mul(x, x)        # [B, 4] x [B, 4]: fails at run
    with pytest.raises(OpError, match=r"Operator 'mul' \(scope head\)"):
        tpt.Executor(place="cpu").run(
            main, feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[out],
            scope=tpt.Scope())


def _names(pkg):
    return {n for n in dir(pkg) if not n.startswith("_")
            and not isinstance(getattr(pkg, n), types.ModuleType)}


def test_top_level_names_the_port_lacks():
    """The JAX package's top-level names (modules aside, which depend on
    what a process imported) that the port still lacks, exactly: the
    parameter-server transpiler (ROADMAP Queue 1, "parallel and
    distributed"), TPUPlace (the port's is CUDAPlace), global_scope and
    scope_guard (no global scope, by construction). The compiler's names
    are ported."""
    assert _names(jpt) - _names(tpt) == {
        "DistributeTranspiler", "DistributeTranspilerConfig", "TPUPlace",
        "global_scope", "scope_guard"}
    for n in ("BuildStrategy", "CompiledProgram", "ExecutionStrategy"):
        assert getattr(tpt, n) is getattr(tpt.compiler, n)
    assert _names(tpt) - _names(jpt) == {"CUDAPlace"}
    for n in ("Block", "Operator", "Parameter", "Variable", "OpError"):
        assert getattr(tpt, n) is getattr(tpt.framework, n)


def test_place_objects_select_the_device():
    from paddle_tpu_torch.executor import resolve_device

    assert resolve_device(tpt.CPUPlace()) == torch.device("cpu")
    assert resolve_device(tpt.CUDAPlace(1)) == torch.device("cuda", 1)
    assert repr(tpt.CUDAPlace(1)) == "CUDAPlace(1)"
    exe = tpt.Executor(place=tpt.CPUPlace())
    assert exe.place == torch.device("cpu")
