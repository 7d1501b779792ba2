"""LayerHelper: shared plumbing for layers — parameter creation wired to the
startup program, op appending, activation sugar."""
from __future__ import annotations

from . import unique_name
from .framework import default_main_program, default_startup_program
from .initializer import Constant, Xavier
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        def _names(d):
            out = {}
            for slot, vs in (d or {}).items():
                if not isinstance(vs, (list, tuple)):
                    vs = [vs]
                out[slot] = [v if isinstance(v, str) else v.name for v in vs]
            return out

        return self.main_program.current_block().append_op(
            type, _names(inputs), _names(outputs), attrs)

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None, **kw):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if attr.name is None:
            attr.name = unique_name.generate(
                ".".join([self.name, "b" if is_bias else "w"]))
        init = attr.initializer or default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else Xavier()
        block = self.main_program.current_block()
        param = block.create_parameter(
            shape=shape, dtype=dtype, name=attr.name,
            trainable=attr.trainable, regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            optimize_attr={"learning_rate": attr.learning_rate}, **kw)
        # mirror into the startup program + append the init op there
        sblock = self.startup_program.global_block
        sparam = sblock.create_parameter(shape=shape, dtype=dtype,
                                         name=attr.name,
                                         trainable=attr.trainable)
        init(sparam, sblock)
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_or_get_global_variable(self, name, shape, dtype,
                                      persistable=True, initializer=None):
        """A persistable var in both the main and the startup program, its
        init op in the startup program (optimizer accumulators, the
        learning rate)."""
        block = self.main_program.global_block
        if name in block.vars:
            return block.vars[name]
        v = block.create_var(name=name, shape=shape, dtype=dtype,
                             persistable=persistable, stop_gradient=True)
        sblock = self.startup_program.global_block
        sv = sblock.create_var(name=name, shape=shape, dtype=dtype,
                               persistable=persistable)
        (initializer or Constant(0.0))(sv, sblock)
        return v

    def append_activation(self, out_var, act: str | None):
        if act is None:
            return out_var
        act_out = self.create_variable_for_type_inference(out_var.dtype)
        self.append_op(act, inputs={"X": [out_var]}, outputs={"Out": [act_out]})
        return act_out

    def append_bias_op(self, input_var, bias_attr):
        size = input_var.shape[-1]
        b = self.create_parameter(bias_attr, [size], input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        # axis=-1: a [size] bias always lands on the last dim
        self.append_op("elementwise_add", inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]}, attrs={"axis": -1})
        return out
