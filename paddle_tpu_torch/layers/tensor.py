"""The `data` input declaration and the tensor-creation layers the ported
paths use: fill_constant, assign, create_global_var."""
from __future__ import annotations

from ..core.types import DType
from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ["data", "fill_constant", "assign", "create_global_var"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare a feed input. With append_batch_size=True a leading -1 batch
    dim is added."""
    if append_batch_size:
        shape = [-1] + list(shape)
    return default_main_program().current_block().create_var(
        name=name, shape=shape, dtype=dtype, is_data=True,
        stop_gradient=stop_gradient)


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(DType.parse(dtype))
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": DType.parse(dtype).value,
                            "value": float(value)})
    return out


def assign(input, output=None):
    """Copy var `input` into `output`, a new var when None."""
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": [input]}, outputs={"Out": [output]})
    return output


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False,
                      name=None):
    """A global-block var initialized to `value` by the startup program."""
    from ..initializer import Constant

    helper = LayerHelper("global_var", name=name)
    return helper.create_or_get_global_variable(
        name or helper.name, shape, dtype, persistable=persistable,
        initializer=Constant(value))

