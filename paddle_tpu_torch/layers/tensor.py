"""The `data` input declaration and the tensor-creation layers (the JAX
package's layers/tensor.py)."""
from __future__ import annotations

from ..core.types import DType
from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ["data", "fill_constant", "zeros", "ones", "assign",
           "create_tensor", "create_global_var",
           "fill_constant_batch_size_like", "zeros_like", "ones_like",
           "linspace", "range", "uniform_random", "gaussian_random"]


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
    """Copy var `input` into `output`, a new var when None; a numpy array
    (or anything np.asarray takes) becomes an assign_value op holding its
    values."""
    import numpy as np

    from ..framework import Variable

    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
        return output
    arr = np.asarray(input)
    if output is None:
        output = helper.create_variable_for_type_inference(DType.parse(arr.dtype))
    helper.append_op("assign_value", outputs={"Out": [output]},
                     attrs={"shape": list(arr.shape),
                            "dtype": DType.parse(arr.dtype).value,
                            "values": arr.reshape(-1).tolist()})
    return output


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(DType.parse(dtype))
    helper.append_op("fill_constant_batch_size_like", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": DType.parse(dtype).value,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0, name=name)


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0, name=name)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("fill_any_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_any_like", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"value": 1.0})
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_global_variable(shape=[1], dtype=dtype,
                                         persistable=persistable, name=name)


def _creation(op_type, dtype, name=None, **attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(DType.parse(dtype))
    helper.append_op(op_type, outputs={"Out": [out]},
                     attrs=dict(attrs, dtype=DType.parse(dtype).value))
    return out


def linspace(start, stop, num, dtype="float32"):
    return _creation("linspace", dtype, start=float(start), stop=float(stop),
                     num=int(num))


def range(start, end, step, dtype="int64"):
    return _creation("range", dtype, start=float(start), end=float(end),
                     step=float(step))


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    """Uniform draws from the run's generator."""
    return _creation("uniform_random", dtype, name, shape=list(shape),
                     min=float(min), max=float(max), seed=int(seed))


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0,
                    name=None):
    return _creation("gaussian_random", dtype, name, shape=list(shape),
                     mean=float(mean), std=float(std), seed=int(seed))


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False,
                      name=None):
    """A global-block var initialized to `value` by the startup program."""
    from ..initializer import Constant

    helper = LayerHelper("global_var", name=name)
    return helper.create_or_get_global_variable(
        name or helper.name, shape, dtype, persistable=persistable,
        initializer=Constant(value))

