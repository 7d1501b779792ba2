"""The layers the serving decoder, the BERT and WMT trainers, the ResNet
trainer, the learning-rate schedules, the control-flow bodies and the book
models build with. Each
appends the same ops, with the same slots and attrs, as its namesake in the
JAX package's layers/nn.py, so both packages build op-for-op identical
programs."""
from __future__ import annotations

import math

from ..core.types import DType
from ..framework import Variable
from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "layer_norm", "elementwise_add",
           "elementwise_mul", "elementwise_div", "elementwise_max", "scale",
           "reduce_sum", "reduce_mean", "mean", "sqrt", "exp", "relu",
           "square_error_cost", "conv2d",
           "conv2d_transpose", "pool2d", "batch_norm", "topk", "accuracy",
           "space_to_depth",
           "softmax_with_cross_entropy", "cross_entropy", "cross_entropy2",
           "sigmoid_cross_entropy_with_logits", "reshape", "transpose", "slice",
           "squeeze", "unsqueeze", "argmax", "fused_attention", "dropout",
           "softmax", "matmul", "one_hot", "label_smooth",
           "elementwise_min", "elementwise_pow", "pow", "cast", "increment",
           "elementwise_sub", "sigmoid", "tanh", "log", "concat", "split",
           "gather", "scatter", "where"]


def _elementwise_binary(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    if not isinstance(y, Variable):
        # a scalar operand lowers to `scale`
        if op_type == "elementwise_add":
            return scale(x, scale=1.0, bias=float(y))
        if op_type == "elementwise_sub":
            return scale(x, scale=1.0, bias=-float(y))
        if op_type == "elementwise_mul":
            return scale(x, scale=float(y))
        if op_type == "elementwise_div":
            return scale(x, scale=1.0 / float(y))
        from .tensor import fill_constant

        y = fill_constant(shape=[1], dtype=x.dtype.value, value=float(y))
    if not isinstance(x, Variable):
        # a scalar on the left: the broadcast aligns Y to X, so lower to
        # the scale/reciprocal forms
        if op_type == "elementwise_add":
            return scale(y, scale=1.0, bias=float(x))
        if op_type == "elementwise_mul":
            return scale(y, scale=float(x))
        if op_type == "elementwise_sub":
            return scale(y, scale=-1.0, bias=float(x))
        if op_type == "elementwise_div":
            return scale(_unary("reciprocal", y), scale=float(x))
        from .tensor import fill_constant

        x = fill_constant(shape=[1], dtype=y.dtype.value, value=float(x))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise_binary("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise_binary("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise_binary("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise_binary("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise_binary("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise_binary("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise_binary("elementwise_pow", x, y, axis, act, name)


def pow(x, factor=1.0, name=None):
    return _unary("pow", x, name, factor=factor)


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = DType.parse(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype.value,
                            "in_dtype": x.dtype.value})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(op_type, inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def sqrt(x, name=None):
    return _unary("sqrt", x, name)


def sigmoid(x, name=None):
    return _unary("sigmoid", x, name)


def tanh(x, name=None):
    return _unary("tanh", x, name)


def log(x, name=None):
    return _unary("log", x, name)


def exp(x, name=None):
    return _unary("exp", x, name)


def relu(x, name=None):
    return _unary("relu", x, name)


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, name=None):
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def cross_entropy2(input, label, name=None, ignore_index=-100):
    helper = LayerHelper("cross_entropy2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    match = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy2", {"X": [input], "Label": [label]},
                     {"Y": [out], "MatchX": [match], "XShape": [xshape]},
                     {"ignore_index": ignore_index})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer: a mul per input (each with its own weight),
    their sum where there are several, + bias + act."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_dim = math.prod(inp.shape[num_flatten_dims:])
        w = helper.create_parameter(param_attr, [in_dim, size], inp.dtype)
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op(
            "mul", inputs={"X": [inp], "Y": [w]}, outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = (helper.append_bias_op(pre_bias, bias_attr)
               if bias_attr is not False else pre_bias)
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """Embedding lookup (lookup_table)."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, list(size), dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": -1 if padding_idx is None else padding_idx})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [math.prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, norm_shape, "float32",
            default_initializer=Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, norm_shape, "float32", is_bias=True)]
    y = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    var = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    helper.append_op(
        "layer_norm", inputs=inputs,
        outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(y, act)


def _two(v):
    """A scalar or a pair as a list attr."""
    return list(v if isinstance(v, (list, tuple)) else (v, v))


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           use_cudnn=True, data_format="NCHW"):
    """2-D convolution. NCHW filters are OIHW; NHWC filters are allocated
    HWIO, as in the JAX package. `padding` may be [top, bottom, left,
    right]. `use_cudnn` is accepted for API parity and not read."""
    helper = LayerHelper("conv2d", name=name)
    num_channels = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    fs = _two(filter_size)
    if data_format == "NHWC":
        w_shape = [fs[0], fs[1], num_channels // groups, num_filters]
    else:
        w_shape = [num_filters, num_channels // groups, fs[0], fs[1]]
    fan_in = (num_channels // groups) * fs[0] * fs[1]
    w = helper.create_parameter(
        param_attr, w_shape, input.dtype,
        default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "depthwise_conv2d" if groups == num_channels
        and num_filters == num_channels else "conv2d",
        inputs={"Input": [input], "Filter": [w]}, outputs={"Output": [out]},
        attrs={"strides": _two(stride), "paddings": _two(padding),
               "dilations": _two(dilation), "groups": groups,
               "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(
            "elementwise_add", inputs={"X": [out], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": 1 if data_format == "NCHW" else -1})
        out = tmp
    return helper.append_activation(out, act)


def conv2d_transpose(input, num_filters, filter_size=None, stride=1,
                     padding=0, dilation=1, param_attr=None, bias_attr=None,
                     act=None, name=None, output_size=None, groups=None):
    """2-D transposed convolution, NCHW, filter (C_in, num_filters / groups,
    kh, kw). Given output_size and no filter_size, the filter is sized to
    give that output, as the reference layer does. `groups` is set as an
    attr only when given (the JAX package's layer has none)."""
    helper = LayerHelper("conv2d_transpose", name=name)
    num_channels = input.shape[1]
    if filter_size is None:
        if output_size is None:
            raise ValueError("conv2d_transpose needs filter_size or "
                             "output_size")
        outs, ins = _two(output_size), input.shape[2:]
        s_, p_, d_ = _two(stride), _two(padding), _two(dilation)
        filter_size = [(outs[i] - (ins[i] - 1) * s_[i] + 2 * p_[i] - 1)
                       // d_[i] + 1 for i in range(2)]
    fs = _two(filter_size)
    w = helper.create_parameter(
        param_attr, [num_channels, num_filters // (groups or 1), fs[0], fs[1]],
        input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"strides": _two(stride), "paddings": _two(padding),
             "dilations": _two(dilation)}
    if groups is not None:
        attrs["groups"] = groups
    helper.append_op("conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]}, attrs=attrs)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [tmp]}, attrs={"axis": 1})
        out = tmp
    return helper.append_activation(out, act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, exclusive=True, name=None,
           use_cudnn=True, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _two(pool_size),
               "strides": _two(pool_stride), "paddings": _two(pool_padding),
               "global_pooling": global_pooling, "exclusive": exclusive,
               "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW", name=None,
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False):
    """Batch normalization over every axis but the channel's. The running
    statistics are persistable non-parameters `<name>.mean` / `<name>.var`
    that the op reads and writes."""
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [c], "float32",
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], "float32", is_bias=True)
    mean = helper.create_or_get_global_variable(
        moving_mean_name or helper.name + ".mean", [c], "float32",
        initializer=Constant(0.0))
    var = helper.create_or_get_global_variable(
        moving_variance_name or helper.name + ".var", [c], "float32",
        initializer=Constant(1.0))
    y = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [var]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [var],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test or use_global_stats,
               "data_layout": data_layout})
    return helper.append_activation(y, act)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """Classification accuracy: the share of rows whose top-k holds the
    label."""
    helper = LayerHelper("accuracy")
    _, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "accuracy",
        inputs={"Out": [input], "Indices": [indices], "Label": [label]},
        outputs={"Accuracy": [acc], "Correct": [correct], "Total": [total]})
    return acc


def space_to_depth(x, blocksize, name=None):
    helper = LayerHelper("space_to_depth")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("space_to_depth", {"X": [x]}, {"Out": [out]},
                     {"blocksize": blocksize})
    return out


def _unary(op_type, x, name=None, **attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape2", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose2", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": list(perm)})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "slice", inputs={"Input": [input]}, outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)})
    return out


def squeeze(input, axes, name=None):
    return _unary("squeeze2", input, name, axes=list(axes))


def unsqueeze(input, axes, name=None):
    return _unary("unsqueeze2", input, name, axes=list(axes))


def argmax(x, axis=0, name=None):
    helper = LayerHelper("arg_max", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_max", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def fused_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    use_pallas=False, name=None):
    """Fused scaled-dot-product attention over [B, nh, S, dh] tensors, one
    op for the whole QK^T -> softmax -> PV block (ops/attention_ops.py
    routes it to the prefill kernel K2 up to S = 512 and to the flash
    kernel K10 past it). `use_pallas` is kept as an attr for IR parity with
    the JAX package; the port's dispatch does not read it."""
    helper = LayerHelper("fused_attention", name=name)
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        inputs["Bias"] = [bias]
    helper.append_op(
        "fused_attention", inputs, {"Out": [out]},
        {"causal": causal, "sm_scale": float(sm_scale),
         "use_pallas": bool(use_pallas)})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Out = x * Mask, Mask drawn from the run's generator (the op reads
    no per-op seed: the `seed` attr is kept for IR parity)."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        "dropout", inputs={"X": [x]}, outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed or 0,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, axis=-1, name=None, use_cudnn=False):
    return _unary("softmax", input, name, axis=axis)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": alpha})
    return out


def one_hot(input, depth, name=None):
    helper = LayerHelper("one_hot", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"depth": depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op("label_smooth", inputs=inputs, outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": input}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """`num_or_sections` equal parts (an int) or parts of the listed sizes
    along `dim`; a list of vars."""
    helper = LayerHelper("split", name=name)
    dim = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections, n_out = num_or_sections, [], num_or_sections
    else:
        num, sections = 0, list(num_or_sections)
        n_out = len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n_out)]
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs},
                     attrs={"axis": dim, "num": num, "sections": sections})
    return outs


def gather(input, index, name=None):
    helper = LayerHelper("gather", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("scatter",
                     inputs={"X": [input], "Ids": [index], "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where",
                     inputs={"Condition": [condition], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out
