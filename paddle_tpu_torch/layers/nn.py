"""The layers of the JAX package's layers/nn.py but its ring-attention
layer: those the serving decoder, the BERT
and WMT trainers, the ResNet trainer, the learning-rate schedules, the
control-flow bodies and the book models build with, the long tail
(activations, reductions, losses, the sampled losses, the host-op layers
Print, unique, filter_by_instag and py_func), the vision layers, and the
crf and ctc layers (linear_chain_crf, crf_decoding, warpctc,
ctc_greedy_decoder, edit_distance, chunk_eval). Each
appends the same ops, with the same slots and attrs, as its namesake in the
JAX package's layers/nn.py, so both packages build op-for-op identical
programs."""
from __future__ import annotations

import math

from ..core.types import DType
from ..framework import Variable
from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "layer_norm", "elementwise_add",
           "elementwise_mul", "elementwise_div", "elementwise_max", "scale",
           "reduce_sum", "reduce_mean", "mean", "sqrt", "exp", "relu",
           "square_error_cost", "conv2d",
           "conv2d_transpose", "pool2d", "batch_norm", "topk", "accuracy",
           "space_to_depth",
           "softmax_with_cross_entropy", "cross_entropy", "cross_entropy2",
           "sigmoid_cross_entropy_with_logits", "reshape", "transpose", "slice",
           "squeeze", "unsqueeze", "argmax", "fused_attention",
           "ring_attention", "dropout",
           "softmax", "matmul", "one_hot", "label_smooth",
           "elementwise_min", "elementwise_pow", "pow", "cast", "increment",
           "elementwise_sub", "sigmoid", "tanh", "log", "concat", "split",
           "gather", "scatter", "where", "merge_selected_rows",
           "get_tensor_from_selected_rows", "row_conv", "lstm",
           "dynamic_lstmp", "match_matrix_tensor",
           # the long tail (the JAX package's layers/nn.py)
           "Print", "abs", "add_position_encoding", "argmin", "argsort",
           "autoincreased_step_counter", "bpr_loss", "brelu", "center_loss",
           "clip", "clip_by_norm", "continuous_value_model", "cos_sim",
           "cumsum", "data_norm", "dice_loss", "dot", "elementwise_floordiv",
           "elementwise_mod", "elu", "expand", "filter_by_instag", "flatten",
           "fsp_matrix", "gather_nd", "gaussian_random_batch_size_like",
           "gelu", "group_norm", "hard_sigmoid", "hard_swish", "hash",
           "hsigmoid", "huber_loss", "kldiv_loss", "l2_normalize",
           "leaky_relu", "lod_reset", "log_loss", "log_softmax", "lstm_unit",
           "margin_rank_loss", "mean_iou", "mul", "nce", "npair_loss", "pad",
           "pad2d", "prelu", "py_func", "rank", "rank_loss", "reduce_all",
           "reduce_any", "reduce_max", "reduce_min", "reduce_prod", "relu6",
           "sampled_softmax_with_cross_entropy", "scatter_nd",
           "scatter_nd_add", "selu", "shape", "sign", "size", "smooth_l1",
           "soft_relu", "spectral_norm", "square", "stack", "stanh", "sum",
           "sums", "swish", "teacher_student_sigmoid_loss", "tree_conv",
           "uniform_random_batch_size_like", "unique", "unique_with_counts",
           "unstack",
           # the vision layers (the JAX package's layers/nn.py)
           "adaptive_pool2d", "adaptive_pool3d", "affine_channel",
           "affine_grid", "bilinear_tensor_product", "conv3d",
           "conv3d_transpose", "crop", "deformable_conv", "grid_sampler",
           "im2sequence", "image_resize", "image_resize_short", "lrn",
           "maxout", "multiplex", "pad_constant_like", "pixel_shuffle",
           "pool3d", "random_crop", "resize_bilinear", "resize_nearest",
           "resize_trilinear", "roi_align", "roi_pool", "sampling_id",
           "shard_index", "shuffle_channel", "temporal_shift", "unfold",
           # the crf and ctc layers (the JAX package's layers/nn.py)
           "linear_chain_crf", "crf_decoding", "warpctc", "ctc_greedy_decoder",
           "edit_distance", "chunk_eval"]


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
    routes it through the tuner's `attention_backend`: by default to the
    prefill kernel K2 up to S = 512 and to the flash kernel K10 past it). `use_pallas` is kept as an attr for IR parity with
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


def ring_attention(q, k, v, causal=False, sm_scale=None, ring_id=0,
                   name=None):
    """Sequence-parallel ring attention: exact attention over a sequence
    split across the mesh axis bound to `ring_id` (K/V blocks rotate round
    the ring with an online-softmax merge, ops/attention_ops.py). With no
    ring bound: fused attention on the local sequence."""
    helper = LayerHelper("ring_attention", name=name)
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op(
        "ring_attention", {"Q": [q], "K": [k], "V": [v]}, {"Out": [out]},
        {"causal": causal, "sm_scale": float(sm_scale), "ring_id": ring_id})
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


def merge_selected_rows(x, name=None):
    """Sum the duplicate rows of a SelectedRows var (a sparse grad)."""
    helper = LayerHelper("merge_selected_rows")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("merge_selected_rows", {"X": [x]}, {"Out": [out]}, {})
    return out


def get_tensor_from_selected_rows(x, name=None):
    """The value tensor of a SelectedRows var."""
    helper = LayerHelper("get_tensor_from_selected_rows")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("get_tensor_from_selected_rows", {"X": [x]},
                     {"Out": [out]}, {})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead convolution (row_conv_op.cc).
    input [B, T, D]; filter [future_context_size+1, D]."""
    helper = LayerHelper("row_conv")
    dtype = input.dtype
    filt = helper.create_parameter(
        param_attr, [future_context_size + 1, input.shape[-1]], dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("row_conv", {"X": [input], "Filter": [filt]},
                     {"Out": [out]}, {})
    return helper.append_activation(out, act)


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Stacked, optionally bidirectional LSTM over [B, T, D] (the
    cudnn_lstm op). Returns (rnn_out, last_h, last_c). The flat weight
    packs ONE 4H bias per layer and direction, the JAX package's layout,
    not cuDNN's two (b_ih + b_hh): a cuDNN checkpoint loads after folding
    them into one."""
    helper = LayerHelper("cudnn_lstm", name=name)
    dtype = input.dtype
    D = input.shape[-1]
    dirs = 2 if is_bidirec else 1
    n_w = 0
    for layer in range(num_layers):
        in_dim = D if layer == 0 else hidden_size * dirs
        n_w += dirs * (in_dim * 4 * hidden_size
                       + hidden_size * 4 * hidden_size + 4 * hidden_size)
    w = helper.create_parameter(
        ParamAttr(name=helper.name + ".w"), [n_w], dtype,
        default_initializer=default_initializer)
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "cudnn_lstm",
        {"Input": [input], "W": [w], "InitH": [init_h], "InitC": [init_c]},
        {"Out": [out], "LastH": [last_h], "LastC": [last_c]},
        {"num_layers": int(num_layers), "hidden_size": int(hidden_size),
         "is_bidirec": bool(is_bidirec), "dropout_prob": float(dropout_prob),
         "is_test": bool(is_test), "seed": int(seed)})
    return out, last_h, last_c


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=False, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """lstmp_op.cc: LSTM with a learned
    projection on the recurrent path. input [B, T, 4H] pre-projected; size
    is 4*H like dynamic_lstm. Returns (projection [B,T,P], cell [B,T,H])."""
    if use_peepholes:
        raise NotImplementedError(
            "dynamic_lstmp: peephole connections are not implemented "
            "(reference default use_peepholes=True differs; pass False)")
    H = size // 4
    helper = LayerHelper("dynamic_lstmp", name=name)
    weight = helper.create_parameter(param_attr, [proj_size, 4 * H], dtype)
    proj_weight = helper.create_parameter(
        ParamAttr(name=helper.name + ".proj_w"), [H, proj_size], dtype)
    bias = helper.create_parameter(bias_attr, [1, 4 * H], dtype,
                                   is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "Weight": [weight],
           "ProjWeight": [proj_weight]}
    if bias is not None:
        ins["Bias"] = [bias]
    helper.append_op(
        "lstmp", ins, {"Projection": [proj], "Cell": [cell]},
        {"is_reverse": bool(is_reverse),
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation,
         "proj_activation": proj_activation})
    return proj, cell


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None, x_length=None,
                        y_length=None):
    """out[b,c,i,j] = x_i^T W_c y_j.
    Padded design: x [B, Tx, H], y [B, Ty, H] -> out [B, C, Tx, Ty]."""
    helper = LayerHelper("match_matrix_tensor", name=name)
    H = x.shape[-1]
    w = helper.create_parameter(param_attr, [H, channel_num, H], dtype)
    out = helper.create_variable_for_type_inference(dtype)
    ins = {"X": [x], "Y": [y], "W": [w]}
    if x_length is not None:
        ins["XLength"] = [x_length]
    if y_length is not None:
        ins["YLength"] = [y_length]
    helper.append_op("match_matrix_tensor", ins, {"Out": [out]}, {})
    return helper.append_activation(out, act), w


# ---------------------------------------------------------------------------
# The long tail: activations, math, tensor and nn layers, the sampled
# losses and the host-op layers, each building the JAX package's program.
# ---------------------------------------------------------------------------


def _simple_op(op_type, inputs, attrs=None, out_slot="Out", dtype=None):
    helper = LayerHelper(op_type)
    first = next(v for vs in inputs.values() for v in vs)
    out = helper.create_variable_for_type_inference(dtype or first.dtype)
    helper.append_op(op_type, inputs, {out_slot: [out]}, attrs or {})
    return out


def gelu(x, name=None):
    return _unary("gelu", x, name)


def leaky_relu(x, alpha=0.02, name=None):
    return _unary("leaky_relu", x, name, alpha=alpha)


def square(x, name=None):
    return _unary("square", x, name)


def abs(x, name=None):
    return _unary("abs", x, name)


def log_softmax(input, axis=-1, name=None):
    return _unary("log_softmax", input, name, axis=axis)


def clip(x, min, max, name=None):
    return _unary("clip", x, name, min=min, max=max)


def clip_by_norm(x, max_norm, name=None):
    return _unary("clip_by_norm", x, name, max_norm=max_norm)


def elu(x, alpha=1.0, name=None):
    return _simple_op("elu", {"X": [x]}, {"alpha": alpha})


def relu6(x, threshold=6.0, name=None):
    return _simple_op("relu6", {"X": [x]}, {"threshold": threshold})


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _simple_op("hard_sigmoid", {"X": [x]},
                      {"slope": slope, "offset": offset})


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _simple_op("hard_swish", {"X": [x]},
                      {"threshold": threshold, "scale": scale,
                       "offset": offset})


def swish(x, beta=1.0, name=None):
    return _simple_op("swish", {"X": [x]}, {"beta": beta})


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _simple_op("brelu", {"X": [x]}, {"t_min": t_min, "t_max": t_max})


def soft_relu(x, threshold=40.0, name=None):
    return _simple_op("soft_relu", {"X": [x]}, {"threshold": threshold})


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _simple_op("stanh", {"X": [x]},
                      {"scale_a": scale_a, "scale_b": scale_b})


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _simple_op("selu", {"X": [x]}, {"scale": scale, "alpha": alpha})


def sign(x, name=None):
    return _simple_op("sign", {"X": [x]})


def elementwise_mod(x, y, axis=-1, name=None):
    return _simple_op("elementwise_mod", {"X": [x], "Y": [y]}, {"axis": axis})


def elementwise_floordiv(x, y, axis=-1, name=None):
    return _simple_op("elementwise_floordiv", {"X": [x], "Y": [y]},
                      {"axis": axis})


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def reduce_all(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", x, dim, keep_dim, name)


def reduce_any(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", x, dim, keep_dim, name)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def sum(x, name=None):
    xs = x if isinstance(x, (list, tuple)) else [x]
    return _simple_op("sum", {"X": list(xs)})


def flatten(x, axis=1, name=None):
    return _unary("flatten2", x, name, axis=axis)


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack", name=name)
    n = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype) for _ in range(n)]
    helper.append_op("unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis})
    return outs


def expand(x, expand_times, name=None):
    return _unary("expand", x, name, expand_times=list(expand_times))


def argmin(x, axis=0, name=None):
    helper = LayerHelper("arg_min", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_min", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int64")
    helper.append_op("argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [idx]},
                     attrs={"axis": axis})
    return out, idx


def pad(x, paddings, pad_value=0.0, name=None):
    return _unary("pad", x, name, paddings=list(paddings),
                  pad_value=float(pad_value))


def pad2d(input, paddings, mode="constant", pad_value=0.0, name=None):
    return _unary("pad2d", input, name, paddings=list(paddings), mode=mode,
                  pad_value=float(pad_value))


def gather_nd(input, index, name=None):
    return _simple_op("gather_nd", {"X": [input], "Index": [index]})


def scatter_nd_add(ref, index, updates, name=None):
    return _simple_op("scatter_nd_add",
                      {"X": [ref], "Index": [index], "Updates": [updates]})


def scatter_nd(index, updates, shape, name=None):
    return _simple_op("scatter_nd", {"Index": [index], "Updates": [updates]},
                      {"shape": list(shape)}, dtype=updates.dtype)


def shape(input, name=None):
    helper = LayerHelper("shape", name=name)
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op("shape", inputs={"X": [input]}, outputs={"Out": [out]})
    return out


def rank(input):
    """The static rank as a constant [1] int32."""
    from .tensor import fill_constant

    return fill_constant(shape=[1], dtype="int32", value=len(input.shape))


def size(input):
    """The element count at run time: the product of the run's shape."""
    shp = _simple_op("shape", {"X": [input]}, dtype="int32")
    shp.shape = (len(input.shape),)
    return _reduce("reduce_prod", cast(shp, "int64"), None, False, None)


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    return _unary("cum", x, name, axis=axis, exclusive=exclusive,
                  reverse=reverse)


def lod_reset(x, y=None, target_lod=None):
    """An identity: LoD is padding plus lengths here, as in the JAX
    package."""
    return x


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    helper = LayerHelper("group_norm", name=name)
    c = input.shape[1]
    inputs = {"X": [input]}
    if param_attr is not False:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, [c], "float32", default_initializer=Constant(1.0))]
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, [c], "float32",
                                                  is_bias=True)]
    y = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    var = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    helper.append_op("group_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(y, act)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0,
              name=None):
    helper = LayerHelper("smooth_l1_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op("smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [loss], "Diff": [diff]},
                     attrs={"sigma": sigma})
    return loss


def prelu(x, mode="all", param_attr=None, name=None):
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(param_attr, alpha_shape, x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op("norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def dot(x, y, name=None):
    helper = LayerHelper("dot", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("dot", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return out


def cos_sim(X, Y, name=None):
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype, stop_gradient=True)
    yn = helper.create_variable_for_type_inference(X.dtype, stop_gradient=True)
    helper.append_op("cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return out


def huber_loss(input, label, delta):
    return _simple_op("huber_loss", {"X": [input], "Y": [label]},
                      {"delta": delta})


def log_loss(input, label, epsilon=1e-4, name=None):
    return _simple_op("log_loss", {"Predicted": [input], "Labels": [label]},
                      {"epsilon": epsilon}, out_slot="Loss")


def kldiv_loss(x, target, reduction="mean", name=None):
    return _simple_op("kldiv_loss", {"X": [x], "Target": [target]},
                      {"reduction": reduction}, out_slot="Loss")


def rank_loss(label, left, right, name=None):
    return _simple_op("rank_loss",
                      {"Label": [label], "Left": [left], "Right": [right]})


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss")
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op("margin_rank_loss",
                     {"Label": [label], "X1": [left], "X2": [right]},
                     {"Out": [out], "Activated": [act]}, {"margin": margin})
    return out


def bpr_loss(input, label, name=None):
    return _simple_op("bpr_loss", {"X": [input], "Label": [label]},
                      out_slot="Y")


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2 |X . L| / (|X| + |L| + epsilon), from primitives."""
    from .tensor import fill_constant

    label_f = cast(label, input.dtype)
    inter = reduce_sum(elementwise_mul(input, label_f))
    union = reduce_sum(input) + reduce_sum(label_f)
    one = fill_constant(shape=[], dtype=input.dtype, value=1.0)
    eps = fill_constant(shape=[], dtype=input.dtype, value=epsilon)
    return one - elementwise_div(scale(inter, scale=2.0),
                                 elementwise_add(union, eps))


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("float32")
    correct = helper.create_variable_for_type_inference("float32")
    helper.append_op("mean_iou", {"Predictions": [input], "Labels": [label]},
                     {"OutMeanIou": [miou], "OutWrong": [wrong],
                      "OutCorrect": [correct]}, {"num_classes": num_classes})
    return miou, wrong, correct


def fsp_matrix(x, y):
    """The flow-of-solution-procedure matrix [B, C1, C2] of x [B, C1, H, W]
    and y [B, C2, H, W]: x_flat y_flat^T / (H W)."""
    C1, H, W = x.shape[1], x.shape[2], x.shape[3]
    xf = reshape(x, [-1, C1, H * W])
    yf = reshape(y, [-1, y.shape[1], H * W])
    return scale(matmul(xf, yf, transpose_y=True), scale=1.0 / (H * W))


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """alpha input + beta times the sinusoid table of [B, T, D]."""
    import numpy as np

    from .tensor import assign

    T, D = input.shape[1], input.shape[2]
    angle = np.arange(T)[:, None] / np.power(10000.0,
                                             2.0 * np.arange(D // 2)[None, :] / D)
    table = np.zeros((T, D), np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    enc = assign(table)
    return elementwise_add(scale(input, scale=alpha), scale(enc, scale=beta))


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """The NCE loss [B, 1]; negatives drawn each run (uniform or
    log_uniform)."""
    if custom_dist is not None or sample_weight is not None:
        raise NotImplementedError(
            "nce: custom_dist / sample_weight are not supported; use "
            "sampler='uniform' or 'log_uniform'")
    if sampler not in ("uniform", "log_uniform"):
        raise ValueError(f"nce: unknown sampler '{sampler}'")
    helper = LayerHelper("nce", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_total_classes, dim],
                                input.dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, [num_total_classes], input.dtype, is_bias=True)]
    cost = helper.create_variable_for_type_inference(input.dtype)
    samples = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        "nce", inputs, {"Cost": [cost], "SampleLabels": [samples]},
        {"num_total_classes": int(num_total_classes),
         "num_neg_samples": int(num_neg_samples or 5),
         "sampler": {"uniform": 0, "log_uniform": 1}[sampler], "seed": seed})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """The hierarchical sigmoid loss [B, 1] over a complete binary tree."""
    if is_custom or path_table is not None or path_code is not None:
        raise NotImplementedError(
            "hsigmoid custom trees (path_table/path_code) are not supported; "
            "the complete-binary-tree SimpleCode layout is")
    helper = LayerHelper("hsigmoid", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_classes - 1, dim], input.dtype)
    inputs = {"X": [input], "Label": [label], "W": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, [num_classes - 1], input.dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(input.dtype)
    pre = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("hierarchical_sigmoid", inputs,
                     {"Out": [out], "PreOut": [pre]},
                     {"num_classes": int(num_classes)})
    return out


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """Print the tensor at each run (a host op) and pass it through; the
    print_tensor_* knobs are accepted and the line holds name, shape,
    dtype and values."""
    helper = LayerHelper("print", name=None)
    out = helper.create_variable_for_type_inference(input.dtype)
    # a host op is never inferred: the layer declares its output's shape
    out.shape = tuple(input.shape)
    helper.append_op("print", {"In": [input]}, {"Out": [out]},
                     {"first_n": first_n, "message": message or input.name,
                      "summarize": summarize, "print_phase": print_phase})
    return out


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """weight / its largest singular value, by power iteration from U and
    V, parameters the op writes back each run."""
    helper = LayerHelper("spectral_norm", name=name)
    dtype = weight.dtype
    h = weight.shape[dim]
    w = math.prod(d for i, d in enumerate(weight.shape) if i != dim)
    u = helper.create_parameter(
        ParamAttr(name=helper.name + ".u", trainable=False,
                  initializer=Normal(0.0, 1.0)), [h], dtype)
    v = helper.create_parameter(
        ParamAttr(name=helper.name + ".v", trainable=False,
                  initializer=Normal(0.0, 1.0)), [w], dtype)
    u.stop_gradient = True
    v.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "spectral_norm", {"Weight": [weight], "U": [u], "V": [v]},
        {"Out": [out], "UOut": [u], "VOut": [v]},
        {"dim": int(dim), "power_iters": int(power_iters), "eps": float(eps)})
    return out


def data_norm(input, act=None, epsilon=1e-4, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    """Normalization from accumulated batch counters (batch size, sum,
    square sum), trained by their batch statistics."""
    helper = LayerHelper("data_norm", name=name)
    dtype = input.dtype
    C = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    defaults = {"batch_size": 1e4, "batch_sum": 0.0, "batch_square": 1e4}
    if isinstance(param_attr, dict):
        defaults.update({k: param_attr.get(k, v) for k, v in defaults.items()})

    def counter(suffix, key):
        return helper.create_parameter(
            ParamAttr(name=helper.name + suffix,
                      initializer=Constant(float(defaults[key]))), [C], dtype)

    bsize = counter(".batch_size", "batch_size")
    bsum = counter(".batch_sum", "batch_sum")
    bsq = counter(".batch_square_sum", "batch_square")
    out = helper.create_variable_for_type_inference(dtype)
    means = helper.create_variable_for_type_inference(dtype)
    scales = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "data_norm", {"X": [input], "BatchSize": [bsize], "BatchSum": [bsum],
                      "BatchSquareSum": [bsq]},
        {"Y": [out], "Means": [means], "Scales": [scales]},
        {"epsilon": float(epsilon), "data_layout": data_layout})
    return helper.append_activation(out, act)


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """0.5 ||x - c_label||^2 a row; the centers (a parameter) move toward
    their rows each run when update_center."""
    from .tensor import fill_constant

    helper = LayerHelper("center_loss")
    dtype = input.dtype
    centers = helper.create_parameter(param_attr, [num_classes, input.shape[-1]],
                                      dtype)
    centers.stop_gradient = True
    if not hasattr(alpha, "name"):
        alpha = fill_constant([1], "float32", float(alpha))
    loss = helper.create_variable_for_type_inference(dtype)
    diff = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "center_loss", {"X": [input], "Label": [label], "Centers": [centers],
                        "CenterUpdateRate": [alpha]},
        {"Loss": [loss], "SampleCenterDiff": [diff], "CentersOut": [centers]},
        {"need_update": bool(update_center)})
    return loss


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Soft-target cross entropy over anchor positive^T (targets from label
    equality, row-normalized) plus an L2 term, from primitives."""
    from .control_flow import equal

    B = labels.shape[0]
    lab = expand(reshape(labels, [B, 1]), [1, B])
    same = cast(equal(lab, transpose(lab, [1, 0])), "float32")
    target = elementwise_div(same, reduce_sum(same, dim=1, keep_dim=True))
    l2 = scale(elementwise_add(reduce_mean(reduce_sum(square(anchor), dim=1)),
                               reduce_mean(reduce_sum(square(positive), dim=1))),
               scale=l2_reg * 0.25)
    sim = matmul(anchor, positive, transpose_y=True)
    ce = softmax_with_cross_entropy(sim, target, soft_label=True)
    return elementwise_add(reduce_mean(ce), l2)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _simple_op("teacher_student_sigmoid_loss",
                      {"X": [input], "Label": [label]},
                      {"soft_max_up_bound": float(soft_max_up_bound),
                       "soft_max_lower_bound": float(soft_max_lower_bound)},
                      out_slot="Y")


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """sample_logits, then the softmax cross entropy (K6/K7 on the card)
    over the sampled columns, over num_true."""
    if use_customized_samples:
        raise NotImplementedError(
            "sampled_softmax_with_cross_entropy: use_customized_samples is "
            "not supported (only the log-uniform sampler)")
    helper = LayerHelper("sample_logits")
    samples = helper.create_variable_for_type_inference("int64")
    probabilities = helper.create_variable_for_type_inference(logits.dtype)
    sampled_logits = helper.create_variable_for_type_inference(logits.dtype)
    sampled_label = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        "sample_logits", {"Logits": [logits], "Labels": [label]},
        {"Samples": [samples], "SampledLogits": [sampled_logits],
         "SampledLabel": [sampled_label], "Probabilities": [probabilities]},
        {"num_samples": int(num_samples),
         "remove_accidental_hits": bool(remove_accidental_hits),
         "seed": int(seed)})
    loss = softmax_with_cross_entropy(sampled_logits, sampled_label)
    return scale(loss, scale=1.0 / num_true)


def unique(x, dtype="int32"):
    """A host op: the unique values in first-occurrence order and each
    element's index into them."""
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    index = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("unique", {"X": [x]}, {"Out": [out], "Index": [index]},
                     {"dtype": dtype})
    return out, index


def unique_with_counts(x, dtype="int32"):
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    index = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    count = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op("unique_with_counts", {"X": [x]},
                     {"Out": [out], "Index": [index], "Count": [count]},
                     {"dtype": dtype})
    return out, index, count


def hash(input, hash_size, num_hash=1, name=None):
    helper = LayerHelper("hash", name=name)
    out = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op("hash", {"X": [input]}, {"Out": [out]},
                     {"num_hash": int(num_hash), "mod_by": int(hash_size)})
    return out


def continuous_value_model(input, cvm, use_cvm=True):
    helper = LayerHelper("cvm")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cvm", {"X": [input], "CVM": [cvm]}, {"Y": [out]},
                     {"use_cvm": bool(use_cvm)})
    return out


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True):
    helper = LayerHelper("filter_by_instag")
    out = helper.create_variable_for_type_inference(ins.dtype)
    loss_weight = helper.create_variable_for_type_inference("float32")
    mmap = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        "filter_by_instag",
        {"Ins": [ins], "Ins_tag": [ins_tag], "Filter_tag": [filter_tag]},
        {"Out": [out], "LossWeight": [loss_weight], "IndexMap": [mmap]},
        {"is_lod": bool(is_lod)})
    return out, loss_weight


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 counter, incremented once a run."""
    helper = LayerHelper("global_step_counter")
    counter = helper.create_or_get_global_variable(
        name=counter_name or "@STEP_COUNTER@", shape=[1], dtype="int64",
        persistable=True, initializer=Constant(float(begin - step)))
    helper.append_op("increment", {"X": [counter]}, {"Out": [counter]},
                     {"step": float(step)})
    counter.stop_gradient = True
    return counter


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Run `func` (and `backward_func` for the grad) on numpy arrays as a
    host op; the `out` vars are made by the caller, who states their
    shapes and dtypes."""
    from ..ops.tensor_ops import register_py_func

    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    skip = skip_vars_in_backward_input or []
    skip_names = [v if isinstance(v, str) else v.name
                  for v in (skip if isinstance(skip, (list, tuple)) else [skip])]
    helper.append_op(
        "py_func", {"X": list(xs)}, {"Out": list(outs)},
        {"forward_callable_id": register_py_func(func),
         "backward_callable_id": (register_py_func(backward_func)
                                  if backward_func else -1),
         "skip_names": skip_names})
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """fc([x, h]) to the 4H gates, then the lstm_unit op: (hidden, cell)."""
    helper = LayerHelper("lstm_unit", name=name)
    H = hidden_t_prev.shape[-1]
    fc_out = fc(concat([x_t, hidden_t_prev], axis=-1), size=4 * H,
                param_attr=param_attr, bias_attr=bias_attr)
    hidden = helper.create_variable_for_type_inference(x_t.dtype)
    cell = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op("lstm_unit", {"X": [fc_out], "C_prev": [cell_t_prev]},
                     {"H": [hidden], "C": [cell]},
                     {"forget_bias": float(forget_bias)})
    return hidden, cell


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    helper = LayerHelper("tree_conv", name=name)
    dtype = nodes_vector.dtype
    w = helper.create_parameter(
        param_attr, [nodes_vector.shape[2], 3, output_size, num_filters], dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("tree_conv", {"NodesVector": [nodes_vector],
                                   "EdgeSet": [edge_set], "Filter": [w]},
                     {"Out": [out]}, {"max_depth": int(max_depth)})
    if bias_attr:
        out = helper.append_bias_op(out, bias_attr)
    return helper.append_activation(out, act)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "gaussian_random_batch_size_like", {"Input": [input]}, {"Out": [out]},
        {"shape": list(shape), "input_dim_idx": int(input_dim_idx),
         "output_dim_idx": int(output_dim_idx), "mean": float(mean),
         "std": float(std), "seed": int(seed), "dtype": dtype})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "uniform_random_batch_size_like", {"Input": [input]}, {"Out": [out]},
        {"shape": list(shape), "input_dim_idx": int(input_dim_idx),
         "output_dim_idx": int(output_dim_idx), "min": float(min),
         "max": float(max), "seed": int(seed), "dtype": dtype})
    return out


# ---------------------------------------------------------------------------
# The vision layers: the resizes, 3-D pooling and convolution, the adaptive
# pools, the layout ops, grid sampling, the deformable convolution and the
# sampling layers, each building the JAX package's program.
# ---------------------------------------------------------------------------


def _n_list(v, n):
    """A scalar or a list as an n-entry list attr (a list passes as is)."""
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1):
    """Bilinear resize to out_shape (or by scale); the reference's default
    align_corners=True."""
    oh, ow = (out_shape or (0, 0))
    return _simple_op("bilinear_interp", {"X": [input]},
                      {"out_h": oh, "out_w": ow, "scale": scale or 0.0,
                       "align_corners": align_corners,
                       "align_mode": align_mode})


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True):
    """Nearest resize; with the default align_corners=True the source of
    output d is floor(d*(in-1)/(out-1) + 0.5), not a repeat."""
    oh, ow = (out_shape or (0, 0))
    return _simple_op("nearest_interp", {"X": [input]},
                      {"out_h": oh, "out_w": ow, "scale": scale or 0.0,
                       "align_corners": align_corners})


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None,
                 align_corners=True, align_mode=1):
    if resample.upper() == "NEAREST":
        return resize_nearest(input, out_shape, scale, name,
                              align_corners=align_corners)
    return resize_bilinear(input, out_shape, scale, name,
                           align_corners=align_corners,
                           align_mode=align_mode)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     actual_shape=None, align_corners=True, align_mode=1):
    helper = LayerHelper("trilinear_interp", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    od, oh, ow = (out_shape or (0, 0, 0))
    helper.append_op("trilinear_interp", {"X": [input]}, {"Out": [out]},
                     {"out_d": od, "out_h": oh, "out_w": ow,
                      "scale": scale or 0.0,
                      "align_corners": bool(align_corners),
                      "align_mode": int(align_mode)})
    return out


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Scale so the short side is out_short_len (H and W known at build
    time)."""
    H, W = input.shape[2], input.shape[3]
    short = min(H, W)
    out_shape = [int(round(H * out_short_len / short)),
                 int(round(W * out_short_len / short))]
    return image_resize(input, out_shape=out_shape, resample=resample)


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    return _simple_op("adaptive_pool2d", {"X": [input]},
                      {"pooled_size": list(pool_size),
                       "pooling_type": pool_type})


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    return _simple_op("adaptive_pool3d", {"X": [input]},
                      {"pooled_size": list(pool_size),
                       "pooling_type": pool_type})


def pool3d(input, pool_size=2, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, name=None, **kw):
    return _simple_op("pool3d", {"X": [input]},
                      {"ksize": _n_list(pool_size, 3),
                       "pooling_type": pool_type,
                       "strides": _n_list(pool_stride, 3),
                       "paddings": _n_list(pool_padding, 3),
                       "global_pooling": global_pooling})


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, name=None, act=None,
           **kw):
    helper = LayerHelper("conv3d", name=name)
    C = input.shape[1]
    w = helper.create_parameter(
        attr=param_attr, shape=[num_filters, C // groups]
        + _n_list(filter_size, 3), dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d", {"Input": [input], "Filter": [w]},
                     {"Output": [out]},
                     {"strides": _n_list(stride, 3),
                      "paddings": _n_list(padding, 3),
                      "dilations": _n_list(dilation, 3), "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(attr=bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [b]},
                         {"Out": [out2]}, {"axis": 1})
        out = out2
    return helper.append_activation(out, act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv3d_transpose", name=name)
    dtype = input.dtype
    C = input.shape[1]
    if filter_size is None:
        raise ValueError("conv3d_transpose: filter_size is required "
                         "(output_size-derived filters need dynamic shapes)")
    w = helper.create_parameter(
        param_attr, [C, num_filters // groups] + _n_list(filter_size, 3),
        dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv3d_transpose", {"Input": [input], "Filter": [w]},
        {"Output": [out]},
        {"strides": _n_list(stride, 3), "paddings": _n_list(padding, 3),
         "dilations": _n_list(dilation, 3), "groups": int(groups)})
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, [num_filters], dtype,
                                       is_bias=True)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [bias]},
                         {"Out": [tmp]}, {"axis": 1})
        out = tmp
    return helper.append_activation(out, act)


def pixel_shuffle(x, upscale_factor):
    return _simple_op("pixel_shuffle", {"X": [x]},
                      {"upscale_factor": upscale_factor})


def shuffle_channel(x, group, name=None):
    return _simple_op("shuffle_channel", {"X": [x]}, {"group": group})


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _simple_op("temporal_shift", {"X": [x]},
                      {"seg_num": seg_num, "shift_ratio": shift_ratio})


def maxout(x, groups, name=None):
    return _simple_op("maxout", {"X": [x]}, {"groups": groups})


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn")
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("lrn", {"X": [input]},
                     {"Out": [out], "MidOut": [mid]},
                     {"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    out = _simple_op("affine_channel",
                     {"X": [x], "Scale": [scale], "Bias": [bias]})
    return _simple_op(act, {"X": [out]}) if act else out


def multiplex(inputs, index):
    return _simple_op("multiplex", {"X": list(inputs), "Ids": [index]},
                      dtype=inputs[0].dtype)


def crop(x, shape=None, offsets=None, name=None):
    return _simple_op("crop", {"X": [x]},
                      {"shape": list(shape),
                       "offsets": list(offsets or [0] * len(shape))})


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _simple_op("pad_constant_like", {"X": [x], "Y": [y]},
                      {"pad_value": pad_value}, dtype=y.dtype)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return _simple_op("unfold", {"X": [x]},
                      {"kernel_sizes": _two(kernel_sizes),
                       "strides": _two(strides),
                       "paddings": _two(paddings),
                       "dilations": _two(dilations)}, out_slot="Y")


def grid_sampler(x, grid, name=None):
    return _simple_op("grid_sampler", {"X": [x], "Grid": [grid]},
                      out_slot="Output")


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", name=name)
    w = helper.create_parameter(
        attr=param_attr, shape=[size, x.shape[-1], y.shape[-1]],
        dtype=x.dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        b = helper.create_parameter(attr=bias_attr, shape=[1, size],
                                    dtype=x.dtype, is_bias=True)
        inputs["Bias"] = [b]
    out = _simple_op("bilinear_tensor_product", inputs)
    return _simple_op(act, {"X": [out]}) if act else out


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _simple_op("shard_index", {"X": [input]},
                      {"index_num": index_num, "nshards": nshards,
                       "shard_id": shard_id, "ignore_value": ignore_value})


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    return _simple_op("sampling_id", {"X": [x]}, dtype="int64")


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None,
              rois_batch_id=None):
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_id is not None:
        inputs["RoisBatchId"] = [rois_batch_id]
    return _simple_op("roi_align", inputs,
                      {"pooled_height": pooled_height,
                       "pooled_width": pooled_width,
                       "spatial_scale": spatial_scale,
                       "sampling_ratio": sampling_ratio})


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch_id=None):
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_id is not None:
        inputs["RoisBatchId"] = [rois_batch_id]
    return _simple_op("roi_pool", inputs,
                      {"pooled_height": pooled_height,
                       "pooled_width": pooled_width,
                       "spatial_scale": spatial_scale})


def affine_grid(theta, out_shape, name=None):
    helper = LayerHelper("affine_grid", name=name)
    out = helper.create_variable_for_type_inference(theta.dtype)
    if hasattr(out_shape, "name"):
        raise NotImplementedError(
            "affine_grid: out_shape must be a static list")
    helper.append_op("affine_grid", {"Theta": [theta]}, {"Output": [out]},
                     {"output_shape": [int(s) for s in out_shape]})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    """Sliding-window im2col: [B, n_windows, C*kh*kw] (the batch axis kept).
    input_image_size / out_stride (per-image real-size windows) raise."""
    if input_image_size is not None or _two(out_stride) != [1, 1]:
        raise NotImplementedError(
            "im2sequence: input_image_size/out_stride (per-image real-size "
            "windows) are not supported on the padded design")
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    pad = _n_list(padding, 4)
    if len(pad) == 2:
        pad = pad * 2
    helper.append_op("im2sequence", {"X": [input]}, {"Out": [out]},
                     {"kernels": _two(filter_size),
                      "strides": _two(stride), "paddings": pad})
    return out


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("random_crop", {"X": [x]}, {"Out": [out]},
                     {"shape": [int(s) for s in shape],
                      "seed": int(seed) if seed is not None else -1})
    return out


def deformable_conv(input, offset, mask, num_filters, filter_size, stride=1,
                    padding=0, dilation=1, groups=1, deformable_groups=1,
                    im2col_step=1, param_attr=None, bias_attr=None,
                    modulated=True, name=None):
    helper = LayerHelper("deformable_conv", name=name)
    dtype = input.dtype
    C = input.shape[1]
    w = helper.create_parameter(
        param_attr, [num_filters, C // groups] + _two(filter_size), dtype)
    out = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "Offset": [offset], "Filter": [w]}
    if mask is not None:
        ins["Mask"] = [mask]
    helper.append_op(
        "deformable_conv", ins, {"Output": [out]},
        {"strides": _two(stride), "paddings": _two(padding),
         "dilations": _two(dilation), "groups": int(groups),
         "deformable_groups": int(deformable_groups),
         "im2col_step": int(im2col_step)})
    if bias_attr:
        bias = helper.create_parameter(bias_attr, [num_filters], dtype,
                                       is_bias=True)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [bias]},
                         {"Out": [tmp]}, {"axis": 1})
        out = tmp
    return out


# ---------------------------------------------------------------------------
# The crf and ctc layers (ops in crf_ops / ctc_ops)
# ---------------------------------------------------------------------------


def linear_chain_crf(input, label, param_attr=None, length=None):
    """Linear-chain CRF negative log-likelihood [B, 1]: `input` [B, T, N]
    emissions; the transition parameter is [N+2, N] (start and stop rows,
    then N x N)."""
    helper = LayerHelper("linear_chain_crf")
    n = input.shape[-1]
    w = helper.create_parameter(attr=param_attr, shape=[n + 2, n],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Emission": [input], "Transition": [w], "Label": [label]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op("linear_chain_crf", inputs, {"LogLikelihood": [out]}, {})
    return out


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode with the trained transition `param_attr` names; with
    `label`, the per-position mismatch indicator instead of the path."""
    helper = LayerHelper("crf_decoding")
    w = helper.main_program.current_block().var(
        param_attr.name if hasattr(param_attr, "name") else str(param_attr))
    out = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": [input], "Transition": [w]}
    if label is not None:
        inputs["Label"] = [label]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op("crf_decoding", inputs, {"ViterbiPath": [out]}, {})
    return out


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    """CTC loss [B, 1] on padded batches: input [B, T, V] raw logits, label
    [B, S]; the lengths default to the padded extents."""
    helper = LayerHelper("warpctc")
    inputs = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        inputs["LogitsLength"] = [input_length]
    if label_length is not None:
        inputs["LabelLength"] = [label_length]
    loss = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("warpctc", inputs, {"Loss": [loss]},
                     {"blank": int(blank), "norm_by_times": norm_by_times})
    return loss


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance on padded int sequences: (distance [B, 1]
    float32, sequence_num [1]). `ignored_tokens` are erased from both
    sides first (sequence_erase)."""
    helper = LayerHelper("edit_distance")

    def erase(x, length):
        out = helper.create_variable_for_type_inference("int64")
        out_len = helper.create_variable_for_type_inference("int64")
        ins = {"X": [x]}
        if length is not None:
            ins["Length"] = [length]
        helper.append_op("sequence_erase", ins,
                         {"Out": [out], "OutLength": [out_len]},
                         {"tokens": list(ignored_tokens)})
        return out, out_len

    if ignored_tokens:
        input, input_length = erase(input, input_length)
        label, label_length = erase(label, label_length)
    dist = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    ins = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        ins["HypsLength"] = [input_length]
    if label_length is not None:
        ins["RefsLength"] = [label_length]
    helper.append_op("edit_distance", ins,
                     {"Out": [dist], "SequenceNum": [seq_num]},
                     {"normalized": bool(normalized)})
    return dist, seq_num


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=-1,
                       name=None):
    """argmax, then merge repeats and drop blanks (ctc_align): input [B, T,
    V] probabilities; returns the decode [B, T] padded with
    `padding_value` (and its lengths when `input_length` is given)."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    am = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op("arg_max", {"X": [input]}, {"Out": [am]}, {"axis": -1})
    out = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    out_len = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    ins = {"Input": [am]}
    if input_length is not None:
        ins["InputLength"] = [input_length]
    helper.append_op("ctc_align", ins,
                     {"Output": [out], "OutputLength": [out_len]},
                     {"blank": int(blank), "padding_value": int(padding_value)})
    if input_length is None:
        return out
    return out, out_len


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunking precision, recall, F1 and the three chunk counts (a host
    op, so its outputs carry no inferred shapes)."""
    helper = LayerHelper("chunk_eval")
    precision, recall, f1 = (helper.create_variable_for_type_inference(
        "float32") for _ in range(3))
    n_infer, n_label, n_correct = (helper.create_variable_for_type_inference(
        "int64") for _ in range(3))
    ins = {"Inference": [input], "Label": [label]}
    if seq_length is not None:
        ins["SeqLength"] = [seq_length]
    helper.append_op(
        "chunk_eval", ins,
        {"Precision": [precision], "Recall": [recall], "F1-Score": [f1],
         "NumInferChunks": [n_infer], "NumLabelChunks": [n_label],
         "NumCorrectChunks": [n_correct]},
        {"chunk_scheme": chunk_scheme,
         "num_chunk_types": int(num_chunk_types),
         "excluded_chunk_types": list(excluded_chunk_types or [])})
    return precision, recall, f1, n_infer, n_label, n_correct
