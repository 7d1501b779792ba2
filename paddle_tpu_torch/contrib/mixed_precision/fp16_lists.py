"""Op lists steering automatic mixed precision (the JAX package's
contrib/mixed_precision/fp16_lists.py, whole).

White ops are the matrix-unit carriers (matmul, conv, attention) that run
in bfloat16; black ops are numerically sensitive reductions and
exponentials kept in float32; everything else (gray) follows its inputs.
The split is the JAX package's, so both packages rewrite a program to the
same ops and dtypes."""
from __future__ import annotations

__all__ = ["AutoMixedPrecisionLists", "white_list", "black_list", "gray_list",
           "apply_tuning_overrides"]

white_list = {
    "mul",
    "matmul",
    "conv2d",
    "depthwise_conv2d",
    "conv2d_transpose",
    # tensor-core carrier with fp32 softmax statistics inside the kernel
    "fused_attention",
}

black_list = {
    "exp",
    "square",
    "log",
    "mean",
    "sum",
    "cos_sim",
    "log_softmax",
    "sigmoid_cross_entropy_with_logits",
    "cross_entropy",
    "reduce_sum",
    "reduce_mean",
    "squared_l2_norm",
}

# layer_norm, softmax and batch_norm are gray: their kernels keep the
# statistics in fp32 registers inside (K3/K5, K6/K7, K8/K9), so fp32 at the
# op boundary would only add casts of activation size
gray_list = {
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "relu", "gelu", "tanh", "sigmoid", "leaky_relu", "dropout", "pool2d",
    "transpose2", "reshape2", "concat", "split", "slice", "squeeze2",
    "unsqueeze2", "stack", "scale", "lookup_table", "lookup_table_v2",
    "layer_norm", "softmax", "softmax_mask_fuse_upper_triangle",
    "batch_norm",
    # fused conv + batch norm (passes.fuse_conv_bn_stats) post-dates the
    # rewrite, but a program fused by hand follows the batch_norm rule
    "conv2d_bn",
    "softmax_with_cross_entropy",
}


def apply_tuning_overrides(lists: "AutoMixedPrecisionLists"):
    """The lists unchanged. In the JAX package a swept tuning database may
    move gray ops to white or black; `tuning/` is not ported (ROADMAP Queue
    1, the rest), and with the tuner off (its default mode "off") the JAX
    function returns the lists unchanged too."""
    return lists


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        if custom_white_list and custom_black_list:
            both = set(custom_white_list) & set(custom_black_list)
            if both:
                raise ValueError(f"ops in both custom lists: {both}")
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        if custom_white_list:
            for t in custom_white_list:
                self.white_list.add(t)
                self.black_list.discard(t)
        if custom_black_list:
            for t in custom_black_list:
                self.black_list.add(t)
                self.white_list.discard(t)
