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
    """Gray-list membership as a tunable decision (FLAGS_tuning_mode): an
    op the hand lists leave gray ("follow your inputs") can be promoted to
    white (bf16 boundaries) or demoted to black (fp32 boundaries) by a
    swept-DB entry, per device kind. Only ops still gray are touched, so a
    user's custom_white_list/custom_black_list moves always win; the
    analytic prior is "stay gray", so with no DB entry the lists are the
    hand lists (the JAX package's fp16_lists.py:64)."""
    from ... import tuning

    if tuning.mode() == "off":
        return lists
    for op in sorted(lists.gray_list):
        key = tuning.canonical_key("amp_list", tuning.amp_key(op), "-",
                                   tuning.device_kind())
        decision, _tier = tuning.decide(
            "amp_list", key,
            prior=lambda: {"list": "gray"},
            default={"list": "gray"},
            validate=lambda dd: dd.get("list") in ("white", "black", "gray"))
        target = decision.get("list", "gray")
        if target != "gray":
            lists.gray_list.discard(op)
            (lists.white_list if target == "white"
             else lists.black_list).add(op)
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
