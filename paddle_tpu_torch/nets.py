"""Composite network helpers (the JAX package's nets.py):
simple_img_conv_pool, img_conv_group, glu, scaled_dot_product_attention."""
from __future__ import annotations

from . import layers as L

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention"]


def simple_img_conv_pool(
    input, num_filters, filter_size, pool_size, pool_stride,
    pool_padding=0, pool_type="max", global_pooling=False,
    conv_stride=1, conv_padding=0, conv_dilation=1, conv_groups=1,
    param_attr=None, bias_attr=None, act=None,
):
    conv_out = L.conv2d(
        input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr, act=act,
    )
    return L.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                    pool_stride=pool_stride, pool_padding=pool_padding,
                    global_pooling=global_pooling)


def img_conv_group(
    input, conv_num_filter, pool_size, conv_padding=1, conv_filter_size=3,
    conv_act=None, param_attr=None, conv_with_batchnorm=False,
    conv_batchnorm_drop_rate=0.0, pool_stride=1, pool_type="max",
):
    tmp = input
    n = len(conv_num_filter)

    def _bcast(v):
        return v if isinstance(v, (list, tuple)) else [v] * n

    paddings, fsizes, attrs = _bcast(conv_padding), _bcast(conv_filter_size), _bcast(param_attr)
    with_bn, drops = _bcast(conv_with_batchnorm), _bcast(conv_batchnorm_drop_rate)
    for i in range(n):
        act = conv_act if not with_bn[i] else None
        tmp = L.conv2d(tmp, num_filters=conv_num_filter[i], filter_size=fsizes[i],
                       padding=paddings[i], param_attr=attrs[i], act=act)
        if with_bn[i]:
            tmp = L.batch_norm(tmp, act=conv_act)
            if drops[i] > 0:
                tmp = L.dropout(tmp, dropout_prob=drops[i])
    return L.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                    pool_stride=pool_stride)


def glu(input, dim=-1):
    """Gated linear unit: split in half on `dim`, a * sigmoid(b)."""
    a, b = L.split(input, num_or_sections=2, dim=dim)
    return L.elementwise_mul(a, L.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [B, S, H] tensors.
    Returns [B, Sq, H_v]."""
    dh = queries.shape[-1] // num_heads
    sq, sk = queries.shape[-2], keys.shape[-2]

    def _split_heads(x, s):
        if num_heads == 1:
            return x
        x = L.reshape(x, shape=[0, s, num_heads, x.shape[-1] // num_heads])
        return L.transpose(x, perm=[0, 2, 1, 3])

    q = _split_heads(queries, sq)
    k = _split_heads(keys, sk)
    v = _split_heads(values, sk)
    scores = L.matmul(q, k, transpose_y=True, alpha=float(dh) ** -0.5)
    weights = L.softmax(scores)
    if dropout_rate:
        weights = L.dropout(weights, dropout_prob=dropout_rate,
                            dropout_implementation="upscale_in_train")
    ctx = L.matmul(weights, v)
    if num_heads == 1:
        return ctx
    ctx = L.transpose(ctx, perm=[0, 2, 1, 3])
    return L.reshape(ctx, shape=[0, sq, ctx.shape[-2] * ctx.shape[-1]])
