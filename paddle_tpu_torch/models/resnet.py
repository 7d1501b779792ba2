"""ResNet image classification (the JAX package's models/resnet.py, over
the port's layers): depths 18-152, the CIFAR-10 net, NCHW or NHWC, and the
space-to-depth stem with `fold_stem_to_s2d` to carry 7x7 stem weights onto
it. These functions append the same ops with the same names as the JAX
package's, so the two packages' programs are equal through `to_dict()`.
"""
from __future__ import annotations

from .. import layers as L

__all__ = ["resnet", "resnet50", "resnet18", "resnet_cifar10",
           "fold_stem_to_s2d"]

_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _conv_bn(x, ch, k, stride=1, act=None, name=None, fmt="NCHW"):
    y = L.conv2d(x, num_filters=ch, filter_size=k, stride=stride,
                 padding=(k - 1) // 2, bias_attr=False, name=name,
                 data_format=fmt)
    return L.batch_norm(y, act=act, name=(name + ".bn") if name else None,
                        data_layout=fmt)


def _shortcut(x, ch_out, stride, name, fmt):
    cax = 1 if fmt == "NCHW" else -1
    if x.shape[cax] != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride, name=name + ".sc", fmt=fmt)
    return x


def _basic_block(x, ch, stride, name, fmt):
    y = _conv_bn(x, ch, 3, stride, act="relu", name=name + ".c1", fmt=fmt)
    y = _conv_bn(y, ch, 3, 1, name=name + ".c2", fmt=fmt)
    s = _shortcut(x, ch, stride, name, fmt)
    return L.relu(L.elementwise_add(y, s))


def _bottleneck_block(x, ch, stride, name, fmt):
    y = _conv_bn(x, ch, 1, 1, act="relu", name=name + ".c1", fmt=fmt)
    y = _conv_bn(y, ch, 3, stride, act="relu", name=name + ".c2", fmt=fmt)
    y = _conv_bn(y, ch * 4, 1, 1, name=name + ".c3", fmt=fmt)
    s = _shortcut(x, ch * 4, stride, name, fmt)
    return L.relu(L.elementwise_add(y, s))


def fold_stem_to_s2d(w7, data_format="NCHW"):
    """Convert a trained 7x7-s2 stem weight [64, 3, 7, 7] (OIHW) into the
    exactly equivalent 4x4-s1 kernel for the space-to-depth stem
    (s2d_stem=True): pad the 7-tap kernel to 8 at the FRONT of each
    spatial dim, then repack taps into (phase_h, phase_w, c) input channels
    to match the space_to_depth op's channel order (ops/vision_ops.py).
    Derivation: y[o] = sum_u w[u] x[2o-3+u]; n = 2(o+j)+p gives 2j+p = u-3,
    j in [-2,1] -> 4 taps with spatial padding (2, 1).

    data_format: layout of the TARGET model's stem parameter — "NCHW"
    returns OIHW [64, 12, 4, 4]; "NHWC" returns HWIO [4, 4, 12, 64] (NHWC
    conv2d layers allocate weights HWIO, layers/nn.py)."""
    import numpy as np
    w7 = np.asarray(w7)
    o, ci, _, _ = w7.shape
    w8 = np.zeros((o, ci, 8, 8), w7.dtype)
    w8[:, :, 1:, 1:] = w7
    w8 = w8.reshape(o, ci, 4, 2, 4, 2)          # (O, c, th, ph, tw, pw)
    w8 = w8.transpose(0, 3, 5, 1, 2, 4)         # (O, ph, pw, c, th, tw)
    w4 = w8.reshape(o, 4 * ci, 4, 4)
    if data_format == "NHWC":
        return np.ascontiguousarray(w4.transpose(2, 3, 1, 0))  # -> HWIO
    return w4


def resnet(img, depth=50, num_classes=1000, s2d_stem=False,
           data_format="NCHW"):
    """Build the trunk + logits head. img: [N,3,H,W] (NCHW) or [N,H,W,3]
    (NHWC).

    s2d_stem: repack the input 2x2 space-to-depth (3->12 channels, HW/2)
    and run the stem as a 4x4-s1 conv, widening the stem's 3-channel
    contraction to 12. Same function class (fold_stem_to_s2d maps 7x7
    weights onto it exactly).

    data_format: "NHWC" keeps the whole activation chain channels-last."""
    kind, layers_per_stage = _DEPTH_CFG[depth]
    fmt = data_format
    block = _basic_block if kind == "basic" else _bottleneck_block
    if s2d_stem:
        if fmt == "NCHW":
            x = L.space_to_depth(img, blocksize=2)
        else:
            # NHWC space-to-depth via reshape+transpose; channel order
            # (ph, pw, c) matches fold_stem_to_s2d and the NCHW op.
            n, h, w, c = img.shape
            x = L.reshape(img, [n, h // 2, 2, w // 2, 2, c])
            x = L.transpose(x, [0, 1, 3, 2, 4, 5])
            x = L.reshape(x, [n, h // 2, w // 2, 4 * c])
        # asymmetric (2, 1) padding is an attr of the conv, not a pad op,
        # as in the JAX package's program
        x = L.conv2d(x, num_filters=64, filter_size=4, stride=1,
                     padding=[2, 1, 2, 1], bias_attr=False, name="stem",
                     data_format=fmt)
        x = L.batch_norm(x, act="relu", name="stem.bn", data_layout=fmt)
    else:
        x = _conv_bn(img, 64, 7, stride=2, act="relu", name="stem", fmt=fmt)
    x = L.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                 pool_padding=1, data_format=fmt)
    for stage, n in enumerate(layers_per_stage):
        ch = 64 * (2 ** stage)
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            x = block(x, ch, stride, f"res{stage}.{i}", fmt)
    x = L.pool2d(x, pool_type="avg", global_pooling=True, data_format=fmt)
    return L.fc(x, size=num_classes)


def resnet50(img=None, label=None, num_classes=1000, class_dim=None,
             s2d_stem=False, data_format="NCHW"):
    if class_dim is not None:
        num_classes = class_dim
    if img is None:
        shape = [3, 224, 224] if data_format == "NCHW" else [224, 224, 3]
        img = L.data(name="img", shape=shape, dtype="float32")
    if label is None:
        label = L.data(name="label", shape=[1], dtype="int64")
    logits = resnet(img, depth=50, num_classes=num_classes,
                    s2d_stem=s2d_stem, data_format=data_format)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    acc = L.accuracy(logits, label)
    return loss, acc, logits


def resnet18(img=None, label=None, num_classes=1000):
    if img is None:
        img = L.data(name="img", shape=[3, 224, 224], dtype="float32")
    if label is None:
        label = L.data(name="label", shape=[1], dtype="int64")
    logits = resnet(img, depth=18, num_classes=num_classes)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    acc = L.accuracy(logits, label)
    return loss, acc, logits


def resnet_cifar10(img=None, label=None, num_classes=10):
    """Small 3-stage ResNet for 32x32 inputs (book image_classification)."""
    if img is None:
        img = L.data(name="img", shape=[3, 32, 32], dtype="float32")
    if label is None:
        label = L.data(name="label", shape=[1], dtype="int64")
    x = _conv_bn(img, 16, 3, act="relu", name="stem")
    for stage in range(3):
        ch = 16 * (2 ** stage)
        for i in range(3):
            stride = 2 if (i == 0 and stage > 0) else 1
            x = _basic_block(x, ch, stride, f"res{stage}.{i}", "NCHW")
    x = L.pool2d(x, pool_type="avg", global_pooling=True)
    logits = L.fc(x, size=num_classes)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    acc = L.accuracy(logits, label)
    return loss, acc, logits
