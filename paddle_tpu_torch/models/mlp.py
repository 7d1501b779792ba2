"""MNIST MLP and convnet, the Fluid book's recognize_digits models (the JAX
package's models/mlp.py)."""
from __future__ import annotations

from .. import layers as L

__all__ = ["mnist_mlp", "mnist_conv"]


def mnist_mlp(img=None, label=None, hidden_sizes=(128, 64), num_classes=10):
    """Softmax-regression MLP; returns (avg_loss, accuracy, logits)."""
    if img is None:
        img = L.data(name="img", shape=[784], dtype="float32")
    if label is None:
        label = L.data(name="label", shape=[1], dtype="int64")
    h = img
    for size in hidden_sizes:
        h = L.fc(h, size=size, act="relu")
    logits = L.fc(h, size=num_classes)
    loss = L.softmax_with_cross_entropy(logits, label)
    avg_loss = L.mean(loss)
    acc = L.accuracy(logits, label)
    return avg_loss, acc, logits


def mnist_conv(img=None, label=None, num_classes=10):
    """LeNet-ish conv net (the book's `conv` variant)."""
    from ..nets import simple_img_conv_pool

    if img is None:
        img = L.data(name="img", shape=[1, 28, 28], dtype="float32")
    if label is None:
        label = L.data(name="label", shape=[1], dtype="int64")
    c1 = simple_img_conv_pool(img, filter_size=5, num_filters=20, pool_size=2,
                              pool_stride=2, act="relu")
    c2 = simple_img_conv_pool(c1, filter_size=5, num_filters=50, pool_size=2,
                              pool_stride=2, act="relu")
    logits = L.fc(c2, size=num_classes)
    loss = L.softmax_with_cross_entropy(logits, label)
    avg_loss = L.mean(loss)
    acc = L.accuracy(logits, label)
    return avg_loss, acc, logits
