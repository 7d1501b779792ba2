"""DeepFM CTR model (the JAX package's models/deepfm.py; BASELINE.json
config 5): a factorization machine and a deep tower over sparse slot
features hashed into one shared vocabulary, plus dense features.

Feeds: `sparse_ids` [B, n_fields] int64, `dense_x` [B, n_dense] float,
`label` [B, 1] float. The port trains it dense (`is_sparse=False`: the
embedding tables' gradients are dense scatter-adds); with the default
is_sparse=True the embedding grads raise, because SelectedRows gradients
are not ported (ROADMAP Queue 1, the data pipeline, DeepFM's sparse path
and tiered embeddings).
"""
from __future__ import annotations

from .. import layers as L
from ..param_attr import ParamAttr

__all__ = ["deepfm"]


def deepfm(
    n_fields: int = 26,
    n_dense: int = 13,
    vocab_size: int = 100_000,
    embed_dim: int = 16,
    hidden_sizes=(400, 400, 400),
    is_sparse: bool = True,
):
    """Build DeepFM; returns (avg_loss, predict, feed_names)."""
    sparse_ids = L.data(name="sparse_ids", shape=[n_fields], dtype="int64")
    dense_x = L.data(name="dense_x", shape=[n_dense], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="float32")

    # FM first order: one scalar weight a feature
    w1 = L.embedding(
        sparse_ids, size=[vocab_size, 1], is_sparse=is_sparse,
        param_attr=ParamAttr(name="fm_w1"))           # [B, F, 1]
    first_sparse = L.reduce_sum(w1, dim=1)             # [B, 1]
    first_dense = L.fc(dense_x, size=1, bias_attr=False,
                       param_attr=ParamAttr(name="fm_dense_w"))
    first_order = first_sparse + first_dense

    # FM second order: 0.5 ((sum v)^2 - sum v^2)
    emb = L.embedding(
        sparse_ids, size=[vocab_size, embed_dim], is_sparse=is_sparse,
        param_attr=ParamAttr(name="fm_emb"))           # [B, F, D]
    sum_v = L.reduce_sum(emb, dim=1)                   # [B, D]
    sum_sq = L.elementwise_mul(sum_v, sum_v)
    sq = L.elementwise_mul(emb, emb)
    sq_sum = L.reduce_sum(sq, dim=1)
    second_order = L.scale(
        L.reduce_sum(sum_sq - sq_sum, dim=1, keep_dim=True), 0.5)  # [B, 1]

    # the deep tower over the flattened embeddings and the dense features
    deep = L.concat(
        [L.reshape(emb, [-1, n_fields * embed_dim]), dense_x], axis=1)
    for i, h in enumerate(hidden_sizes):
        deep = L.fc(deep, size=h, act="relu",
                    param_attr=ParamAttr(name=f"deep_w{i}"),
                    bias_attr=ParamAttr(name=f"deep_b{i}"))
    deep_out = L.fc(deep, size=1, param_attr=ParamAttr(name="deep_out_w"))

    logit = first_order + second_order + deep_out
    predict = L.sigmoid(logit)
    loss = L.sigmoid_cross_entropy_with_logits(logit, label)
    avg_loss = L.mean(loss)
    return avg_loss, predict, ["sparse_ids", "dense_x", "label"]
