"""N-gram word embedding model, the Fluid book's word2vec chapter (the JAX
package's models/word2vec.py): a 4-gram context through one shared
embedding table, a sigmoid hidden layer, a softmax over the dictionary and
the cross entropy of its probabilities. With is_sparse=True the four
lookups of the shared table give four SelectedRows gradients, which
backward's `sum` concatenates into one."""
from __future__ import annotations

from .. import layers as L
from ..param_attr import ParamAttr

__all__ = ["word2vec"]


def word2vec(dict_size: int = 2000, embed_dim: int = 32,
             hidden_size: int = 256, context: int = 4,
             is_sparse: bool = False):
    """Returns (avg_loss, predict, feed_names). Feeds: context word id slots
    `w0..w{context-1}` [B, 1] int64 and `next_word` [B, 1] int64."""
    embeds = []
    feeds = []
    for i in range(context):
        w = L.data(name=f"w{i}", shape=[1], dtype="int64")
        feeds.append(w.name)
        embeds.append(L.embedding(
            w, size=[dict_size, embed_dim], is_sparse=is_sparse,
            param_attr=ParamAttr(name="shared_w")))  # one shared table
    concat = L.concat([L.reshape(e, [-1, embed_dim]) for e in embeds], axis=1)
    hidden = L.fc(concat, size=hidden_size, act="sigmoid")
    predict = L.fc(hidden, size=dict_size, act="softmax")
    next_word = L.data(name="next_word", shape=[1], dtype="int64")
    feeds.append(next_word.name)
    cost = L.cross_entropy(predict, next_word)
    avg_loss = L.mean(cost)
    return avg_loss, predict, feeds
