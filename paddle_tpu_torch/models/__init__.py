"""Model builders of the port (the JAX package's models/)."""
from . import deepfm, mlp, resnet, seq2seq, transformer, word2vec  # noqa: F401
