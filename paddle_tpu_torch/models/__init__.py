"""Model builders of the port (the JAX package's models/)."""
from . import mlp, resnet, seq2seq, transformer  # noqa: F401
