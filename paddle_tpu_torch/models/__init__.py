"""Model builders of the port (the JAX package's models/)."""
from . import resnet, transformer  # noqa: F401
