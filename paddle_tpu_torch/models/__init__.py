"""Model builders of the port (the JAX package's models/)."""
from . import transformer  # noqa: F401
