"""Contributed extensions, as in the JAX package's contrib/: mixed
precision (`contrib.mixed_precision.decorate`) and the model-compression
toolkit (`contrib.slim`)."""
from . import mixed_precision  # noqa: F401
from . import slim  # noqa: F401
