"""Contributed extensions, as in the JAX package's contrib/: mixed
precision (`contrib.mixed_precision.decorate`). `slim` is not ported
(ROADMAP Queue 1, the rest)."""
from . import mixed_precision  # noqa: F401
