"""The model-compression toolkit (the JAX package's contrib/slim, after the
reference's python/paddle/fluid/contrib/slim): quantization (QAT, PTQ,
freeze, int8), magnitude pruning, distillation losses and the Light-NAS
annealing controller. The passes and the pruner take the scope explicitly:
the port has no global scope."""
from . import distillation  # noqa: F401
from . import nas  # noqa: F401
from . import prune  # noqa: F401
from . import quantization  # noqa: F401
