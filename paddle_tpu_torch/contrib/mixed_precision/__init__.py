"""bf16 automatic mixed precision: program rewriting, op lists and the
optimizer decorator (the JAX package's contrib/mixed_precision)."""
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from .fp16_utils import rewrite_program  # noqa: F401
