"""Op computes of the port. Importing this package registers every op."""
from . import (activation_ops, attention_ops, math_ops, nn_ops,  # noqa: F401
               optimizer_ops, tensor_ops, vision_ops)
from .registry import get_op_def, register_op  # noqa: F401
