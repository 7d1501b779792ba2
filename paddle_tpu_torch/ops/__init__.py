"""Op computes of the port. Importing this package registers every op."""
from . import (activation_ops, attention_ops, collective_ops,  # noqa: F401
               control_flow_ops, crf_ops, ctc_ops, detection_ops, math_ops, nn_ops, optimizer_ops,
               quant_ops, rnn_ops, sampling_ops, sequence_ops, tensor_ops,
               vision_ops)
from .registry import get_op_def, register_op  # noqa: F401
