from .post_training_quantization import PostTrainingQuantization  # noqa: F401
from .quantization_pass import (  # noqa: F401
    ConvertToInt8Pass,
    QuantizationFreezePass,
    QuantizationTransformPass,
)
