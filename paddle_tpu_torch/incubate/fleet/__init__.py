from .base import (  # noqa: F401
    CollectiveOptimizer,
    DistributedStrategy,
    Fleet,
    PaddleCloudRoleMaker,
    Role,
    UserDefinedRoleMaker,
    fleet,
)
from . import parameter_server  # noqa: F401
