"""Layers DSL: each function appends ops to the default main program."""
from . import (control_flow, detection, distributions,  # noqa: F401
               learning_rate_scheduler, nn, sequence, tensor)
from .control_flow import *  # noqa: F401,F403
from .control_flow import __all__ as _cf_all
from .detection import *  # noqa: F401,F403
from .detection import __all__ as _det_all
from .learning_rate_scheduler import *  # noqa: F401,F403
from .learning_rate_scheduler import __all__ as _lr_all
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .sequence import *  # noqa: F401,F403
from .sequence import __all__ as _seq_all
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_all

__all__ = (list(_tensor_all) + list(_nn_all) + list(_cf_all) + list(_seq_all)
           + list(_lr_all) + list(_det_all) + ["distributions", "detection"])
