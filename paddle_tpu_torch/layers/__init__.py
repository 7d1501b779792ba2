"""Layers DSL: each function appends ops to the default main program."""
from . import control_flow, learning_rate_scheduler  # noqa: F401
from .control_flow import less_than
from .learning_rate_scheduler import *  # noqa: F401,F403
from .learning_rate_scheduler import __all__ as _lr_all
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .tensor import data, fill_constant

__all__ = (["data", "fill_constant", "less_than"] + list(_nn_all)
           + list(_lr_all))
