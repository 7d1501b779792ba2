"""Layers DSL: each function appends ops to the default main program."""
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .tensor import data, fill_constant

__all__ = ["data", "fill_constant"] + list(_nn_all)
