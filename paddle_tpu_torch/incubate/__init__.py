"""Incubating APIs: the fleet (collective mode)."""
from . import fleet  # noqa: F401
