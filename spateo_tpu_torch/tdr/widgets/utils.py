"""Reference-named module alias (reference tdr/widgets/utils.py)."""

from .ops import _subset  # noqa: F401
