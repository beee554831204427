"""Reference-named module alias (reference tdr/widgets/slice.py)."""

from .interactive import InteractiveSlicer, interactive_slice  # noqa: F401
from .ops import slice_models, three_d_slice  # noqa: F401
