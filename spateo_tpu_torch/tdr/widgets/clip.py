"""Reference-named module alias (reference tdr/widgets/clip.py) — clip
operations live in `ops` (pure functions) and `interactive` (widget loops)."""

from .interactive import InteractiveRectangleClip, interactive_rectangle_clip  # noqa: F401
from .ops import clip_models, interactive_box_clip  # noqa: F401
