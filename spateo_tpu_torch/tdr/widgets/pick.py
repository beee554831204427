"""Reference-named module alias (reference tdr/widgets/pick.py)."""

from .interactive import InteractiveLassoPick, interactive_pick  # noqa: F401
from .ops import overlap_mesh_pick, overlap_pc_pick, overlap_pick, pick_models, three_d_pick  # noqa: F401
