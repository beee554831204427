"""Model editing widgets (counterpart of `spateo_tpu.tdr.widgets`; reference
spateo/tdr/widgets/ -- interactive pyvista clip/pick/slice). Two tiers:

- `ops` — the same operations as pure array-predicate functions;
- `interactive` — live matplotlib widget loops (RectangleSelector clip,
  LassoSelector pick, Slider slicer) whose callbacks are also drivable
  programmatically, replacing the reference's pyvista event loop
  (clip.py:62, pick.py:14, slice.py:124).

`points_inside_mesh` (and the overlap picks on it) runs on the device; the
rest is host code; matplotlib is imported where a loop draws.
"""

from .interactive import (
    InteractiveLassoPick,
    InteractiveRectangleClip,
    InteractiveSlicer,
    interactive_pick,
    interactive_rectangle_clip,
    interactive_slice,
)
from .ops import (
    clip_models,
    interactive_box_clip,
    overlap_mesh_pick,
    overlap_pc_pick,
    overlap_pick,
    points_inside_mesh,
    pick_models,
    slice_models,
    three_d_pick,
    three_d_slice,
)
