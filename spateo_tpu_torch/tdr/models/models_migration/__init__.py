"""Line and arrow models (counterpart of
`spateo_tpu.tdr.models.models_migration.primitives`). The morphofield and
morphopath models are not ported yet (ROADMAP Queue 1 item 11)."""

from .primitives import (
    construct_align_lines,
    construct_arrow,
    construct_arrows,
    construct_axis_line,
    construct_line,
    construct_lines,
    generate_edges,
)
