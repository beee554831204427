"""Model utilities (counterpart of `spateo_tpu.tdr.models.utilities`):
`add_model_labels`. The model IO and the transform helpers are not ported
yet (ROADMAP Queue 1 item 11)."""

from .label_utils import add_model_labels
