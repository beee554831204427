"""Model utilities (counterpart of `spateo_tpu.tdr.models.utilities`):
model IO, labels and the geometric transforms."""

from .io import read_model, save_model
from .label_utils import add_model_labels
from .model_utils import (
    center_to_zero,
    collect_models,
    merge_models,
    multiblock2model,
    rotate_model,
    scale_model,
    split_model,
    translate_model,
)
