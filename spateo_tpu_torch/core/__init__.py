"""Core data model and the host <-> card bridge."""

from .anndata import AnnData, concat, read_h5ad
from .bridge import (
    adata_from_reference,
    csr_to_dense_device,
    layer_to_device,
    morpho_inputs_from_reference,
    music_state_from_reference,
    points_to_raster,
    segment_sum_device,
    to_device,
)
