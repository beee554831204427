"""Core data model and the host <-> card bridge."""

from .anndata import AnnData, concat, read_h5ad
from .bridge import adata_from_reference, morpho_inputs_from_reference, music_state_from_reference, to_device
