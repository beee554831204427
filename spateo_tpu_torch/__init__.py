"""Spateo on PyTorch and CUDA: the port of `spateo_tpu` to NVIDIA Hopper.

Mirrors `spateo_tpu`'s module paths and function names; plain tensor code is
PyTorch and each TPU kernel on a ported path is a hand-written CUDA kernel
(`csrc/`, built at first use). Public entry points take ``device=``, which
defaults to ``"cuda"``. It never imports JAX.

    import spateo_tpu_torch as stt
    agg = stt.io.read_bgi_agg("tile.gem.gz")
    stt.cs.segment_densities(agg, "X", binsize=32, k=5, dk=3)
    stt.cs.score_and_mask_pixels(agg, "X", k=5, method="EM+BP")
    stt.cs.find_peaks_from_mask(agg, "X", min_distance=5)
    stt.cs.watershed(agg, "X")
    cells = stt.io.read_bgi("tile.gem.gz", segmentation_adata=agg, labels_layer="X_labels")
    stt.align.morpho_align([fixed, moving], spatial_key="spatial")
    stt.dd.digitize(adata, ctrs, 0, pnt_xy, pnt_Xy, pnt_xY, pnt_XY)
    stt.tdr.morphofield_sparsevfc_batch(aligned_slices, M=100, MaxIter=60)
    stt.tl.MuSIC(adata=adata, mod_type="lr", custom_ligands=[...], custom_receptors=[...]).fit()
    stt.tl.perform_dimensionality_reduction(adata, reduction_method="tsne")
    inside, outside = stt.tdr.overlap_pc_pick(cloud, surface)
    stt.pl.space(adata, color="cluster", save_show_or_return="return")   # matplotlib, host
    with stt.profiler.timer("fit"):                                      # waits for the card
        ...
"""

from ._lazy_loader import LazyAttribute, LazyLoader
from . import alignment as align
from . import digitization as dd
from . import io
from . import plotting as pl
from . import preprocessing as pp
from . import sample_data
from . import segmentation as cs
from . import svg, tdr
from . import tools as tl
from .configuration import SKM, config
from .core.anndata import AnnData, concat, read_h5ad
from .data_io import (
    read,
    read_csv,
    read_excel,
    read_hdf,
    read_loom,
    read_mtx,
    read_text,
    read_umi_tools,
    read_zarr,
)
from .errors import (
    AlignmentError,
    ConfigurationError,
    DigitizationError,
    MeshError,
    PreprocessingError,
    SegmentationError,
    SpateoError,
)
from .get_version import get_version
from .logging import logger_manager

__version__ = get_version(__file__)

# bound lazily, as in the JAX package
profiler = LazyLoader("profiler", globals(), "spateo_tpu_torch.profiler")
parallel = LazyLoader("parallel", globals(), "spateo_tpu_torch.parallel")
ops = LazyLoader("ops", globals(), "spateo_tpu_torch.ops")
