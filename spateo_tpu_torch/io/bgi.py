"""IO for BGI Stereo-seq GEM files.

Counterpart of `spateo_tpu.io.bgi`: `read_bgi_agg` (the AGG raster of total
UMIs per pixel, with stain, spliced, unspliced and label layers),
`read_bgi` (cells or bins x genes), and the label rasters from a label
column. Parsing and aggregation are host pandas and scipy, as in the JAX
package; OpenCV (the stain image) is imported where it is read.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import pandas as pd
from scipy.sparse import csr_matrix

from ..configuration import SKM
from ..core.anndata import AnnData
from ..errors import IOError as SpateoIOError
from ..logging import logger_manager as lm
from .utils import bin_indices, get_bin_props, get_coords_labels, get_label_props, get_points_props


class SpatialResolution(NamedTuple):
    scale: float = 1.0
    unit: Optional[str] = None


VERSIONS = {"stereo": SpatialResolution(0.5, "um")}

COUNT_COLUMN_MAPPING = {
    SKM.X_LAYER: 3,
    SKM.SPLICED_LAYER_KEY: 4,
    SKM.UNSPLICED_LAYER_KEY: 5,
}


def read_bgi_as_dataframe(path: str, label_column: Optional[str] = None) -> pd.DataFrame:
    """Read a BGI GEM file into a DataFrame with standardized columns
    (gene/x/y/total[/spliced/unspliced/label])."""
    dtype = {
        "geneID": "category",
        "x": np.uint32,
        "y": np.uint32,
        "MIDCounts": np.uint16,
        "MIDCount": np.uint16,
        "UMICount": np.uint16,
        "UMICounts": np.uint16,
        "EXONIC": np.uint16,
        "INTRONIC": np.uint16,
    }
    rename = {
        "geneID": "gene",
        "MIDCounts": "total",
        "MIDCount": "total",
        "UMICount": "total",
        "UMICounts": "total",
        "EXONIC": "spliced",
        "INTRONIC": "unspliced",
    }
    head = pd.read_csv(path, sep="\t", dtype=dtype, comment="#", nrows=10)
    if label_column:
        dtype[label_column] = np.uint32
        rename[label_column] = "label"
        if label_column not in head.columns:
            raise SpateoIOError(f"Column `{label_column}` is not present.")
    # ambiguity check: multiple raw columns mapping to the same standard name
    targets: Dict[str, int] = {}
    for src, dst in rename.items():
        if src in head.columns:
            targets[dst] = targets.get(dst, 0) + 1
    for dst, n in targets.items():
        if n > 1:
            raise SpateoIOError(f"Found multiple columns mapping to `{dst}`.")
    df = pd.read_csv(path, sep="\t", dtype=dtype, comment="#").rename(columns=rename)
    # the gene column keeps its GEM name, "geneID"
    if "gene" in df.columns:
        df = df.rename(columns={"gene": "geneID"})
    return df


def dataframe_to_labels(df: pd.DataFrame, column: str, shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Scatter positive per-read labels into a labels raster (vectorized)."""
    shape = shape or (int(df["x"].max()) + 1, int(df["y"].max()) + 1)
    labels = np.zeros(shape, dtype=int)
    sub = df.drop_duplicates(subset=[column, "x", "y"])
    pos = sub[sub[column] > 0]
    labels[pos["x"].values.astype(int), pos["y"].values.astype(int)] = pos[column].values.astype(int)
    return labels


def read_bgi_agg(
    path: str,
    stain_path: Optional[str] = None,
    binsize: int = 1,
    gene_agg: Optional[Dict[str, Union[List[str], Callable[[str], bool]]]] = None,
    prealigned: bool = False,
    label_column: Optional[str] = None,
    version: str = "stereo",
) -> AnnData:
    """Read a BGI GEM file into an AGG-type AnnData: total UMIs per pixel in
    `.X` (sparse), optional stain image / spliced / unspliced / labels layers.

    """
    data = read_bgi_as_dataframe(path, label_column)
    x_min, y_min = int(data["x"].min()), int(data["y"].min())
    x, y = data["x"].values.astype(np.int64), data["y"].values.astype(np.int64)
    x_max, y_max = int(x.max()), int(y.max())
    shape = (x_max + 1, y_max + 1)

    layers: Dict[str, np.ndarray] = {}
    if stain_path:
        import cv2

        image = cv2.imread(stain_path, cv2.IMREAD_UNCHANGED)
        if image is None:
            raise SpateoIOError(f"Could not read stain image {stain_path}")
        if image.ndim == 3:
            image = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        if prealigned:
            lm.main_warning("Assuming stain image was already aligned with the minimum x and y RNA coordinates.")
            image = np.pad(image, ((x_min, 0), (y_min, 0)))
        x_max = max(x_max, image.shape[0] - 1)
        y_max = max(y_max, image.shape[1] - 1)
        shape = (x_max + 1, y_max + 1)
        if image.shape != shape:
            image = np.pad(image, ((0, shape[0] - image.shape[0]), (0, shape[1] - image.shape[1])))
        layers[SKM.STAIN_LAYER_KEY] = image

    labels = None
    if "label" in data.columns:
        lm.main_warning("Using the `label_column` option may result in disconnected labels.")
        labels = dataframe_to_labels(data, "label", shape)
        layers[SKM.LABELS_LAYER_KEY] = labels

    if binsize > 1:
        shape = (math.ceil(shape[0] / binsize), math.ceil(shape[1] / binsize))
        x = bin_indices(x, 0, binsize).astype(np.int64)
        y = bin_indices(y, 0, binsize).astype(np.int64)
        x_min, y_min = int(x.min()), int(y.min())
        if stain_path:
            import cv2

            layers[SKM.STAIN_LAYER_KEY] = cv2.resize(layers[SKM.STAIN_LAYER_KEY], shape[::-1])
        if labels is not None:
            lm.main_warning("Cell labels were provided, but `binsize` > 1.")
            layers[SKM.LABELS_LAYER_KEY] = labels[::binsize, ::binsize]

    X = csr_matrix((data["total"].values, (x, y)), shape=shape, dtype=np.uint16)
    if "spliced" in data.columns:
        layers[SKM.SPLICED_LAYER_KEY] = csr_matrix((data["spliced"].values, (x, y)), shape=shape, dtype=np.uint16)
    if "unspliced" in data.columns:
        layers[SKM.UNSPLICED_LAYER_KEY] = csr_matrix((data["unspliced"].values, (x, y)), shape=shape, dtype=np.uint16)

    if gene_agg:
        for name, genes in gene_agg.items():
            mask = data["geneID"].isin(genes) if isinstance(genes, list) else data["geneID"].map(genes)
            sub = data[mask.astype(bool)]
            _x = sub["x"].values.astype(np.int64)
            _y = sub["y"].values.astype(np.int64)
            if binsize > 1:
                _x = bin_indices(_x, 0, binsize).astype(np.int64)
                _y = bin_indices(_y, 0, binsize).astype(np.int64)
            layers[name] = csr_matrix((sub["total"].values, (_x, _y)), shape=shape, dtype=np.uint16)

    adata = AnnData(X=X, layers=layers)[x_min:, y_min:]

    scale, scale_unit = 1.0, None
    if version in VERSIONS:
        scale, scale_unit = VERSIONS[version].scale, VERSIONS[version].unit

    SKM.init_adata_type(adata, SKM.ADATA_AGG_TYPE)
    SKM.init_uns_pp_namespace(adata)
    SKM.init_uns_spatial_namespace(adata)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_BINSIZE_KEY, binsize)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_KEY, scale)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_UNIT_KEY, scale_unit)
    return adata


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE, "segmentation_adata", optional=True)
def read_bgi(
    path: str,
    binsize: Optional[int] = None,
    segmentation_adata: Optional[AnnData] = None,
    labels_layer: Optional[str] = None,
    labels: Optional[Union[np.ndarray, str]] = None,
    seg_binsize: int = 1,
    label_column: Optional[str] = None,
    add_props: bool = True,
    version: str = "stereo",
) -> AnnData:
    """Read a BGI GEM file into a UMI-type (cells/bins x genes) AnnData,
    aggregating reads per bin or per segmentation label.

    """
    if sum([binsize is not None, segmentation_adata is not None, labels is not None, label_column is not None]) != 1:
        raise SpateoIOError("Exactly one of `segmentation_adata`, `binsize`, `labels`, `label_column` must be provided.")
    if (segmentation_adata is None) ^ (labels_layer is None):
        raise SpateoIOError("Both `segmentation_adata` and `labels_layer` must be provided.")
    if binsize is not None and abs(int(binsize)) != binsize:
        raise SpateoIOError("Positive integer `binsize` must be provided.")
    if isinstance(labels, str):
        labels = np.load(labels)

    data = read_bgi_as_dataframe(path, label_column)
    uniq_gene = sorted(data["geneID"].unique())

    props = None
    if label_column is not None:
        binsize = 1
        data = data[data["label"] > 0]
        if add_props:
            props = get_points_props(data[["x", "y", "label"]])
    elif binsize is not None:
        if binsize > 1:
            data = data.copy()
            data["x"] = bin_indices(data["x"].values, 0, binsize)
            data["y"] = bin_indices(data["y"].values, 0, binsize)
        data = data.copy()
        data["label"] = data["x"].astype(str) + "-" + data["y"].astype(str)
        if add_props:
            props = get_bin_props(data[["x", "y", "label"]].drop_duplicates(), binsize)
    else:
        binsize = 1
        if labels is not None:
            pass
        else:
            labels = SKM.select_layer_data(segmentation_adata, labels_layer)
            if hasattr(labels, "toarray"):
                labels = labels.toarray()
        label_coords = get_coords_labels(np.asarray(labels))
        if labels_layer is not None:
            seg_binsize = SKM.get_uns_spatial_attribute(segmentation_adata, SKM.UNS_SPATIAL_BINSIZE_KEY)
            x_min = int(segmentation_adata.obs_names[0]) * seg_binsize
            y_min = int(segmentation_adata.var_names[0]) * seg_binsize
            label_coords["x"] += x_min
            label_coords["y"] += y_min
        if seg_binsize > 1:
            # each segmentation bin covers a seg_binsize x seg_binsize pixel
            # block: vectorized cross-join of every label row with every
            # (di, dj) offset inside its block
            lm.main_warning("Binning was used for segmentation.")
            di, dj = np.meshgrid(np.arange(seg_binsize), np.arange(seg_binsize), indexing="ij")
            offsets = np.c_[di.ravel(), dj.ravel()]
            k = len(offsets)
            expanded = label_coords.loc[label_coords.index.repeat(k)].reset_index(drop=True)
            expanded["x"] += np.tile(offsets[:, 0], len(label_coords))
            expanded["y"] += np.tile(offsets[:, 1], len(label_coords))
            label_coords = expanded
        data = pd.merge(data, label_coords, on=["x", "y"], how="inner")
        if add_props:
            props = get_label_props(np.asarray(labels))

    # integer-coded (cell, gene) indices for the COO aggregation
    cell_codes = pd.Categorical(data["label"], categories=sorted(data["label"].unique()))
    gene_codes = pd.Categorical(data["geneID"], categories=uniq_gene)
    uniq_cell = list(cell_codes.categories)
    shape = (len(uniq_cell), len(uniq_gene))
    x_ind = np.asarray(cell_codes.codes, dtype=int)
    y_ind = np.asarray(gene_codes.codes, dtype=int)

    X = csr_matrix((data["total"].values, (x_ind, y_ind)), shape=shape)
    layers = {}
    if "spliced" in data.columns:
        layers[SKM.SPLICED_LAYER_KEY] = csr_matrix((data["spliced"].values, (x_ind, y_ind)), shape=shape)
    if "unspliced" in data.columns:
        layers[SKM.UNSPLICED_LAYER_KEY] = csr_matrix((data["unspliced"].values, (x_ind, y_ind)), shape=shape)

    obs = pd.DataFrame(index=[str(c) for c in uniq_cell])
    var = pd.DataFrame(index=[str(g) for g in uniq_gene])
    adata = AnnData(X=X, obs=obs, var=var, layers=layers)
    if props is not None:
        props.index = props.index.astype(str)
        ordered_props = props.loc[adata.obs_names]
        adata.obs["area"] = ordered_props["area"].values
        adata.obsm["spatial"] = ordered_props.filter(regex="centroid-").values.astype(float)
        adata.obsm["contour"] = np.array(list(ordered_props["contour"].values), dtype=object)
        if "bbox-0" in ordered_props:
            adata.obsm["bbox"] = ordered_props.filter(regex="bbox-").values.astype(float)

    scale, scale_unit = 1.0, None
    if version in VERSIONS:
        scale, scale_unit = VERSIONS[version].scale, VERSIONS[version].unit

    SKM.init_adata_type(adata, SKM.ADATA_UMI_TYPE)
    SKM.init_uns_pp_namespace(adata)
    SKM.init_uns_spatial_namespace(adata)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_BINSIZE_KEY, binsize)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_KEY, scale)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_UNIT_KEY, scale_unit)
    return adata


def dataframe_to_filled_labels(df: pd.DataFrame, column: str, shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """BGI dataframe with a cell-label column -> labels raster with each
    label's holes filled."""
    shape = shape or (int(df["x"].max()) + 1, int(df["y"].max()) + 1)
    labels = np.zeros(shape, dtype=int)
    sub = df[df[column] > 0].drop_duplicates(subset=[column, "x", "y"])
    labels[sub["x"].to_numpy(int), sub["y"].to_numpy(int)] = sub[column].to_numpy(int)
    # fill each label's bounding region via convex fill per label
    from scipy import ndimage

    out = labels.copy()
    for lab in np.unique(labels):
        if lab <= 0:
            continue
        m = ndimage.binary_fill_holes(labels == lab)
        out[m] = lab
    return out
