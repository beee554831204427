"""Readers for MERFISH, seqFISH, Seq-Scope, Slide-seq, STARmap, 10x Visium,
and NanoString CosMx.

Capability parity with reference spateo/io/{merfish,seqfish,seqscope,slideseq,
starmap,tenx,nanostring}.py (each a host-side table parse -> UMI AnnData).
Shared finalization is factored into `_finalize_umi` instead of the
reference's per-module copies. A copy of `spateo_tpu.io.platforms` (host
pandas and scipy); OpenCV is imported inside `stitch_images`.
"""

from __future__ import annotations

import gzip
import os
import re
from typing import List, NamedTuple, Optional, Union

import numpy as np
import pandas as pd
import scipy.io
from scipy.sparse import coo_matrix, csr_matrix

from ..configuration import SKM
from ..core.anndata import AnnData
from ..errors import IOError as SpateoIOError
from ..logging import logger_manager as lm
from .utils import bin_indices, get_bin_props, get_points_props


class SpatialResolution(NamedTuple):
    scale: float = 1.0
    unit: Optional[str] = None


VERSIONS = {
    "slide2": SpatialResolution(10.0, "um"),
    "visium": SpatialResolution(55.0, "um"),
    "cosmx": SpatialResolution(1.0, "um"),
    "seqscope": SpatialResolution(1.0, "um"),
}


def _finalize_umi(adata: AnnData, binsize: Optional[int] = None, version: Optional[str] = None) -> AnnData:
    scale, scale_unit = 1.0, None
    if version in VERSIONS:
        scale, scale_unit = VERSIONS[version].scale, VERSIONS[version].unit
    SKM.init_adata_type(adata, SKM.ADATA_UMI_TYPE)
    SKM.init_uns_pp_namespace(adata)
    SKM.init_uns_spatial_namespace(adata)
    if binsize is not None:
        SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_BINSIZE_KEY, binsize)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_KEY, scale)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_UNIT_KEY, scale_unit)
    return adata


def _attach_props(adata: AnnData, props: pd.DataFrame):
    props.index = props.index.astype(str)
    ordered = props.loc[adata.obs_names]
    if "area" in ordered:
        adata.obs["area"] = ordered["area"].values
    adata.obsm["spatial"] = ordered.filter(regex="centroid-").values.astype(float)
    if "contour" in ordered:
        adata.obsm["contour"] = np.array(list(ordered["contour"].values), dtype=object)
    if "bbox-0" in ordered:
        adata.obsm["bbox"] = ordered.filter(regex="bbox-").values.astype(float)


# ---------------------------------------------------------------------------
# MERFISH (reference spateo/io/merfish.py:44)
# ---------------------------------------------------------------------------
def read_merfish_as_anndata(path: str) -> AnnData:
    """Read a MERFISH genes x cells matrix CSV as cell x genes AnnData."""
    X = pd.read_csv(path, index_col=0).transpose()
    return AnnData(
        X=csr_matrix(X.values.astype(np.uint16)),
        obs=pd.DataFrame(index=X.index.astype(str)),
        var=pd.DataFrame(index=X.columns.astype(str)),
    )


def read_merfish_positions_as_dataframe(path: str) -> pd.DataFrame:
    """Read MERFISH cell positions (xlsx or csv) as a DataFrame."""
    if path.endswith((".xlsx", ".xls")):
        df_loc = pd.read_excel(path, names=["x", "y"], index_col=0, dtype=np.float32)
    else:
        df_loc = pd.read_csv(path, names=["x", "y"], index_col=0, dtype={"x": np.float32, "y": np.float32})
    return df_loc - min(df_loc["x"].min(), df_loc["y"].min())


def read_merfish(path: str, positions_path: str) -> AnnData:
    """Read MERFISH data as a UMI AnnData with `.obsm['spatial']`."""
    adata = read_merfish_as_anndata(path)
    df_loc = read_merfish_positions_as_dataframe(positions_path)
    df_loc.index = df_loc.index.astype(str)
    common = np.intersect1d(df_loc.index, adata.obs_names)
    adata = adata[common, :]
    adata.obsm["spatial"] = np.asarray(df_loc.loc[adata.obs_names])
    return _finalize_umi(adata)


# ---------------------------------------------------------------------------
# seqFISH (reference spateo/io/seqfish.py:72)
# ---------------------------------------------------------------------------
def read_seqfish_meta_as_dataframe(
    path: str,
    fov_offset: Optional[pd.DataFrame] = None,
    accumulate_x: bool = False,
    accumulate_y: bool = False,
) -> pd.DataFrame:
    """Read seqFISH cell centroid locations, with optional per-FOV offsets."""
    rename = {"Field of View": "fov", "Cell ID": "cell_id", "X": "x", "Y": "y", "Region": "region"}
    df_loc = pd.read_csv(path).rename(columns=rename)
    if fov_offset is not None:
        fov_offset = fov_offset.copy()
        if accumulate_x:
            fov_offset["x_offset"] = fov_offset["x_offset"].cumsum()
        if accumulate_y:
            fov_offset["y_offset"] = fov_offset["y_offset"].cumsum()
        off = fov_offset.set_index("fov")
        df_loc["x"] = df_loc["x"] + off["x_offset"].reindex(df_loc["fov"]).fillna(0).values
        df_loc["y"] = df_loc["y"] + off["y_offset"].reindex(df_loc["fov"]).fillna(0).values
    df_loc["spatial"] = [[int(x), int(y)] for x, y in zip(df_loc["x"], df_loc["y"])]
    return df_loc


def read_seqfish(
    path: str,
    meta_path: str,
    fov_offset: Optional[pd.DataFrame] = None,
    accumulate_x: bool = False,
    accumulate_y: bool = False,
) -> AnnData:
    """Read seqFISH expression CSV + locations into a UMI AnnData."""
    df = pd.read_csv(path, dtype=np.uint16)
    adata = AnnData(
        X=csr_matrix(df.values),
        obs=pd.DataFrame(index=[str(i) for i in df.index]),
        var=pd.DataFrame(index=[str(c) for c in df.columns]),
    )
    df_loc = read_seqfish_meta_as_dataframe(meta_path, fov_offset, accumulate_x, accumulate_y)
    adata.obs["fov"] = df_loc["fov"].to_list()
    adata.obs["cell_id"] = df_loc["cell_id"].to_list()
    adata.obs["region"] = df_loc["region"].to_list()
    adata.obsm["spatial"] = np.array(df_loc["spatial"].to_list())
    return _finalize_umi(adata)


# ---------------------------------------------------------------------------
# Seq-Scope (reference spateo/io/seqscope.py:61)
# ---------------------------------------------------------------------------
def read_seqscope_as_anndata(matrix_dir: str) -> AnnData:
    """Read a Seq-Scope matrix directory (barcodes/features/matrix) as AnnData."""

    def _p(name):
        for cand in (name, name + ".gz"):
            full = os.path.join(matrix_dir, cand)
            if os.path.exists(full):
                return full
        raise SpateoIOError(f"{name} not found in {matrix_dir}")

    obs = pd.read_csv(_p("barcodes.tsv"), names=["barcode"]).set_index("barcode")
    var = pd.read_csv(_p("features.tsv"), names=["gene_name", "gene_id", "library"], sep="\t").set_index("gene_id")
    X = scipy.io.mmread(_p("matrix.mtx")).transpose().tocsr()
    return AnnData(X=X, obs=obs, var=var)


def read_seqscope_positions_as_dataframe(path: str) -> pd.DataFrame:
    """Read Seq-Scope barcode positions (barcode/lane/tile/x/y)."""
    dtype = {"barcode": "category", "lane": np.uint16, "tile": np.uint16, "x": np.uint32, "y": np.uint32}
    return pd.read_table(path, names=["barcode", "lane", "tile", "x", "y"], sep=r"\s+", dtype=dtype)


def read_seqscope(
    matrix_dir: str,
    positions_path: str,
    binsize: Optional[int] = 1,
    add_props: bool = True,
    version: str = "seqscope",
) -> AnnData:
    """Read Seq-Scope data as a binned UMI AnnData."""
    if binsize is not None and abs(int(binsize)) != binsize:
        raise SpateoIOError("Positive integer `binsize` must be provided.")
    adata = read_seqscope_as_anndata(matrix_dir)
    positions = read_seqscope_positions_as_dataframe(positions_path)
    adata.obs = positions.set_index("barcode").loc[adata.obs_names]

    props = None
    if binsize is not None and binsize > 1:
        adata.obs["x"] = bin_indices(adata.obs["x"].values, 0, binsize)
        adata.obs["y"] = bin_indices(adata.obs["y"].values, 0, binsize)
    adata.obs["label"] = adata.obs["x"].astype(str) + "-" + adata.obs["y"].astype(str)
    if add_props:
        props = get_bin_props(adata.obs[["x", "y", "label"]].drop_duplicates(), binsize or 1)

    cat = pd.Categorical(adata.obs["label"])
    indicator = coo_matrix(
        (np.ones(adata.n_obs, dtype=bool), (cat.codes, np.arange(adata.n_obs))),
        shape=(len(cat.categories), adata.n_obs),
    )
    obs_binned = adata.obs.set_index("label")
    obs_binned = obs_binned[~obs_binned.index.duplicated()].loc[cat.categories]
    adata = AnnData(X=csr_matrix(indicator @ adata.X), var=adata.var.copy(), obs=obs_binned)
    if props is not None:
        _attach_props(adata, props)
    else:
        adata.obsm["spatial"] = adata.obs[["x", "y"]].values.astype(float)
    return _finalize_umi(adata, binsize, version)


# ---------------------------------------------------------------------------
# Slide-seq (reference spateo/io/slideseq.py:71)
# ---------------------------------------------------------------------------
def read_slideseq_as_dataframe(path: str) -> pd.DataFrame:
    """Read a Slide-seq digital expression matrix as a long DataFrame."""
    df = pd.read_csv(path, sep="\t").rename(columns={"GENE": "gene"})
    df = df.melt(id_vars="gene", var_name="barcode", value_name="count")
    df = df[df["count"] > 0]
    df["gene"] = df["gene"].astype("category")
    df["barcode"] = df["barcode"].astype("category")
    df["count"] = df["count"].astype(np.uint16)
    return df


def read_slideseq_beads_as_dataframe(path: str) -> pd.DataFrame:
    """Read a Slide-seq bead-locations file (barcode, x, y)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        skiprows = 1 if f.readline().startswith("barcode") else None
    return pd.read_csv(path, skiprows=skiprows, names=["barcode", "x", "y"], dtype={"barcode": "category"})


def read_slideseq(path: str, beads_path: str, binsize: Optional[int] = None, version: str = "slide2") -> AnnData:
    """Read Slide-seq data (expression + beads) as a UMI AnnData."""
    data = read_slideseq_as_dataframe(path)
    beads = read_slideseq_beads_as_dataframe(beads_path)
    data = pd.merge(data, beads, on="barcode")

    if binsize is not None:
        data["x"] = bin_indices(data["x"].values, 0, binsize)
        data["y"] = bin_indices(data["y"].values, 0, binsize)
        data["label"] = data["x"].astype(str) + "-" + data["y"].astype(str)
        props = get_bin_props(data[["x", "y", "label"]].drop_duplicates(), binsize)
    else:
        data = data.rename(columns={"barcode": "label"})
        props = (
            data[["x", "y", "label"]]
            .drop_duplicates()
            .set_index("label")
            .rename(columns={"x": "centroid-0", "y": "centroid-1"})
        )

    uniq_gene = sorted(data["gene"].unique())
    uniq_cell = sorted(data["label"].unique())
    x_ind = data["label"].map(dict(zip(uniq_cell, range(len(uniq_cell))))).astype(int).values
    y_ind = data["gene"].map(dict(zip(uniq_gene, range(len(uniq_gene))))).astype(int).values
    X = csr_matrix((data["count"].values, (x_ind, y_ind)), shape=(len(uniq_cell), len(uniq_gene)))
    adata = AnnData(X=X, obs=pd.DataFrame(index=uniq_cell), var=pd.DataFrame(index=uniq_gene))
    props.index = props.index.astype(str)
    adata.obsm["spatial"] = props.loc[adata.obs_names].filter(regex="centroid-").values.astype(float)
    return _finalize_umi(adata, binsize, version)


# ---------------------------------------------------------------------------
# STARmap (reference spateo/io/starmap.py:56)
# ---------------------------------------------------------------------------
def read_starmap_as_anndata(data_dir: str) -> AnnData:
    """Read a STARmap directory (cell_barcode_count/names csv) as AnnData."""
    X = pd.read_csv(os.path.join(data_dir, "cell_barcode_count.csv"), header=None)
    genes = pd.read_csv(os.path.join(data_dir, "cell_barcode_names.csv"), header=None)
    return AnnData(
        X=csr_matrix(X.values.astype(np.uint16)),
        obs=pd.DataFrame(index=["Cell_" + str(i) for i in range(X.shape[0])]),
        var=pd.DataFrame(index=genes[2].astype(str)),
    )


def read_starmap_positions_as_dataframe(path: str) -> pd.DataFrame:
    """Read STARmap labels npz as an (x, y, label) DataFrame with the
    standard area filter (1000 < area < 100000, drop max label)."""
    labels = np.load(path)["labels"]
    coo = csr_matrix(labels).tocoo()
    df_labels = pd.DataFrame({"x": coo.row, "y": coo.col, "label": coo.data})[["x", "y", "label"]]
    unique_label, label_area = np.unique(df_labels["label"], return_counts=True)
    keep = unique_label[np.logical_and(label_area > 1000, label_area < 100000)]
    df_labels = df_labels[df_labels["label"].isin(keep)]
    df_labels = df_labels[df_labels["label"] != np.max(df_labels["label"])]
    return df_labels


def read_starmap(data_dir: str) -> AnnData:
    """Read STARmap data as a UMI AnnData."""
    adata = read_starmap_as_anndata(data_dir)
    df_labels = read_starmap_positions_as_dataframe(os.path.join(data_dir, "labels.npz"))
    props = get_points_props(df_labels)
    props.index = adata.obs_names[: len(props)]
    _attach_props(adata[: len(props)] if len(props) != adata.n_obs else adata, props)
    return _finalize_umi(adata)


# ---------------------------------------------------------------------------
# 10x Visium (reference spateo/io/tenx.py:64)
# ---------------------------------------------------------------------------
def read_10x_as_anndata(matrix_dir: str) -> AnnData:
    """Read a 10x matrix directory as AnnData."""
    obs = pd.read_csv(os.path.join(matrix_dir, "barcodes.tsv.gz"), names=["barcode"]).set_index("barcode")
    var = pd.read_csv(
        os.path.join(matrix_dir, "features.tsv.gz"), names=["gene_name", "gene_id", "library"], sep="\t"
    ).set_index("gene_id")
    X = scipy.io.mmread(os.path.join(matrix_dir, "matrix.mtx.gz")).tocsr()
    return AnnData(X=X, obs=obs, var=var)


def read_10x_positions_as_dataframe(path: str) -> pd.DataFrame:
    """Read 10x tissue_positions CSV."""
    return pd.read_csv(
        path, names=["barcode", "in_tissue", "array_row", "array_col", "pxl_row_in_fullres", "pxl_col_in_fullres"]
    )


def read_10x(matrix_dir: str, positions_path: str, version: str = "visium") -> AnnData:
    """Read 10x Visium data as a UMI AnnData."""
    adata = read_10x_as_anndata(matrix_dir)
    positions = read_10x_positions_as_dataframe(positions_path)
    adata.obs = positions.set_index("barcode").loc[adata.obs_names]
    adata.obsm["spatial"] = adata.obs[["pxl_row_in_fullres", "pxl_col_in_fullres"]].values.astype(float)
    return _finalize_umi(adata, version=version)


# ---------------------------------------------------------------------------
# NanoString CosMx (reference spateo/io/nanostring.py:207)
# ---------------------------------------------------------------------------
def read_nanostring_as_dataframe(path: str, label_columns: Optional[List[str]] = None) -> pd.DataFrame:
    """Read a CosMx transcript/metadata CSV with standardized columns."""
    dtype = {
        "target": "category",
        "x_global_px": np.float64,
        "y_global_px": np.float64,
        "x_local_px": np.float64,
        "y_local_px": np.float64,
        "fov": "category",
        "cell_ID": np.uint32,
        "CenterX_global_px": np.float64,
        "CenterY_global_px": np.float64,
    }
    rename = {
        "target": "gene",
        "x_global_px": "x",
        "y_global_px": "y",
        "CenterX_global_px": "x",
        "CenterY_global_px": "y",
    }
    df = pd.read_csv(path, dtype={k: v for k, v in dtype.items()}).rename(columns=rename)
    if "x" in df.columns:
        # reference casts float px to unsigned int (truncation, nanostring.py:66)
        df["x"] = df["x"].astype(np.int64)
        df["y"] = df["y"].astype(np.int64)
    if label_columns:
        for col in label_columns:
            if col not in df.columns:
                raise SpateoIOError(f"Column `{col}` is not present.")
        labels = df[label_columns[0]].astype(str)
        for col in label_columns[1:]:
            labels = labels + "-" + df[col].astype(str)
        df["label"] = labels.astype("category")
    return df


FOV_PARSER = re.compile(r"^.+_F(?P<fov>[0-9]+)\..+$")


def stitch_images(stain_dir: str, positions_path: str, labels: bool = False) -> np.ndarray:
    """Stitch per-FOV CosMx stain/label images (filenames ending in ``_FXXX``)
    into one global image (reference spateo/io/nanostring.py:99).

    Placement follows the reference convention: each tile is transposed and
    flipped (``fliplr(swapaxes(img, 0, 1))``) so the stitched canvas is
    indexed (x_global_px, y_global_px); in ``labels`` mode per-FOV labels are
    offset to stay globally unique. Tiles are read with cv2 (3-channel images
    are returned RGB) and processed in sorted filename order so label offsets
    are deterministic.
    """
    import cv2

    stain_fov_paths: dict = {}
    for fname in sorted(os.listdir(stain_dir)):
        match = FOV_PARSER.match(fname)
        if not match:
            continue
        fov = int(match["fov"])
        if fov in stain_fov_paths:
            raise SpateoIOError(
                f"Multiple images for FOV {fov} were found: {stain_fov_paths[fov]}, {fname}."
            )
        stain_fov_paths[fov] = os.path.join(stain_dir, fname)

    fov_df = pd.read_csv(positions_path, dtype={"fov": int}, index_col="fov")
    if set(fov_df.index) != set(stain_fov_paths.keys()):
        raise SpateoIOError(
            f"FOVs defined in {positions_path} do not match exactly with those found in {stain_dir}."
        )
    fov_x = dict(fov_df["x_global_px"].astype(np.uint32))
    fov_y = dict(fov_df["y_global_px"].astype(np.uint32))

    xmin, ymin = min(fov_x.values()), min(fov_y.values())
    xmax, ymax = 0, 0
    extra_dims = None
    dtype = None
    stain_fovs = {}
    for fov, path in stain_fov_paths.items():
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise SpateoIOError(f"Could not read image {path}")
        if img.ndim == 3 and img.shape[2] == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        x, y = fov_x[fov], fov_y[fov]
        xmax = max(xmax, int(x) + img.shape[1] - 1)
        ymax = max(ymax, int(y) + img.shape[0] - 1)
        stain_fovs[fov] = img

        if extra_dims is None:
            extra_dims = img.shape[2:]
        elif extra_dims != img.shape[2:]:
            raise SpateoIOError(f"FOV {path} has inconsistent non-XY dimensions.")
        if dtype is None:
            dtype = img.dtype
        elif dtype != img.dtype:
            raise SpateoIOError(f"FOV {path} has inconsistent dtype.")

    if labels:
        dtype = np.uint64

    last_label = 0
    canvas = np.zeros((xmax - int(xmin) + 1, ymax - int(ymin) + 1) + tuple(extra_dims), dtype=dtype)
    for fov, img in stain_fovs.items():
        x, y = int(fov_x[fov]) - int(xmin), int(fov_y[fov]) - int(ymin)
        if labels:
            img = img.astype(np.uint64)
            img[img > 0] += last_label
            last_label = int(img.max())
        canvas[x : x + img.shape[1], y : y + img.shape[0]] = np.fliplr(np.swapaxes(img, 0, 1))
    return canvas


def read_nanostring(
    path: str,
    meta_path: Optional[str] = None,
    binsize: Optional[int] = None,
    label_columns: Optional[Union[str, List[str]]] = None,
    add_props: bool = True,
    version: str = "cosmx",
) -> AnnData:
    """Read NanoString CosMx transcripts as a bins/labels x genes UMI AnnData."""
    if sum([binsize is not None, label_columns is not None]) != 1:
        raise SpateoIOError("Exactly one of `binsize`, `label_columns` must be provided.")
    if binsize is not None and abs(int(binsize)) != binsize:
        raise SpateoIOError("Positive integer `binsize` must be provided.")

    label_columns = [label_columns] if isinstance(label_columns, str) else label_columns
    data = read_nanostring_as_dataframe(path, label_columns)
    metadata = None
    uniq_gene = sorted(data["gene"].unique())

    props = None
    if label_columns:
        if meta_path:
            metadata = read_nanostring_as_dataframe(meta_path, label_columns)
        binsize = 1
        data = data[data["cell_ID"] > 0]
        if add_props:
            props = get_points_props(data[["x", "y", "label"]])
    else:
        if binsize > 1:
            data = data.copy()
            data["x"] = bin_indices(data["x"].values, 0, binsize)
            data["y"] = bin_indices(data["y"].values, 0, binsize)
        data["label"] = data["x"].astype(str) + "-" + data["y"].astype(str)
        if add_props:
            props = get_bin_props(data[["x", "y", "label"]].drop_duplicates(), binsize)

    uniq_cell = sorted(data["label"].unique())
    cell_dict = dict(zip(uniq_cell, range(len(uniq_cell))))
    gene_dict = dict(zip(uniq_gene, range(len(uniq_gene))))
    counts = data.groupby(["label", "gene"], observed=True, sort=False).size().reset_index(name="count")
    x_ind = counts["label"].map(cell_dict).astype(int).values
    y_ind = counts["gene"].map(gene_dict).astype(int).values
    X = csr_matrix((counts["count"].values, (x_ind, y_ind)), shape=(len(uniq_cell), len(uniq_gene)))
    adata = AnnData(
        X=X,
        obs=pd.DataFrame(index=[str(c) for c in uniq_cell]),
        var=pd.DataFrame(index=[str(g) for g in uniq_gene]),
    )
    if metadata is not None:
        adata.obs = metadata.set_index("label").loc[adata.obs_names]
    if props is not None:
        _attach_props(adata, props)
    return _finalize_umi(adata, binsize, version)
