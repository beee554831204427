"""Top-level AnnData IO re-exports (parity: reference spateo/data_io.py,
which re-exports the `anndata` readers). The anndata package is not a
dependency here — the framework ships its own AnnData (`core/anndata.py`),
so the readers are implemented against it:

- `read` / `read_h5ad`: h5py-backed .h5ad
- `read_csv` / `read_text` / `read_excel`: table of cells x genes
- `read_mtx`: Matrix Market sparse matrix
- `read_umi_tools`: gzipped UMI-tools flat count table (gene, cell, count)
- `read_hdf`: a dataset from an arbitrary HDF5 file
- `read_loom` / `read_zarr`: gated on their optional formats' libraries

A copy of `spateo_tpu.data_io`; h5py is imported inside the functions that
read HDF5.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import pandas as pd

from .core.anndata import AnnData, concat, read_h5ad

__all__ = [
    "AnnData",
    "concat",
    "read",
    "read_csv",
    "read_excel",
    "read_h5ad",
    "read_hdf",
    "read_loom",
    "read_mtx",
    "read_text",
    "read_umi_tools",
    "read_zarr",
]


def read(filename: Union[str, Path], **kwargs) -> AnnData:
    """Read `.h5ad` (alias of `read_h5ad`, matching anndata's `read`)."""
    return read_h5ad(str(filename), **kwargs)


def _adata_from_df(df: pd.DataFrame) -> AnnData:
    return AnnData(
        X=df.to_numpy(dtype=np.float32) if df.dtypes.map(lambda d: d.kind in "biufc").all() else df.to_numpy(),
        obs=pd.DataFrame(index=df.index.astype(str)),
        var=pd.DataFrame(index=df.columns.astype(str)),
    )


def read_csv(
    filename: Union[str, Path],
    delimiter: Optional[str] = ",",
    first_column_names: Optional[bool] = None,
    dtype=np.float32,
) -> AnnData:
    """Read a cells x genes table from a .csv file (anndata.read_csv).
    `first_column_names=False` keeps the first column as data (positional
    obs names) instead of consuming it as the index."""
    index_col = None if first_column_names is False else 0
    df = pd.read_csv(filename, sep=delimiter, index_col=index_col).astype(dtype, errors="ignore")
    return _adata_from_df(df)


def read_text(
    filename: Union[str, Path],
    delimiter: Optional[str] = None,
    first_column_names: Optional[bool] = None,
    dtype=np.float32,
) -> AnnData:
    """Read a cells x genes table from a delimited text file
    (anndata.read_text); whitespace-delimited when `delimiter` is None.
    `first_column_names=False` keeps the first column as data."""
    index_col = None if first_column_names is False else 0
    df = pd.read_csv(
        filename, sep=delimiter if delimiter is not None else r"\s+", index_col=index_col, engine="python"
    ).astype(dtype, errors="ignore")
    return _adata_from_df(df)


def read_excel(filename: Union[str, Path], sheet: Union[str, int] = 0, dtype=np.float32) -> AnnData:
    """Read a cells x genes table from an Excel sheet (anndata.read_excel)."""
    df = pd.read_excel(filename, sheet_name=sheet, index_col=0)
    return _adata_from_df(df.astype(dtype, errors="ignore"))


def read_mtx(filename: Union[str, Path], dtype=np.float32) -> AnnData:
    """Read a Matrix Market .mtx sparse matrix (anndata.read_mtx)."""
    from scipy.io import mmread
    from scipy.sparse import csr_matrix

    X = csr_matrix(mmread(str(filename)), dtype=dtype)
    return AnnData(
        X=X,
        obs=pd.DataFrame(index=[str(i) for i in range(X.shape[0])]),
        var=pd.DataFrame(index=[str(j) for j in range(X.shape[1])]),
    )


def read_umi_tools(filename: Union[str, Path], dtype=np.float32) -> AnnData:
    """Read a gzipped condensed count matrix from umi_tools
    (anndata.read_umi_tools): a flat TSV of (gene, cell, count)."""
    from scipy.sparse import csr_matrix

    table = pd.read_table(filename)
    gene_col, cell_col, count_col = table.columns[:3]
    genes = pd.Categorical(table[gene_col].astype(str))
    cells = pd.Categorical(table[cell_col].astype(str))
    X = csr_matrix(
        (table[count_col].values.astype(dtype), (cells.codes, genes.codes)),
        shape=(len(cells.categories), len(genes.categories)),
    )
    return AnnData(
        X=X,
        obs=pd.DataFrame(index=list(map(str, cells.categories))),
        var=pd.DataFrame(index=list(map(str, genes.categories))),
    )


def read_hdf(filename: Union[str, Path], key: str) -> AnnData:
    """Read a dense dataset `key` from an HDF5 file (anndata.read_hdf)."""
    import h5py

    with h5py.File(str(filename), "r") as f:
        if key not in f:
            raise KeyError(f"dataset `{key}` not found in {filename}; available: {list(f.keys())}")
        X = np.asarray(f[key])
        rows = [s.decode() if isinstance(s, bytes) else str(s) for s in np.asarray(f.get("obs_names", np.arange(X.shape[0])))]
        cols = [s.decode() if isinstance(s, bytes) else str(s) for s in np.asarray(f.get("var_names", np.arange(X.shape[1])))]
    return AnnData(X=X, obs=pd.DataFrame(index=rows), var=pd.DataFrame(index=cols))


def read_loom(filename: Union[str, Path], **kwargs) -> AnnData:
    """Read a .loom file. Loom is an HDF5 layout: matrix at /matrix, row
    (gene) and column (cell) attributes under /row_attrs and /col_attrs."""
    import h5py

    with h5py.File(str(filename), "r") as f:
        if "matrix" not in f:
            raise ValueError(f"{filename} is not a loom file (no /matrix)")
        X = np.asarray(f["matrix"])  # loom is genes x cells
        col_attrs = {k: np.asarray(v) for k, v in f.get("col_attrs", {}).items()}
        row_attrs = {k: np.asarray(v) for k, v in f.get("row_attrs", {}).items()}

    def _names(attrs, candidates, n):
        for c in candidates:
            if c in attrs:
                return [s.decode() if isinstance(s, bytes) else str(s) for s in attrs[c]]
        return [str(i) for i in range(n)]

    obs_names = _names(col_attrs, ("CellID", "obs_names"), X.shape[1])
    var_names = _names(row_attrs, ("Gene", "var_names"), X.shape[0])
    adata = AnnData(X=X.T, obs=pd.DataFrame(index=obs_names), var=pd.DataFrame(index=var_names))
    for k, v in col_attrs.items():
        if k not in ("CellID", "obs_names") and len(v) == adata.n_obs:
            adata.obs[k] = [s.decode() if isinstance(s, bytes) else s for s in v]
    return adata


def read_zarr(filename: Union[str, Path]) -> AnnData:
    """Read a zarr-backed AnnData store (requires the optional `zarr`
    package, which is not part of this framework's base environment)."""
    try:
        import zarr  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_zarr requires the optional `zarr` package; install zarr or convert the store to .h5ad"
        ) from e
    raise NotImplementedError("zarr-backed AnnData is not supported in this build; convert to .h5ad")
