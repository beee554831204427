"""Minimal AnnData-compatible data model (host side: numpy, pandas, h5py).

A copy of `spateo_tpu.core.anndata`, which has no JAX in it; the port keeps
its own so that importing it never runs `spateo_tpu/__init__.py` (which
imports JAX). The subset of the ``anndata.AnnData`` contract it implements:

- ``X`` (dense ndarray or scipy.sparse), ``layers``, ``obs``/``var``
  (pandas DataFrames), ``obsm``/``varm`` (array dicts), ``obsp``/``varp``
  (pairwise matrices), ``uns`` (nested dict).
- slicing (``adata[obs_idx, var_idx]``) returning copies (no view machinery —
  simpler and race-free for device hand-off),
- ``concat`` over obs,
- HDF5 persistence (``write_h5ad``/``read_h5ad``) with a layout compatible in
  spirit with the h5ad format (CSR groups with data/indices/indptr).

Device-facing code never touches this container directly: layers leave it as
numpy arrays and reach the card through `spateo_tpu_torch.core.bridge`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import pandas as pd
from scipy import sparse

Array = Union[np.ndarray, sparse.spmatrix]


def _check_2d(x: Array, name: str) -> Array:
    if x.ndim != 2:
        raise ValueError(f"{name} must be 2-dimensional, got {x.ndim}")
    return x


class _AlignedDict(dict):
    """dict of arrays whose first dimension(s) must match the parent AnnData."""

    def __init__(self, parent: "AnnData", axes: tuple, *args, **kwargs):
        super().__init__()
        self._parent = parent
        self._axes = axes  # tuple of 0/1: which adata dims each array dim maps to
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __setitem__(self, key: str, value):
        if not sparse.issparse(value):
            value = np.asarray(value)
        for arr_dim, adata_dim in enumerate(self._axes):
            expected = self._parent.shape[adata_dim]
            if value.shape[arr_dim] != expected:
                raise ValueError(
                    f"value for {key!r} has shape {value.shape}; dim {arr_dim} "
                    f"must equal {expected}"
                )
        super().__setitem__(key, value)


class AnnData:
    """An annotated data matrix: observations x variables.

    Mirrors the behavioral subset of ``anndata.AnnData`` exercised by the
    reference framework (layer get/set, obs/var metadata, slicing, h5ad IO).
    """

    def __init__(
        self,
        X: Optional[Array] = None,
        obs: Optional[Union[pd.DataFrame, Dict]] = None,
        var: Optional[Union[pd.DataFrame, Dict]] = None,
        uns: Optional[Dict] = None,
        obsm: Optional[Dict] = None,
        varm: Optional[Dict] = None,
        layers: Optional[Dict] = None,
        obsp: Optional[Dict] = None,
        varp: Optional[Dict] = None,
        shape: Optional[tuple] = None,
        dtype: Optional[Any] = None,
    ):
        if X is not None:
            if not sparse.issparse(X):
                X = np.asarray(X)
                if X.ndim == 1:
                    X = X[None, :]
            _check_2d(X, "X")
            if dtype is not None:
                X = X.astype(dtype)
            n_obs, n_vars = X.shape
        elif shape is not None:
            n_obs, n_vars = shape
        else:
            n_obs = len(obs) if obs is not None else 0
            n_vars = len(var) if var is not None else 0

        self._X = X

        if obs is None:
            obs = pd.DataFrame(index=pd.Index([str(i) for i in range(n_obs)]))
        elif not isinstance(obs, pd.DataFrame):
            obs = pd.DataFrame(obs)
        if var is None:
            var = pd.DataFrame(index=pd.Index([str(i) for i in range(n_vars)]))
        elif not isinstance(var, pd.DataFrame):
            var = pd.DataFrame(var)
        if len(obs) != n_obs:
            raise ValueError(f"obs has {len(obs)} rows, X has {n_obs}")
        if len(var) != n_vars:
            raise ValueError(f"var has {len(var)} rows, X has {n_vars}")
        self.obs = obs
        self.var = var
        self.obs.index = self.obs.index.astype(str)
        self.var.index = self.var.index.astype(str)

        self.uns: Dict[str, Any] = dict(uns or {})
        self.obsm = _AlignedDict(self, (0,), obsm or {})
        self.varm = _AlignedDict(self, (1,), varm or {})
        self.layers = _AlignedDict(self, (0, 1), layers or {})
        self.obsp = _AlignedDict(self, (0, 0), obsp or {})
        self.varp = _AlignedDict(self, (1, 1), varp or {})

    # -- basic properties ---------------------------------------------------
    @property
    def X(self) -> Optional[Array]:
        return self._X

    @X.setter
    def X(self, value: Array):
        if value is not None:
            if not sparse.issparse(value):
                value = np.asarray(value)
            _check_2d(value, "X")
            if value.shape != self.shape:
                raise ValueError(f"X shape {value.shape} != adata shape {self.shape}")
        self._X = value

    @property
    def n_obs(self) -> int:
        return len(self.obs)

    @property
    def n_vars(self) -> int:
        return len(self.var)

    @property
    def shape(self) -> tuple:
        return (self.n_obs, self.n_vars)

    def __len__(self) -> int:
        # anndata convention: len(adata) == n_obs (upstream AnnData.__len__)
        return self.n_obs

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @obs_names.setter
    def obs_names(self, names):
        self.obs.index = pd.Index([str(n) for n in names])

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    @var_names.setter
    def var_names(self, names):
        self.var.index = pd.Index([str(n) for n in names])

    def obs_vector(self, key: str) -> np.ndarray:
        if key in self.obs.columns:
            return self.obs[key].values
        j = self.var_names.get_loc(key)
        col = self._X[:, j]
        return np.asarray(col.todense()).ravel() if sparse.issparse(col) else np.asarray(col).ravel()

    def var_vector(self, key: str) -> np.ndarray:
        if key in self.var.columns:
            return self.var[key].values
        i = self.obs_names.get_loc(key)
        row = self._X[i, :]
        return np.asarray(row.todense()).ravel() if sparse.issparse(row) else np.asarray(row).ravel()

    # -- slicing ------------------------------------------------------------
    def _normalize_index(self, idx, axis: int):
        names = self.obs_names if axis == 0 else self.var_names
        n = len(names)
        if isinstance(idx, slice):
            return np.arange(n)[idx]
        if isinstance(idx, str):
            return np.array([names.get_loc(idx)])
        if isinstance(idx, (int, np.integer)):
            return np.array([idx % n if idx < 0 else idx])
        idx = np.asarray(idx)
        if idx.dtype == bool:
            if idx.shape[0] != n:
                raise IndexError(f"boolean index length {idx.shape[0]} != axis length {n}")
            return np.where(idx)[0]
        if idx.dtype.kind in "US" or (idx.dtype == object and idx.size and isinstance(idx.flat[0], str)):
            lookup = pd.Index(names)
            return np.asarray(lookup.get_indexer(idx))
        return idx.astype(int)

    def __getitem__(self, index) -> "AnnData":
        if not isinstance(index, tuple):
            index = (index, slice(None))
        oi = self._normalize_index(index[0], 0)
        vi = self._normalize_index(index[1], 1)

        def take(x, oi, vi):
            if x is None:
                return None
            if sparse.issparse(x):
                return x[oi][:, vi]
            return x[np.ix_(oi, vi)]

        new = AnnData(
            X=take(self._X, oi, vi),
            obs=self.obs.iloc[oi].copy(),
            var=self.var.iloc[vi].copy(),
            uns=_deepcopy_uns(self.uns),
        )
        for k, v in self.layers.items():
            new.layers[k] = take(v, oi, vi)
        for k, v in self.obsm.items():
            new.obsm[k] = v[oi].copy() if not sparse.issparse(v) else v[oi].copy()
        for k, v in self.varm.items():
            new.varm[k] = v[vi].copy() if not sparse.issparse(v) else v[vi].copy()
        for k, v in self.obsp.items():
            new.obsp[k] = v[oi][:, oi] if sparse.issparse(v) else v[np.ix_(oi, oi)]
        for k, v in self.varp.items():
            new.varp[k] = v[vi][:, vi] if sparse.issparse(v) else v[np.ix_(vi, vi)]
        return new

    def copy(self) -> "AnnData":
        return self[:, :]

    def _replace_with(self, other: "AnnData"):
        self._X = other._X
        self.obs = other.obs
        self.var = other.var
        self.uns = other.uns
        self.obsm = _AlignedDict(self, (0,), dict(other.obsm))
        self.varm = _AlignedDict(self, (1,), dict(other.varm))
        self.layers = _AlignedDict(self, (0, 1), dict(other.layers))
        self.obsp = _AlignedDict(self, (0, 0), dict(other.obsp))
        self.varp = _AlignedDict(self, (1, 1), dict(other.varp))

    def _inplace_subset_obs(self, index):
        self._replace_with(self[index, :])

    def _inplace_subset_var(self, index):
        self._replace_with(self[:, index])

    @property
    def is_view(self) -> bool:
        return False  # this implementation has no view machinery

    def uns_keys(self):
        return self.uns.keys()

    def strings_to_categoricals(self):
        def _is_stringy(s):
            # modern pandas may infer ``str``/``string`` dtype where older
            # versions used ``object``; anndata converts both to categorical
            return s.dtype == object or pd.api.types.is_string_dtype(s.dtype)

        for col in self.obs.columns:
            if _is_stringy(self.obs[col]):
                self.obs[col] = self.obs[col].astype("category")
        for col in self.var.columns:
            if _is_stringy(self.var[col]):
                self.var[col] = self.var[col].astype("category")

    def transpose(self) -> "AnnData":
        new = AnnData(
            X=self._X.T if self._X is not None else None,
            obs=self.var.copy(),
            var=self.obs.copy(),
            uns=_deepcopy_uns(self.uns),
        )
        for k, v in self.layers.items():
            new.layers[k] = v.T
        for k, v in self.varm.items():
            new.obsm[k] = v
        for k, v in self.obsm.items():
            new.varm[k] = v
        return new

    @property
    def T(self) -> "AnnData":
        return self.transpose()

    def __repr__(self) -> str:
        lines = [f"AnnData object with n_obs x n_vars = {self.n_obs} x {self.n_vars}"]
        for attr in ("obs", "var"):
            cols = list(getattr(self, attr).columns)
            if cols:
                lines.append(f"    {attr}: {', '.join(map(repr, cols))}")
        for attr in ("uns", "obsm", "varm", "layers", "obsp", "varp"):
            keys = list(getattr(self, attr).keys())
            if keys:
                lines.append(f"    {attr}: {', '.join(map(repr, keys))}")
        return "\n".join(lines)

    # -- IO -----------------------------------------------------------------
    def write_h5ad(self, path: str, compression: Optional[str] = "gzip"):
        import h5py

        with h5py.File(path, "w") as f:
            if self._X is not None:
                _write_matrix(f, "X", self._X, compression)
            _write_df(f, "obs", self.obs, compression)
            _write_df(f, "var", self.var, compression)
            for group, d in (
                ("layers", self.layers),
                ("obsm", self.obsm),
                ("varm", self.varm),
                ("obsp", self.obsp),
                ("varp", self.varp),
            ):
                g = f.create_group(group)
                for k, v in d.items():
                    _write_matrix(g, k, v, compression)
            _write_uns(f.create_group("uns"), self.uns, compression)

    write = write_h5ad

    def concatenate(self, *others: "AnnData", join: str = "inner") -> "AnnData":
        return concat([self, *others], join=join)


def _deepcopy_uns(d):
    if isinstance(d, dict):
        return {k: _deepcopy_uns(v) for k, v in d.items()}
    if isinstance(d, np.ndarray):
        return d.copy()
    if sparse.issparse(d):
        return d.copy()
    return d


def _write_matrix(g, name: str, x, compression):
    if sparse.issparse(x):
        x = x.tocsr()
        sub = g.create_group(name)
        sub.attrs["encoding-type"] = "csr_matrix"
        sub.attrs["shape"] = x.shape
        sub.create_dataset("data", data=x.data, compression=compression)
        sub.create_dataset("indices", data=x.indices, compression=compression)
        sub.create_dataset("indptr", data=x.indptr, compression=compression)
    else:
        x = np.asarray(x)
        if x.dtype == object or x.dtype.kind in "US":
            import h5py

            g.create_dataset(name, data=np.asarray(x, dtype=h5py.string_dtype()))
        else:
            g.create_dataset(name, data=x, compression=compression)


def _read_matrix(node):
    import h5py

    if isinstance(node, h5py.Group):
        shape = tuple(node.attrs["shape"])
        return sparse.csr_matrix(
            (node["data"][:], node["indices"][:], node["indptr"][:]), shape=shape
        )
    data = node[:]
    if data.dtype.kind == "O" or data.dtype.kind == "S":
        data = data.astype(str)
    return data


def _write_df(f, name: str, df: pd.DataFrame, compression):
    import h5py

    g = f.create_group(name)
    g.attrs["encoding-type"] = "dataframe"
    g.attrs["column-order"] = list(map(str, df.columns))
    g.create_dataset("_index", data=np.asarray(df.index.astype(str), dtype=h5py.string_dtype()))
    for col in df.columns:
        vals = np.asarray(df[col].values)
        # anything non-numeric/bool round-trips as strings (covers object,
        # numpy str_, pandas Categorical AND pandas>=3 arrow-backed string
        # dtypes, whose .values dtype is neither object nor 'U')
        if isinstance(df[col].dtype, pd.CategoricalDtype) or vals.dtype.kind not in "biufc":
            g.create_dataset(str(col), data=np.asarray(df[col].astype(str).values, dtype=h5py.string_dtype()))
        else:
            g.create_dataset(str(col), data=vals, compression=compression)


def _read_df(g) -> pd.DataFrame:
    index = g["_index"][:].astype(str)
    cols = {}
    order = list(g.attrs.get("column-order", []))
    keys = order if order else [k for k in g.keys() if k != "_index"]
    for k in keys:
        v = g[k][:]
        if v.dtype.kind in "OS":
            v = v.astype(str)
        cols[k] = v
    return pd.DataFrame(cols, index=pd.Index(index))


def _write_uns(g, d: Dict, compression):
    import h5py

    for k, v in d.items():
        k = str(k)
        if isinstance(v, dict):
            _write_uns(g.create_group(k), v, compression)
        elif sparse.issparse(v):
            _write_matrix(g, k, v, compression)
        elif isinstance(v, np.ndarray):
            _write_matrix(g, k, v, compression)
        elif isinstance(v, str):
            g.create_dataset(k, data=np.asarray(v, dtype=h5py.string_dtype()))
        elif isinstance(v, (bool, np.bool_)):
            g.create_dataset(k, data=np.bool_(v))
        elif isinstance(v, (int, float, np.integer, np.floating)):
            g.create_dataset(k, data=v)
        elif isinstance(v, (list, tuple)):
            try:
                arr = np.asarray(v)
                _write_matrix(g, k, arr, compression)
            except Exception:
                pass  # unserializable — skipped, like anndata's warning path
        elif v is None:
            sub = g.create_group(k)
            sub.attrs["encoding-type"] = "none"


def _read_uns(g) -> Dict:
    import h5py

    out: Dict[str, Any] = {}
    for k, v in g.items():
        if isinstance(v, h5py.Group):
            if v.attrs.get("encoding-type") == "csr_matrix":
                out[k] = _read_matrix(v)
            elif v.attrs.get("encoding-type") == "none":
                out[k] = None
            else:
                out[k] = _read_uns(v)
        else:
            data = v[()]
            if isinstance(data, bytes):
                data = data.decode()
            elif isinstance(data, np.ndarray) and data.dtype.kind in "OS":
                data = data.astype(str)
            out[k] = data
    return out


def read_h5ad(path: str) -> AnnData:
    import h5py

    with h5py.File(path, "r") as f:
        X = _read_matrix(f["X"]) if "X" in f else None
        obs = _read_df(f["obs"]) if "obs" in f else None
        var = _read_df(f["var"]) if "var" in f else None
        adata = AnnData(X=X, obs=obs, var=var)
        for group, target in (
            ("layers", adata.layers),
            ("obsm", adata.obsm),
            ("varm", adata.varm),
            ("obsp", adata.obsp),
            ("varp", adata.varp),
        ):
            if group in f:
                for k in f[group]:
                    target[k] = _read_matrix(f[group][k])
        if "uns" in f:
            adata.uns = _read_uns(f["uns"])
    return adata


def concat(adatas: List[AnnData], join: str = "inner", axis: int = 0) -> AnnData:
    """Concatenate AnnData objects along obs (axis=0)."""
    if axis != 0:
        raise NotImplementedError("only obs concatenation supported")
    if join == "inner":
        common = adatas[0].var_names
        for a in adatas[1:]:
            common = common.intersection(a.var_names)
        adatas = [a[:, np.asarray(common)] for a in adatas]
    else:
        union = adatas[0].var_names
        for a in adatas[1:]:
            union = union.union(a.var_names)
        expanded = []
        for a in adatas:
            idx = pd.Index(union).get_indexer(a.var_names)
            X = sparse.lil_matrix((a.n_obs, len(union)), dtype=(a.X.dtype if a.X is not None else np.float32))
            if a.X is not None:
                X[:, idx] = a.X
            expanded.append(AnnData(X=X.tocsr(), obs=a.obs.copy(), var=pd.DataFrame(index=union)))
        adatas = expanded

    Xs = [a.X for a in adatas]
    if any(sparse.issparse(x) for x in Xs if x is not None):
        X = sparse.vstack([sparse.csr_matrix(x) for x in Xs])
    elif all(x is not None for x in Xs):
        X = np.vstack(Xs)
    else:
        X = None
    obs = pd.concat([a.obs for a in adatas], axis=0)
    if obs.index.has_duplicates:
        obs.index = pd.Index([f"{n}-{i}" for i, a in enumerate(adatas) for n in a.obs_names])
    out = AnnData(X=X, obs=obs, var=adatas[0].var.copy())
    shared_layers = set(adatas[0].layers)
    for a in adatas[1:]:
        shared_layers &= set(a.layers)
    for k in shared_layers:
        vals = [a.layers[k] for a in adatas]
        out.layers[k] = sparse.vstack([sparse.csr_matrix(v) for v in vals]) if any(
            sparse.issparse(v) for v in vals
        ) else np.vstack(vals)
    shared_obsm = set(adatas[0].obsm)
    for a in adatas[1:]:
        shared_obsm &= set(a.obsm)
    for k in shared_obsm:
        out.obsm[k] = np.vstack([np.asarray(a.obsm[k]) for a in adatas])
    return out
