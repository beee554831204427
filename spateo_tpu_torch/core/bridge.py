"""Host <-> card: numpy to device tensors, and state carried over from the
JAX package.

`to_device(x, dtype=None, sharding=None, device="cuda")` is the JAX
package's public call: 64-bit dtypes narrow to 32 bits (x64 off there), and
`sharding=` places the array on a mesh. The port's own paths call
`_to_device(x, device, dtype)`, which keeps wide dtypes (its float64 paths
need them) and uploads through pinned host memory with ``non_blocking=True``,
so the copy is asynchronous on the current stream. `adata_from_reference` builds
the port's `AnnData` from an `AnnData` of `spateo_tpu` by reading its numpy
fields, `morpho_inputs_from_reference` carries a `spateo_tpu` Morpho solve's
EM inputs over, and `vfc_from_reference` and `vecfld_from_reference` carry a
learned SparseVFC field and a Morpho vector field,
`music_state_from_reference` a MuSIC design, `nlpca_from_reference` the
weights of an NLPCA principal curve, `siren_from_reference` a deep
interpolator's SIREN, `sgpr_params_from_reference` a sparse GP's parameters,
`gc_dec_from_reference` a SpaGCN head's W and mu, and
`cast_params_from_reference`, `stagate_params_from_reference` and
`merfishvi_params_from_reference` the weights of the external models; all are
duck-typed, so that this module never imports the JAX package.

`csr_to_dense_device`, `layer_to_device`, `segment_sum_device` and
`points_to_raster` are the JAX package's device helpers: a CSR layer or a
list of point reads goes up as its nonzeros and is scattered into a padded
dense tensor on the card (`index_put_(accumulate=True)`, or `index_add_`
for a segment sum). Host 64-bit data narrows to 32 bits (`_X64_OFF`), as
in the JAX package with x64 off, and an index out of range is dropped, as
XLA's scatter drops it. Sums of whole numbers below 2^24 are exact in any
order, so those agree with the JAX package bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from .anndata import AnnData, _deepcopy_uns


#: what a 64-bit dtype becomes in the JAX package with x64 off
_X64_OFF = {np.dtype(np.float64): np.dtype(np.float32), np.dtype(np.int64): np.dtype(np.int32),
            np.dtype(np.uint64): np.dtype(np.uint32), np.dtype(np.complex128): np.dtype(np.complex64)}


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or a numpy dtype (or anything `np.dtype` takes) as one."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


#: `_X64_OFF` between torch dtypes
_X64_OFF_TORCH = {_torch_dtype(wide): _torch_dtype(narrow) for wide, narrow in _X64_OFF.items()}


def to_device(x, dtype=None, sharding=None, device="cuda") -> torch.Tensor:
    """`x` as a tensor on `device`, cast to `dtype` (numpy's or torch's)
    first, then narrowed as the JAX package narrows with x64 off: float64 to
    float32, int64 to int32, uint64 to uint32, complex128 to complex64, also
    when a wide dtype is asked for.

    `sharding` is a list of placements (`parallel.row_sharding(mesh)`,
    `pairwise_sharding`, `replicated`) over `config.mesh`, or a
    ``(mesh, placements)`` pair; then every rank passes the same full `x`
    and gets a `DTensor` on the mesh's device (`device` is not used). A
    mesh that is not a `DeviceMesh`, or placements of another length than
    its axes, raise `MeshError`."""
    t = x
    if not isinstance(t, torch.Tensor):
        a = np.asarray(x)  # a 0-d array stays 0-d, as in the JAX package
        t = torch.from_numpy(a if a.flags.c_contiguous and a.flags.writeable else a.copy())
    if dtype is not None:
        t = t.to(_torch_dtype(dtype))
    t = t.to(_X64_OFF_TORCH.get(t.dtype, t.dtype))
    if sharding is None:
        return _to_device(t, device)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Placement, distribute_tensor

    from ..errors import MeshError
    from ..parallel._collectives import mesh_device

    if isinstance(sharding, tuple) and len(sharding) == 2 and not isinstance(sharding[0], Placement):
        mesh, placements = sharding
    else:
        from ..configuration import config

        mesh, placements = config.mesh, sharding
    if not isinstance(mesh, DeviceMesh):
        raise MeshError(f"to_device(sharding=...) needs a DeviceMesh, got {type(mesh).__name__}")
    placements = list(placements)
    if len(placements) != mesh.ndim:
        raise MeshError(f"{len(placements)} placements for a mesh of {mesh.ndim} axes")
    return distribute_tensor(t.to(mesh_device(mesh)), mesh, placements)


def _to_device(x, device="cuda", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Move a host array (or tensor) to `device`, optionally cast to `dtype`.

    A host array bound for the card goes through pinned memory and an
    asynchronous copy; the cast, if any, runs on the device."""
    device = torch.device(device)
    t = x
    if not isinstance(t, torch.Tensor):
        a = np.ascontiguousarray(x)
        # a read-only array (a view of a JAX array, say) is copied: torch
        # does not support non-writable tensors
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


def _narrow(a: np.ndarray) -> np.ndarray:
    """64-bit host data as 32-bit, as JAX takes it with x64 off."""
    a = np.asarray(a)
    return a.astype(_X64_OFF[a.dtype]) if a.dtype in _X64_OFF else a


def _scatter_add(size: int, flat: np.ndarray, vals: np.ndarray, dtype, device) -> torch.Tensor:
    """A [size] tensor on `device` with `vals` added at `flat` (out-of-range
    indices dropped)."""
    flat = np.asarray(flat, np.int64)
    keep = (flat >= 0) & (flat < size)
    vals = np.asarray(vals)
    if not keep.all():
        flat, vals = flat[keep], vals[keep]
    out = torch.zeros(size, dtype=dtype, device=device)
    return out.index_put_((_to_device(flat, device),), _to_device(vals, device, dtype), accumulate=True)


def csr_to_dense_device(
    mat: sparse.spmatrix,
    dtype: torch.dtype = torch.float32,
    pad_rows_to: int = 1,
    pad_cols_to: int = 1,
    device="cuda",
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """A sparse matrix as a zero-padded dense tensor on `device`, built there
    from its nonzeros: (dense [padded R, padded C], (R, C))."""
    mat = mat.tocoo()
    R, C = mat.shape
    Rp = _pad_to_multiple(max(R, 1), pad_rows_to)
    Cp = _pad_to_multiple(max(C, 1), pad_cols_to)
    flat = mat.row.astype(np.int64) * Cp + mat.col.astype(np.int64)
    return _scatter_add(Rp * Cp, flat, _narrow(mat.data), dtype, device).reshape(Rp, Cp), (R, C)


def layer_to_device(
    adata,
    layer: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    pad_rows_to: int = 1,
    pad_cols_to: int = 1,
    device="cuda",
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """An AnnData layer as a zero-padded dense tensor on `device`:
    (dense [padded R, padded C], (R, C))."""
    from ..configuration import SKM

    X = SKM.select_layer_data(adata, layer)
    if sparse.issparse(X):
        return csr_to_dense_device(X, dtype, pad_rows_to, pad_cols_to, device)
    X = np.asarray(X)
    R, C = X.shape
    Rp = _pad_to_multiple(max(R, 1), pad_rows_to)
    Cp = _pad_to_multiple(max(C, 1), pad_cols_to)
    out = torch.zeros((Rp, Cp), dtype=dtype, device=device)
    out[:R, :C] = _to_device(_narrow(X), device, dtype)
    return out, (R, C)


def segment_sum_device(values, segment_ids, num_segments: int, device="cuda") -> torch.Tensor:
    """The sums of `values` over `segment_ids` on `device`, [num_segments,
    ...] (ids outside [0, num_segments) dropped)."""
    values = values if isinstance(values, torch.Tensor) else _to_device(_narrow(values), device)
    ids = segment_ids if isinstance(segment_ids, torch.Tensor) else _to_device(np.asarray(segment_ids), device)
    ids = ids.to(device=values.device, dtype=torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids[keep], values[keep])


def points_to_raster(
    x: np.ndarray,
    y: np.ndarray,
    counts: np.ndarray,
    shape: Tuple[int, int],
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> torch.Tensor:
    """(x, y, count) reads summed into a dense [H, W] raster on `device`
    (what the reference builds on the host as
    ``csr_matrix((count, (x, y)))``, reference spateo/io/bgi.py:186-213)."""
    H, W = shape
    flat = np.asarray(x).astype(np.int32).astype(np.int64) * W + np.asarray(y).astype(np.int32)
    return _scatter_add(H * W, flat, _narrow(counts), dtype, device).reshape(H, W)


def adata_from_reference(adata) -> AnnData:
    """The port's `AnnData` holding copies of a `spateo_tpu` AnnData's X,
    layers, obs, var, uns, obsm, varm, obsp and varp (dense or sparse)."""

    def _copy(x):
        return x.copy() if sparse.issparse(x) else np.array(x)

    def _copies(d):
        return {k: _copy(v) for k, v in d.items()}

    return AnnData(
        X=None if adata.X is None else _copy(adata.X),
        obs=adata.obs.copy(),
        var=adata.var.copy(),
        uns=_deepcopy_uns(dict(adata.uns)),
        layers=_copies(adata.layers),
        obsm=_copies(adata.obsm),
        varm=_copies(adata.varm),
        obsp=_copies(adata.obsp),
        varp=_copies(adata.varp),
    )


#: Positional parameters of `_morpho_em`, in order (both packages).
MORPHO_EM_ARGS = (
    "coordsA", "coordsB", "exp_a_rows", "exp_b_cols", "exp_A_feats", "exp_B_feats", "U", "GammaSparse",
    "batch_perm", "morton_rank_B", "inlier_A", "inlier_B", "inlier_P", "X_AI", "X_BI", "U_I",
    "probability_parameters", "sigma2_init", "samples_s",
)


def morpho_inputs_from_reference(m, em_args, em_kwargs) -> dict:
    """The state a `spateo_tpu` `Morpho_pairwise` solve hands its EM, as
    numpy, for the port's `alignment.methods.morpho._morpho_em`.

    `m` is the JAX package's solver after its pre-EM setup (coarse init,
    probability parameters, sigma2, U and factorisation); `em_args` and
    `em_kwargs` are the arguments its `run()` passed to the JAX `_morpho_em`
    (Morton-sorted coordsA after the coarse transform, coordsB, the
    expression factors, U, GammaSparse, the inlier arrays, the probability
    parameters, sigma2_init, samples_s and the batch permutation). Returns
    ``{"args": {name: array or tuple of arrays}, "static": {keyword: value},
    "invA": the inverse Morton permutation of the moving slice's rows}``;
    the JAX keyword `use_pallas_estep` becomes `use_kernel_estep`."""

    def host(x):
        if isinstance(x, (tuple, list)):
            return tuple(host(v) for v in x)
        return np.array(x)

    args = {name: host(v) for name, v in zip(MORPHO_EM_ARGS, em_args)}
    static = dict(em_kwargs)
    static["use_kernel_estep"] = bool(static.pop("use_pallas_estep", True))
    return {"args": args, "static": static, "invA": np.asarray(m._invA)}


def _host_copy(v):
    """A host copy of a result value: containers recursively, arrays (and
    device arrays) as numpy, scalars, strings and None as they are."""
    if isinstance(v, dict):
        return {k: _host_copy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host_copy(x) for x in v)
    if v is None or isinstance(v, (bool, int, float, str, np.generic)):
        return v
    return np.array(v)


def vfc_from_reference(res) -> dict:
    """A `spateo_tpu` SparseVFC result (its lazy dict, which materialises
    here) as the port's dict of numpy arrays and scalars, without the JAX
    package's `_device` handles."""
    return {k: _host_copy(v) for k, v in res.items() if k != "_device"}


#: The entries of a `spateo_tpu` Morpho `vecfld` that the port's consumers
#: read (BA_transform, get_P_chunk, the GP morphofield).
VECFLD_KEYS = (
    "R", "t", "optimal_R", "optimal_t", "init_R", "init_t", "beta", "Coff", "inducing_variables",
    "normalize_scales", "normalize_means", "normalize_c", "dissimilarity", "sigma2", "gamma", "NA",
    "sigma2_variance", "method", "norm_dict", "kernel_type", "kernel_dict",
)


def vecfld_from_reference(vecfld) -> dict:
    """A `spateo_tpu` Morpho `vecfld` (R, t, Coff, inducing_variables, beta,
    norm_dict, the init and optimal R and t, kernel_dict, ...) as numpy
    copies."""
    return {k: _host_copy(vecfld[k]) for k in VECFLD_KEYS if k in vecfld}


def music_state_from_reference(model) -> dict:
    """The design of a `spateo_tpu` `MuSIC` after `define_sig_inputs`, as
    copies for the port's `MuSIC.load_state`: X (with the intercept column),
    feature_names, targets_expr, coords, sample_names, ct_vec, x_chunk, the
    subsampling dictionaries (present after `run_subsample`), the
    membrane-bound, secreted and niche spatial weights (scipy CSR; None where
    the model type has none) and, where the model has them, its ligand and
    receptor expression frames (`ligands_expr`, `ligands_expr_nonlag`,
    `receptors_expr`)."""
    import copy

    adata = getattr(model, "adata", None)
    niche = None
    if adata is not None and "spatial_weights" in adata.obsp:
        niche = adata.obsp["spatial_weights"]

    def csr(w):
        return None if w is None else sparse.csr_matrix(w, copy=True)

    ct = getattr(model, "ct_vec", None)
    return {
        "X": np.array(model.X, dtype=float),
        "feature_names": list(model.feature_names),
        "targets_expr": model.targets_expr.copy(),
        "coords": np.array(model.coords, dtype=float),
        "sample_names": list(map(str, model.sample_names)),
        "ct_vec": None if ct is None else np.array(ct),
        "x_chunk": np.array(model.x_chunk),
        "subsampled": bool(getattr(model, "subsampled", False)),
        **{
            k: copy.deepcopy(getattr(model, k, {}))
            for k in ("subsampled_indices", "n_samples_subsampled", "subsampled_sample_names", "neighboring_unsampled")
        },
        "spatial_weights_membrane_bound": csr(getattr(model, "spatial_weights_membrane_bound", None)),
        "spatial_weights_secreted": csr(getattr(model, "spatial_weights_secreted", None)),
        "spatial_weights_niche": csr(niche),
        **{
            k: getattr(model, k).copy()
            for k in ("ligands_expr", "ligands_expr_nonlag", "receptors_expr")
            if getattr(model, k, None) is not None
        },
    }


NLPCA_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")


def nlpca_from_reference(params, device="cuda"):
    """The port's `tdr.NLPCA` module on `device` holding the weights of a
    `spateo_tpu` `NLPCA.params` (a dict of arrays `w1` ... `b4`), as float32
    copies."""
    from ..tdr.models.models_backbone.backbone_methods import NLPCA

    w = {k: np.array(params[k], dtype=np.float32) for k in NLPCA_KEYS}
    num_dim, nodes = w["w1"].shape
    solver = NLPCA(device=device).init_params(num_dim, nodes)
    with torch.no_grad():
        for k in NLPCA_KEYS:
            getattr(solver, k).copy_(_to_device(w[k], device))
    return solver


def siren_from_reference(params, w0: float = 5.0, device="cuda"):
    """The port's `tdr.interpolations.interpolation_dl.SIREN` on `device`
    holding a `spateo_tpu` SIREN's weights (`DeepInterpolation.params`: a
    list of {"W": [in, out], "b": [out]}), as float32 copies."""
    from ..tdr.interpolations.interpolation_dl import SIREN

    Ws = [np.array(p["W"], dtype=np.float32) for p in params]
    bs = [np.array(p["b"], dtype=np.float32) for p in params]
    model = SIREN([Ws[0].shape[0]] + [W.shape[1] for W in Ws], w0=w0, device=device)
    with torch.no_grad():
        for i, (W, b) in enumerate(zip(Ws, bs)):
            model.W[i].copy_(_to_device(W, device))
            model.b[i].copy_(_to_device(b, device))
    return model


def sgpr_params_from_reference(params, device="cuda"):
    """The port's `SGPRParams` on `device` holding a `spateo_tpu` SGPR's
    parameters (a dict with `log_ls`, `log_noise`, `log_amp` and `Z`), as
    float64 copies."""
    from ..tdr.interpolations.interpolation_gp import SGPRParams

    out = SGPRParams(np.array(params["Z"], dtype=np.float64), device=device)
    with torch.no_grad():
        for k in ("log_ls", "log_noise", "log_amp"):
            getattr(out, k).fill_(float(np.asarray(params[k])))
    return out


def gc_dec_from_reference(model, device="cuda"):
    """The port's `tools.cluster.spagcn_utils.simple_GC_DEC` on `device`
    holding a `spateo_tpu` head's GCN weight W and, once fitted, its centres
    mu (float32 copies); a head that has not been fitted carries W only."""
    from ..tools.cluster.spagcn_utils import simple_GC_DEC

    out = simple_GC_DEC(model.nfeat, model.nhid, alpha=model.alpha, device=device)
    W = model.params["W"] if getattr(model, "params", None) is not None else model.gc.weight
    with torch.no_grad():
        out.gc.weight.copy_(_to_device(np.array(W, dtype=np.float32), device))
    if getattr(model, "mu", None) is not None:
        out.mu = torch.nn.Parameter(_to_device(np.array(model.mu, dtype=np.float32), device))
    return out


def _f32(a, device) -> torch.Tensor:
    return _to_device(np.array(a, dtype=np.float32), device)


def _copy_into(params: torch.nn.Module, tree) -> None:
    """Copy the float32 leaves of a nested dict / list `tree` into the
    same-named parameters of `params`."""
    with torch.no_grad():
        for name, p in params.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[int(part)] if isinstance(leaf, (list, tuple)) else leaf[part]
            p.copy_(_f32(leaf, p.device))


def cast_params_from_reference(obj, device="cuda"):
    """A CAST-Mark weight dict (`external.cast._init_params`' {"W1", "W2"})
    as a dict of float32 tensors on `device`; or the port's
    `external.cast_model` module (GCNII, GCN, or CCA_SSG around either)
    holding a `spateo_tpu` one's weights."""
    from ..external import cast_model as cm

    if isinstance(obj, dict):
        return {k: _f32(v, device) for k, v in obj.items()}
    bb = getattr(obj, "backbone", None)
    src = bb if bb is not None else obj
    in_dim = (src.encoder.W if src.use_encoder else src.Ws[0]).shape[0]
    if hasattr(src, "alpha"):
        out = cm.GCNII(in_dim, src.hid_dim, src.n_layers, src.alpha, src.lambda_, src.use_encoder, device=device)
    else:
        out = cm.GCN(in_dim, src.hid_dim, src.n_layers, src.use_encoder, device=device)
    with torch.no_grad():
        for W_port, W in zip(out.Ws, src.Ws):
            W_port.copy_(_f32(W, device))
        if src.use_encoder:
            out.encoder.W.copy_(_f32(src.encoder.W, device))
            out.encoder.b.copy_(_f32(src.encoder.b, device))
    if bb is None:
        return out
    wrapper = cm.CCA_SSG(in_dim, src.hid_dim, src.n_layers, "GCNII" if hasattr(src, "alpha") else "GCN",
                         use_encoder=src.use_encoder, device=device)
    wrapper.backbone = out
    return wrapper


def stagate_params_from_reference(obj, device="cuda"):
    """A `spateo_tpu` `STAGATE.params` dict as a dict of float32 tensors on
    `device`; or the port's `STAGATE_Module` holding a `spateo_tpu`
    `STAGATE_Module`'s four convolutions."""
    from ..external.stagate import STAGATE_Module

    if isinstance(obj, dict):
        return {k: _f32(v, device) for k, v in obj.items()}
    out = STAGATE_Module((obj.conv1.in_channels, obj.conv1.out_channels, obj.conv2.out_channels), device=device)
    with torch.no_grad():
        for name in ("conv1", "conv2", "conv3", "conv4"):
            src, dst = getattr(obj, name), getattr(out, name)
            for attr in ("lin_src", "att_src", "att_dst"):
                getattr(dst, attr).copy_(_f32(getattr(src, attr), device))
    return out


def merfishvi_params_from_reference(params, model=None, device="cuda"):
    """A `spateo_tpu` MERFISHVI's or VAE-family model's nested param dict
    (`.params`) as the port's `external.merfishvi.ParamTree` of float32
    parameters on `device`; with `model` (the port's MERFISHVI or VAE-family
    model of the same layout), copied into its parameters in place, and the
    model returned."""
    from ..external.merfishvi import ParamTree

    if model is not None:
        _copy_into(model.params, params)
        return model

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [tree(v) for v in t]
        return torch.from_numpy(np.array(t, dtype=np.float32))

    return ParamTree(tree(params)).to(device)
