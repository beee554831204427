"""Host <-> card: numpy to device tensors, and state carried over from the
JAX package.

`to_device` uploads through pinned host memory with ``non_blocking=True``, so
the copy is asynchronous on the current stream. `adata_from_reference` builds
the port's `AnnData` from an `AnnData` of `spateo_tpu` by reading its numpy
fields, duck-typed, so that this module never imports the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy import sparse

from .anndata import AnnData, _deepcopy_uns


def to_device(x, device="cuda", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Move a host array (or tensor) to `device`, optionally cast to `dtype`.

    A host array bound for the card goes through pinned memory and an
    asynchronous copy; the cast, if any, runs on the device."""
    device = torch.device(device)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t if dtype is None else t.to(dtype)


def adata_from_reference(adata) -> AnnData:
    """The port's `AnnData` holding copies of a `spateo_tpu` AnnData's X,
    layers, obs, var and uns."""

    def _copy(x):
        return x.copy() if sparse.issparse(x) else np.array(x)

    return AnnData(
        X=None if adata.X is None else _copy(adata.X),
        obs=adata.obs.copy(),
        var=adata.var.copy(),
        uns=_deepcopy_uns(dict(adata.uns)),
        layers={k: _copy(v) for k, v in adata.layers.items()},
    )
