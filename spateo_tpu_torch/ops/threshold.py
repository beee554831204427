"""Otsu thresholding on the device, in plain PyTorch.

Counterpart of `_otsu_from_values` and `threshold_otsu` in
`spateo_tpu.ops.threshold`. The histogram is `torch.bincount`, which counts
exactly (the JAX package's one-hot matmul is a choice made for the TPU's
matrix unit). `edges`, `idx` and the between-class variance follow the JAX
package's f32 expressions term by term, and `argmax` takes the first
maximum, so the chosen bin matches. The running sums are `torch.cumsum`;
XLA's CPU backend sums in blocks of 16, so the two can differ in the last
bit of the class means, which moves the chosen bin only at a tie of that
size.
"""

from __future__ import annotations

import torch


def _otsu_from_values(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Otsu threshold over a flat f32 value array (a bin centre, 0-dim)."""
    dev = values.device
    span = torch.clamp_min(vmax - vmin, 1e-30)
    edges = vmin + span * torch.arange(nbins + 1, dtype=torch.float32, device=dev) / nbins
    centers = (edges[:-1] + edges[1:]) / 2
    idx = torch.clamp(((values - vmin) / span * nbins).to(torch.int32), 0, nbins - 1)
    hist = torch.bincount(idx, minlength=nbins).to(torch.float32)

    w0 = torch.cumsum(hist, 0)
    total = w0[-1]
    w1 = total - w0
    cm = torch.cumsum(hist * centers, 0)
    mu_total = cm[-1]
    mu0 = cm / torch.clamp_min(w0, 1e-30)
    mu1 = (mu_total - cm) / torch.clamp_min(w1, 1e-30)
    var_between = w0 * w1 * (mu0 - mu1) ** 2
    var_between = torch.where((w0 > 0) & (w1 > 0), var_between, torch.full_like(var_between, -torch.inf))
    return centers[torch.argmax(var_between)]


def threshold_otsu(X: torch.Tensor, nbins: int = 256) -> float:
    """Otsu's threshold (skimage-compatible semantics)."""
    values = X.to(torch.float32).ravel()
    return float(_otsu_from_values(values, values.min(), values.max(), nbins))
