"""Thresholds on the device, in plain PyTorch: Otsu, three-class Otsu,
the local (adaptive) surface, and the knee of the cumulative counts.

Counterpart of `spateo_tpu.ops.threshold`. The histogram is `torch.bincount`, which counts
exactly (the JAX package's one-hot matmul is a choice made for the TPU's
matrix unit). `edges`, `idx` and the between-class variance follow the JAX
package's f32 expressions term by term, and `argmax` takes the first
maximum, so the chosen bin matches. The running sums are `torch.cumsum`;
XLA's CPU backend sums in blocks of 16, so the two can differ in the last
bit of the class means, which moves the chosen bin only at a tie of that
size. `_multiotsu3` searches the same (t1 < t2) grid with the same f32
terms; `knee_threshold` is the JAX package's host numpy, as it was.
"""

from __future__ import annotations

import numpy as np
import torch

from .image import _as_tensor, conv2d


def _otsu_hist(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """The Otsu histogram of `values` over [vmin, vmax]: [nbins] int64 counts
    (exact, so counts of several shards add up to the whole's)."""
    span = torch.clamp_min(vmax - vmin, 1e-30)
    idx = torch.clamp(((values - vmin) / span * nbins).to(torch.int32), 0, nbins - 1)
    return torch.bincount(idx, minlength=nbins)


def _otsu_from_hist(hist: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """The Otsu threshold (a bin centre, 0-dim) of an `_otsu_hist` histogram."""
    dev = hist.device
    span = torch.clamp_min(vmax - vmin, 1e-30)
    edges = vmin + span * torch.arange(nbins + 1, dtype=torch.float32, device=dev) / nbins
    centers = (edges[:-1] + edges[1:]) / 2
    hist = hist.to(torch.float32)

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


def _otsu_from_values(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Otsu threshold over a flat f32 value array (a bin centre, 0-dim)."""
    return _otsu_from_hist(_otsu_hist(values, vmin, vmax, nbins), vmin, vmax, nbins)


def _values(X, device) -> torch.Tensor:
    """X as a flat f32 tensor (a host array goes to `device` first)."""
    return _as_tensor(X, device, torch.float32).ravel()


def threshold_otsu(X, nbins: int = 256, device="cuda") -> float:
    """Otsu's threshold (skimage-compatible semantics)."""
    values = _values(X, device)
    return float(_otsu_from_values(values, values.min(), values.max(), nbins))


def _multiotsu3(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor, nbins: int = 128) -> torch.Tensor:
    """Two thresholds splitting values into 3 classes by the largest
    between-class variance, searched over the whole (t1 < t2) grid; the
    lower edges of each upper class's first bin, [2] f32."""
    dev = values.device
    span = torch.clamp_min(vmax - vmin, 1e-30)
    edges = vmin + span * torch.arange(nbins + 1, dtype=torch.float32, device=dev) / nbins
    centers = (edges[:-1] + edges[1:]) / 2
    idx = torch.clamp(((values - vmin) / span * nbins).to(torch.int32), 0, nbins - 1)
    hist = torch.bincount(idx, minlength=nbins).to(torch.float32)
    p = hist / torch.clamp_min(torch.sum(hist), 1.0)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    P = torch.cat([zero, torch.cumsum(p, 0)])  # P[i] = sum p[:i]
    S = torch.cat([zero, torch.cumsum(p * centers, 0)])
    t1 = torch.arange(nbins, device=dev)[:, None]  # class 0 = [0, t1)
    t2 = torch.arange(nbins, device=dev)[None, :]  # class 1 = [t1, t2), class 2 = [t2, nbins)
    w0, s0 = P[t1] - P[0], S[t1] - S[0]
    w1, s1 = P[t2] - P[t1], S[t2] - S[t1]
    w2, s2 = P[nbins] - P[t2], S[nbins] - S[t2]
    mu = S[-1]

    def term(w, s):
        return torch.where(w > 0, s * s / torch.clamp_min(w, 1e-30), 0.0)

    sigma_b = term(w0, s0) + term(w1, s1) + term(w2, s2) - mu * mu
    valid = (t1 < t2) & (w0 > 0) & (w1 > 0) & (w2 > 0)
    flat = torch.argmax(torch.where(valid, sigma_b, -torch.inf))
    return torch.stack([edges[flat // nbins], edges[flat % nbins]])


def threshold_multiotsu(X, classes: int = 3, nbins: int = 128, device="cuda") -> np.ndarray:
    """Multi-Otsu thresholds (classes - 1 values, host array): 2 and 3
    classes directly, more by recursive splitting, as in the JAX package."""
    values = _values(X, device)
    if classes == 2:
        return np.array([threshold_otsu(values, nbins)])
    if classes == 3:
        return _multiotsu3(values, values.min(), values.max(), nbins).cpu().numpy()
    t = threshold_otsu(values, nbins)
    lo, hi = values[values < t], values[values >= t]
    left = threshold_multiotsu(lo, classes - 2, nbins) if classes - 2 >= 2 else np.array([])
    right = threshold_multiotsu(hi, classes - 2, nbins) if classes - 2 >= 2 else np.array([])
    return np.sort(np.concatenate([left, [t], right]))


def threshold_local(X, k: int, method: str = "gaussian", offset: float = 0.0, device="cuda") -> torch.Tensor:
    """Adaptive local threshold surface (skimage.filters.threshold_local
    semantics): the local weighted mean minus `offset`, a tensor."""
    if method == "gaussian":
        local_mean = conv2d(X, k, mode="gauss", device=device)
    elif method == "mean":
        local_mean = conv2d(X, k, mode="square", device=device) / float(k * k)
    else:
        raise ValueError(f"unsupported method {method}")
    return local_mean - offset


def knee_threshold(X, n_bins: int = 256, clip: int = 5) -> float:
    """Knee of the cumulative-count curve (kneedle, concave and increasing),
    on the host."""
    X = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
    _X = X.astype(int)
    if np.array_equal(X, _X):
        x = np.sort(np.unique(_X)).astype(float)
    else:
        x = np.linspace(X.min(), X.max(), n_bins)
    y = np.searchsorted(np.sort(X.ravel()), x, side="right") / X.size
    x, y = x[clip:], y[clip:]
    if len(x) < 3:
        return float(x[-1]) if len(x) else float(X.max())
    xn = (x - x.min()) / max(x.max() - x.min(), 1e-30)
    yn = (y - y.min()) / max(y.max() - y.min(), 1e-30)
    return float(x[int(np.argmax(yn - xn))])
