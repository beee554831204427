"""Variational inference for (zero-inflated) negative-binomial mixtures.

Counterpart of `spateo_tpu.segmentation.vi`: the MAP fit of the mixture's
exact marginal log-likelihood (softmax weights, total_count/logits NB, gate
logits for zero inflation), minimised with `torch.optim.Adam(lr=0.1)` and
autograd for `n_epochs` steps on ``device=``, where the JAX package runs
`optax.adam(0.1)` under `lax.scan`. The two are the same algorithm (eps 1e-8
after the square root, no eps inside it) with different rounding, so
fitted parameters agree to a tolerance and conditionals given the same
parameters agree closely. Initial values and downsamples come from numpy's
`default_rng(seed)` in the JAX package's order.

`run_vi` fits every density bin in one Adam loop (`_fit_mixtures`), where
the JAX package fits them one after another: the loss is the sum of each
bin's own mean, so each bin's parameters get their own bin's gradient and
Adam, elementwise, takes each bin's own step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.bridge import _to_device
from ..errors import SegmentationError
from ..ops.em import _bin_samples, _host, _tensors


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as logaddexp(x, 0), jax.nn.softplus's form."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _nb_logpmf_count_logits(x, total_count, logits):
    """log NB pmf with (total_count, logits): mean = count * exp(logits)."""
    log_p = -_softplus(-logits)
    log_1mp = -_softplus(logits)
    return (
        torch.lgamma(x + total_count)
        - torch.lgamma(total_count)
        - torch.lgamma(x + 1.0)
        + total_count * log_1mp
        + x * log_p
    )


def _zinb_logpmf(x, total_count, logits, gate_logits):
    nb = _nb_logpmf_count_logits(x, total_count, logits)
    log_gate = -_softplus(-gate_logits)
    log_1mgate = -_softplus(gate_logits)
    zero_case = torch.logaddexp(log_gate, log_1mgate + nb)
    return torch.where(x == 0, zero_case, log_1mgate + nb)


def _fit_mixtures(xs: List[np.ndarray], inits: List[Dict[str, np.ndarray]], n_epochs: int, zero_inflated: bool,
                  device, lr: float = 0.1):
    """Adam on the sum over mixtures of each one's negative mean marginal
    log-likelihood over its own samples (padded to one [B, S] batch).
    Returns (params {name: [B, n]} on the host, each mixture's loss at the
    last step), with one host read at the end."""
    B, S = len(xs), max(len(x) for x in xs)
    Xb = np.zeros((B, S), np.float32)
    maskb = np.zeros((B, S), bool)
    for b, x in enumerate(xs):
        Xb[b, : len(x)] = x
        maskb[b, : len(x)] = True
    X = _to_device(Xb, device)[:, :, None]
    mask = _to_device(maskb, device)
    n_b = _to_device(np.array([len(x) for x in xs], np.float32), device)
    names = ("w", "counts", "logits", "z") if zero_inflated else ("w", "counts", "logits")
    params = {
        k: _to_device(np.stack([np.asarray(i[k], np.float32) for i in inits]), device).requires_grad_(True) for k in names
    }
    opt = torch.optim.Adam(list(params.values()), lr=lr)

    def nll():
        log_w = torch.log_softmax(params["w"], dim=1)[:, None, :]
        counts = torch.exp(params["counts"])[:, None, :]
        logits = params["logits"][:, None, :]
        if zero_inflated:
            comp = _zinb_logpmf(X, counts, logits, params["z"][:, None, :])
        else:
            comp = _nb_logpmf_count_logits(X, counts, logits)
        lse = torch.logsumexp(log_w + comp, dim=2)  # [B, S]
        return -torch.sum(torch.where(mask, lse, 0.0), dim=1) / n_b

    losses = None
    for _ in range(n_epochs):
        opt.zero_grad(set_to_none=True)
        losses = nll()
        torch.sum(losses).backward()
        opt.step()
    last = losses.detach().cpu().numpy() if losses is not None else np.full(B, np.nan)
    return {k: v.detach().cpu().numpy() for k, v in params.items()}, last


def _train(mixtures: List["NegativeBinomialMixture"], n_epochs: int) -> np.ndarray:
    """Fit several mixtures (same `zero_inflated` and device) in one loop."""
    first = mixtures[0]
    inits = [dict(w=m._w0, counts=m._counts0, logits=m._logits0, z=m._z0) for m in mixtures]
    params, losses = _fit_mixtures([m.x for m in mixtures], inits, n_epochs, first.zero_inflated, first.device)
    for b, m in enumerate(mixtures):
        m._params = {k: v[b] for k, v in params.items()}
    return losses


class NegativeBinomialMixture:
    """(Zero-inflated) NB mixture fit by MAP on `device`."""

    def __init__(
        self,
        x: np.ndarray,
        n: int = 2,
        n_init: int = 5,
        w: Optional[np.ndarray] = None,
        mu: Optional[np.ndarray] = None,
        var: Optional[np.ndarray] = None,
        zero_inflated: bool = False,
        seed: Optional[int] = None,
        device="cuda",
    ):
        if not ((w is None) == (mu is None) and (w is None) == (var is None)):
            raise SegmentationError("All or none of `w`, `mu`, `var` must be provided.")
        if (w is not None) and (n != len(w) or n != len(mu) or n != len(var)):
            raise SegmentationError(f"`w`, `mu`, `var` must have length {n}.")
        self.x = np.asarray(x, dtype=np.float32).ravel()
        self.n = n
        self.zero_inflated = zero_inflated
        self.device = device
        rng = np.random.default_rng(seed)
        if w is not None:
            w = np.asarray(w, float)
            mu = np.asarray(mu, float)
            var = np.maximum(np.asarray(var, float), mu * 1.01 + 1e-6)
            # mean = counts p / (1 - p), var = mean / (1 - p), so p = 1 - mean / var
            p = 1 - mu / var
            counts = mu * (1 - p) / np.maximum(p, 1e-6)
            self._w0 = np.log(np.maximum(w, 1e-6))
            self._counts0 = np.log(np.maximum(counts, 1e-6))
            self._logits0 = np.log(np.maximum(p, 1e-6)) - np.log(np.maximum(1 - p, 1e-6))
        else:
            self._w0 = rng.normal(size=n)
            self._counts0 = rng.normal(size=n)
            self._logits0 = rng.normal(size=n)
        self._z0 = rng.normal(size=n) if zero_inflated else np.zeros(n)
        self._params = None

    def train(self, n_epochs: int = 500):
        return float(_train([self], n_epochs)[0])

    def get_params(self) -> Dict[str, np.ndarray]:
        if self._params is None:
            self.train()
        out = {"w": self._params["w"], "counts": np.exp(self._params["counts"]), "logits": self._params["logits"]}
        if self.zero_inflated:
            out["z"] = self._params["z"]
        return out

    @staticmethod
    def _conditionals(params, x: torch.Tensor, use_weights: bool = False) -> Tuple[torch.Tensor, ...]:
        """Per-component pmfs at `x` (a tensor), sorted by component mean."""
        w = np.asarray(params["w"], float)
        counts = np.asarray(params["counts"], float)
        logits = np.asarray(params["logits"], float)
        n = len(w)
        z = np.asarray(params.get("z", np.full(n, -np.inf)), float)
        gate = 1 / (1 + np.exp(-z))
        means = (1 - gate) * counts * np.exp(logits)
        weights = np.exp(w - w.max())
        weights = weights / weights.sum()
        x = x.to(torch.float32)
        f32 = lambda v: torch.tensor(np.float32(v), device=x.device)
        conds = []
        for i in sorted(range(n), key=lambda i: means[i]):
            if np.isfinite(z[i]):
                lp = _zinb_logpmf(x, f32(counts[i]), f32(logits[i]), f32(z[i]))
            else:
                lp = _nb_logpmf_count_logits(x, f32(counts[i]), f32(logits[i]))
            cond = torch.exp(lp)
            conds.append(cond * float(weights[i]) if use_weights else cond)
        return tuple(conds)

    @staticmethod
    def conditionals(params, x, use_weights: bool = False, device="cuda") -> Tuple[np.ndarray, ...]:
        """Per-component pmfs sorted by component mean, host arrays."""
        xt = x if isinstance(x, torch.Tensor) else _to_device(np.asarray(x, np.float32), device)
        return tuple(c.cpu().numpy() for c in NegativeBinomialMixture._conditionals(params, xt, use_weights))


def _conditionals_t(X: torch.Tensor, vi_results, bins: Optional[torch.Tensor] = None, use_weights: bool = False):
    """(background, cell) pmfs on X's device; per bin with `bins` (1 and 0
    outside them)."""
    if "counts" not in vi_results:
        if bins is None:
            raise SegmentationError("`vi_results` indicate binning was used, but `bins` was not provided")
        background = torch.ones_like(X, dtype=torch.float32)
        cell = torch.zeros_like(X, dtype=torch.float32)
        for label, params in vi_results.items():
            m = bins == label
            conds = NegativeBinomialMixture._conditionals(params, X, use_weights)
            background = torch.where(m, conds[0], background)
            cell = torch.where(m, conds[-1], cell)
        return background, cell
    conds = NegativeBinomialMixture._conditionals(vi_results, X, use_weights)
    return conds[0], conds[-1]


def conditionals(X, vi_results, bins=None, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Background and cell conditional pmfs from VI results, host arrays."""
    Xt, bt, _ = _tensors(X, bins, device)
    return tuple(c.cpu().numpy() for c in _conditionals_t(Xt, vi_results, bt))


def _confidence_t(X: torch.Tensor, vi_results, bins: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Posterior P(cell | UMI) from the VI mixture's weighted pmfs (NaN
    outside the bins, as `em.confidence`)."""
    bg, cell = _conditionals_t(X, vi_results, bins, use_weights=True)
    if bins is not None and "counts" not in vi_results:
        inside = torch.isin(bins, torch.as_tensor(list(vi_results), device=bins.device))
        bg, cell = torch.where(inside, bg, 0.0), torch.where(inside, cell, 0.0)
    return cell / (bg + cell)


def run_vi(
    X,
    downsample: Union[int, float] = 0.01,
    n_epochs: int = 500,
    bins=None,
    params: Union[Dict[str, Tuple[float, float]], Dict[int, Dict[str, Tuple[float, float]]]] = dict(
        w=(0.5, 0.5), mu=(10.0, 300.0), var=(20.0, 400.0)
    ),
    zero_inflated: bool = False,
    seed: Optional[int] = None,
    device="cuda",
) -> Union[Dict, Dict[int, Dict]]:
    """NB/ZINB mixture VI over the raster, per density bin (one fit a bin);
    host arrays of parameters."""
    X = _host(X)
    bins = None if bins is None else _host(bins)
    samples = _bin_samples(X, bins, params)
    downsample_scale = downsample <= 1
    rng = np.random.default_rng(seed)
    total = sum(len(s) for s in samples.values())
    mixtures = {}
    for label, _samples in samples.items():
        n_target = int(len(_samples) * downsample) if downsample_scale else int(downsample * (len(_samples) / total))
        if len(_samples) > n_target:
            _samples = rng.choice(_samples, n_target, replace=False)
        mixtures[label] = NegativeBinomialMixture(
            np.asarray(_samples), zero_inflated=zero_inflated, seed=seed, device=device, **params.get(label, params)
        )
    _train(list(mixtures.values()), n_epochs)
    results = {label: m.get_params() for label, m in mixtures.items()}
    return results if bins is not None else results[0]
