"""Deep-learning interpolation (MLP / SIREN)
(capability parity: reference spateo/tdr/interpolations/interpolation_dl.py:13
+ interpolation_deeplearn/deep_interpolation.py:20; counterpart of
`spateo_tpu.tdr.interpolations.interpolation_dl`).

`SIREN` is an `nn.Module` with the JAX package's layout and init bounds
(first layer uniform in +-1/fan_in, the others in +-sqrt(6/fan_in)/w0, zero
biases; weights stored [in, out]), drawn from ``torch.Generator().
manual_seed(seed)``. `DeepInterpolation.train` fits it with ``torch.optim.
Adam`` on minibatches whose indices come from a ``torch.Generator`` on the
device seeded with the same seed (or from `batch_indices`); `siren_train`
runs the `max_iter` steps with no host read and `_fit_siren` reads the losses
once after the loop (`_fit_siren.host_reads`). JAX's own draws cannot be
repeated here: `core.bridge.siren_from_reference` carries its weights over.
The building blocks (`SineLayer`, `A`, `B`, `h`, `MainFlow`) are modules
drawn from torch generators; `DataSampler` and `subset_best_samples` are
host code.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import pandas as pd
import torch
from torch import nn

from ...core.anndata import AnnData
from ...core.bridge import _to_device
from ...logging import logger_manager as lm


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=generator)


class SIREN(nn.Module):
    """Coordinate network sin(w0 (x W1 + b1)) -> sin(h W + b) ... -> linear,
    of layer widths `sizes` (the JAX package's `_init_siren` /
    `_siren_forward`, w0 = 5)."""

    def __init__(self, sizes: Sequence[int], seed: int = 0, w0: float = 5.0, device="cuda"):
        super().__init__()
        self.w0 = w0
        gen = torch.Generator().manual_seed(int(seed))
        Ws, bs = [], []
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = (1.0 / a) if i == 0 else (float(np.sqrt(6.0 / a)) / w0)
            Ws.append(nn.Parameter(_uniform((a, b), bound, gen).to(device)))
            bs.append(nn.Parameter(torch.zeros(b, dtype=torch.float32, device=device)))
        self.W = nn.ParameterList(Ws)
        self.b = nn.ParameterList(bs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.W) - 1
        for i in range(last):
            z = h @ self.W[i] + self.b[i]
            h = torch.sin(self.w0 * z) if i == 0 else torch.sin(z)
        return h @ self.W[last] + self.b[last]


def siren_train(model: nn.Module, X: torch.Tensor, Y: torch.Tensor, n: int, lr: float = 1e-4,
                batch_size: int = 4096, generator: Optional[torch.Generator] = None,
                batch_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`n` Adam steps of the mean squared error on minibatches, with no host
    read: the [n] losses on the device. Step i's batch is row i of
    `batch_indices` when given, else ``min(batch_size, N)`` indices drawn
    with replacement from `generator` on the device."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = torch.empty(n, dtype=torch.float32, device=X.device)
    B = min(batch_size, X.shape[0])
    for i in range(n):
        idx = batch_indices[i] if batch_indices is not None else torch.randint(
            0, X.shape[0], (B,), generator=generator, device=X.device)
        opt.zero_grad(set_to_none=True)
        loss = ((model(X[idx]) - Y[idx]) ** 2).mean()
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return losses


def _fit_siren(model, Xn, Yn, max_iter, lr, batch_size, seed, device, batch_indices=None) -> np.ndarray:
    """`siren_train` on `device` from host arrays; the losses read once."""
    Xd, Yd = _to_device(Xn, device, torch.float32), _to_device(Yn, device, torch.float32)
    gen = torch.Generator(device=Xd.device)
    gen.manual_seed(int(seed))
    bi = None if batch_indices is None else _to_device(np.asarray(batch_indices, np.int64), device)
    losses = siren_train(model, Xd, Yd, max_iter, lr=lr, batch_size=batch_size, generator=gen, batch_indices=bi)
    _fit_siren.host_reads += 1
    return losses.cpu().numpy()


_fit_siren.host_reads = 0


class DeepInterpolation:
    """Coordinate-network interpolator (parity surface: reference
    deep_interpolation.py:20): a SIREN of `depth` hidden layers of width
    `hidden` on `device`. A `SIREN` passed as `model` is trained from its
    weights; otherwise one is drawn from `seed`."""

    def __init__(
        self,
        model=None,
        data_sampler=None,
        sirens: bool = True,
        enforce_positivity: bool = True,
        hidden: int = 256,
        depth: int = 4,
        seed: int = 0,
        device="cuda",
        **kwargs,
    ):
        self.sirens = sirens
        self.enforce_positivity = enforce_positivity
        self.hidden = hidden
        self.depth = depth
        self.seed = seed
        self.device = device
        self.model = model if isinstance(model, nn.Module) else None
        self.norm = None

    def train(self, X: np.ndarray, Y: np.ndarray, max_iter: int = 1000, lr: float = 1e-4, batch_size: int = 4096,
              batch_indices: Optional[np.ndarray] = None):
        X = np.asarray(X, np.float32)
        Y = np.asarray(Y, np.float32)
        x_mean, x_std = X.mean(0), X.std(0) + 1e-8
        y_mean, y_std = Y.mean(0), Y.std(0) + 1e-8
        self.norm = (x_mean, x_std, y_mean, y_std)
        Xn = (X - x_mean) / x_std
        Yn = (Y - y_mean) / y_std
        if self.model is None:
            sizes = [X.shape[1]] + [self.hidden] * self.depth + [Y.shape[1]]
            self.model = SIREN(sizes, seed=self.seed, device=self.device)
        losses = _fit_siren(self.model, Xn, Yn, max_iter, lr, batch_size, self.seed, self.device, batch_indices)
        lm.main_info(f"DeepInterpolation trained: mse {float(losses[0]):.4f} -> {float(losses[-1]):.4f}")
        return losses

    @torch.no_grad()
    def predict(self, Xnew: np.ndarray) -> np.ndarray:
        x_mean, x_std, y_mean, y_std = self.norm
        Xn = (np.asarray(Xnew, np.float32) - x_mean) / x_std
        pred = self.model(_to_device(Xn, self.device)).cpu().numpy() * y_std + y_mean
        if self.enforce_positivity:
            pred = np.maximum(pred, 0)
        return pred


# -- network building blocks + data plumbing (parity: reference
# interpolation_deeplearn/interpolation_nn.py SineLayer/MainFlow and
# deep_interpolation.py:371 DataSampler) ---------------------------------------


class SineLayer(nn.Module):
    """One SIREN layer sin(w0 (xW + b)) with the SIREN init scheme (parity
    surface: reference interpolation_nn.py SineLayer), W [in, out] drawn
    from ``torch.Generator().manual_seed(seed)``."""

    def __init__(self, in_features: int, out_features: int, is_first: bool = False, omega_0: float = 30.0,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.is_first = is_first
        self.omega_0 = omega_0
        bound = (1.0 / in_features) if is_first else (float(np.sqrt(6.0 / in_features)) / omega_0)
        gen = torch.Generator().manual_seed(int(seed))
        self.W = nn.Parameter(_uniform((in_features, out_features), bound, gen).to(device))
        self.b = nn.Parameter(torch.zeros(out_features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.omega_0 * (x @ self.W + self.b))


class _LeakyMLP(nn.Module):
    """Shared machinery for the reference's A/B lift/head blocks
    (interpolation_nn.py:10 `A`, :49 `B`): Linear -> hidden Linears -> out
    Linear with leaky-relu (0.2) activations, Glorot-normal weights drawn
    from ``torch.Generator().manual_seed(seed)``."""

    def __init__(self, in_dim: int, out_dim: int, hidden_features: int, hidden_layers: int, seed: int,
                 device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        sizes = [in_dim] + [hidden_features] * (hidden_layers + 1) + [out_dim]
        self.W = nn.ParameterList([
            nn.Parameter((torch.randn((a, b), generator=gen) * (2.0 / (a + b)) ** 0.5).to(device))
            for a, b in zip(sizes[:-1], sizes[1:])
        ])
        self.b = nn.ParameterList([nn.Parameter(torch.zeros(b, device=device)) for b in sizes[1:]])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for i in range(len(self.W)):
            out = out @ self.W[i] + self.b[i]
            if i < len(self.W) - 1:
                out = torch.nn.functional.leaky_relu(out, negative_slope=0.2)
        return out


class A(_LeakyMLP):
    """Input lift data_dim -> network_dim (parity surface: reference
    interpolation_nn.py:10 `A`; 256 hidden features, one hidden layer)."""

    def __init__(self, network_dim: int, data_dim: int, hidden_features: int = 256, hidden_layers: int = 1,
                 seed: int = 0, device="cuda"):
        super().__init__(data_dim, network_dim, hidden_features, hidden_layers, seed, device=device)
        self.name = "model/A"


class B(_LeakyMLP):
    """Output head network_dim -> data_dim (parity surface: reference
    interpolation_nn.py:49 `B`; 256 hidden features, three hidden layers)."""

    def __init__(self, network_dim: int, data_dim: int, hidden_features: int = 256, hidden_layers: int = 3,
                 seed: int = 0, device="cuda"):
        super().__init__(network_dim, data_dim, hidden_features, hidden_layers, seed, device=device)
        self.name = "model/B"


class h(nn.Module):
    """The main coordinate network (parity surface: reference
    interpolation_nn.py:132 `h`): SIREN sine layers when ``sirens=True``
    (first layer at first_omega_0), otherwise a leaky-relu MLP."""

    def __init__(
        self,
        input_network_dim: int,
        output_network_dim: int,
        hidden_features: int = 256,
        hidden_layers: int = 3,
        sirens: bool = False,
        first_omega_0: float = 30.0,
        hidden_omega_0: float = 30.0,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        self.sirens = bool(sirens)
        self.name = "model/h"
        if self.sirens:
            layers = [SineLayer(input_network_dim, hidden_features, is_first=True, omega_0=first_omega_0, seed=seed,
                                device=device)]
            layers += [
                SineLayer(hidden_features, hidden_features, is_first=False, omega_0=hidden_omega_0, seed=seed + 1 + i,
                          device=device)
                for i in range(hidden_layers)
            ]
            self.layers = nn.ModuleList(layers)
            gen = torch.Generator().manual_seed(int(seed) + 99)
            bound = float(np.sqrt(6.0 / hidden_features)) / hidden_omega_0
            self.out_W = nn.Parameter(_uniform((hidden_features, output_network_dim), bound, gen).to(device))
            self.out_b = nn.Parameter(torch.zeros(output_network_dim, device=device))
        else:
            self._mlp = _LeakyMLP(input_network_dim, output_network_dim, hidden_features, hidden_layers, seed,
                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sirens:
            return self._mlp(x)
        out = x
        for layer in self.layers:
            out = layer(out)
        return out @ self.out_W + self.out_b


class MainFlow(nn.Module):
    """The A -> h -> B composed flow of the deep interpolator (parity
    surface: reference interpolation_nn.py:220 `MainFlow`)."""

    def __init__(self, h, A=None, B=None):
        super().__init__()
        self.h = h
        self.A = A
        self.B = B

    def forward(self, t=None, x=None, freeze=None):
        out = x
        if self.A is not None:
            out = self.A(out)
        out = self.h(out)
        if self.B is not None:
            out = self.B(out)
        return out


class DataSampler:
    """Holds (X, Y) training pairs and yields random minibatches (parity
    surface: reference deep_interpolation.py:371 `DataSampler`), host code
    as in the JAX package."""

    def __init__(self, path_to_data=None, data=None, skey: str = "spatial", ekey: str = "M_s", wkey=None,
                 normalize_data: bool = False, number_of_random_points: int = 100, seed: int = 0):
        if path_to_data is not None:
            from scipy.io import loadmat

            mat = loadmat(path_to_data)
            X, Y = np.asarray(mat["X"]), np.asarray(mat["Y"])
        elif isinstance(data, dict):
            X, Y = np.asarray(data["X"]), np.asarray(data["Y"])
        elif data is not None:  # AnnData
            X = np.asarray(data.obsm[skey])
            Y = np.asarray(data.layers[ekey] if ekey in getattr(data, "layers", {}) else data.X)
            if hasattr(Y, "toarray"):
                Y = Y.toarray()
        else:
            raise ValueError("provide `path_to_data` or `data`")
        if X.shape[0] != Y.shape[0]:
            raise ValueError("X and Y must have equal rows")
        self.data = {"X": np.asarray(X, np.float32), "Y": np.asarray(Y, np.float32)}
        self.normalize_data = normalize_data
        if normalize_data:
            self.norm = (self.data["X"].mean(0), self.data["X"].std(0) + 1e-8)
            self.data["X"] = (self.data["X"] - self.norm[0]) / self.norm[1]
        self.number_of_random_points = number_of_random_points
        self._rng = np.random.default_rng(seed)

    def generate_batch(self, batch_size: Optional[int] = None):
        n = self.data["X"].shape[0]
        b = min(batch_size or self.number_of_random_points, n)
        idx = self._rng.choice(n, b, replace=False)
        return self.data["X"][idx], self.data["Y"][idx]


# -- trainer loss factories (parity: reference
# interpolation_deeplearn/nn_losses.py:4-40) -------------------------------------


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def weighted_mean(x, weights):
    """Weighted mean; plain mean when weights is None (parity: nn_losses.py:4)."""
    x = _t(x)
    if weights is None:
        return x.mean()
    weights = _t(weights)
    return (weights * x).sum() / weights.sum()


def weighted_mad():
    """Mean absolute difference (weighted) factory (parity: nn_losses.py:11)."""
    return lambda source, target, weights: weighted_mean(torch.abs(_t(source) - _t(target)), weights)


def weighted_mse():
    """Mean squared error (weighted) factory (parity: nn_losses.py:16)."""
    return lambda source, target, weights: weighted_mean(
        torch.linalg.norm(_t(source) - _t(target), dim=1) ** 2, weights
    )


def _cosine(s, t):
    return (s * t).sum(-1) / (torch.linalg.norm(s, dim=-1) * torch.linalg.norm(t, dim=-1) + 1e-12)


def weighted_cosine_distance():
    """Cosine distance (weighted) factory (parity: nn_losses.py:21)."""
    return lambda source, target, weights: 1 - weighted_mean(_cosine(_t(source), _t(target)), weights)


def mad():
    """Mean absolute difference factory (parity: nn_losses.py:28)."""
    return lambda source, target: torch.abs(_t(source) - _t(target)).mean()


def mse():
    """Mean squared error factory (parity: nn_losses.py:33)."""
    return lambda source, target: (torch.linalg.norm(_t(source) - _t(target), dim=1) ** 2).mean()


def cosine_distance():
    """Cosine distance factory (parity: nn_losses.py:38)."""
    return lambda source, target: 1 - _cosine(_t(source), _t(target)).mean()


def subset_best_samples(best_sample_fraction, y_hat, y, loss_func):
    """Indices of the best-fit fraction of samples under `loss_func`
    (parity: reference deep_interpolation.py:339). Each sample is passed as
    a [1, D] row, so the row-wise factories work per sample; the weighted
    factories need their 3-argument signature bound first."""
    y_hat = np.asarray(y_hat)
    y = np.asarray(y)
    if y_hat.shape != y.shape:
        raise ValueError("The shape of the two arrays y_hat and y must be the same.")
    diff = np.asarray([float(loss_func(y_hat[i : i + 1], y[i : i + 1])) for i in range(y.shape[0])])
    return np.argsort(diff)[: int(best_sample_fraction * y.shape[0])]


def deep_intepretation(
    source_adata: Optional[AnnData] = None,
    target_points: Optional[np.ndarray] = None,
    keys: Union[str, list, None] = None,
    spatial_key: str = "spatial",
    layer: str = "X",
    max_iter: int = 1000,
    device="cuda",
    **kwargs,
) -> AnnData:
    """Learn a deep continuous expression field on `device` and evaluate it
    at target points (parity: interpolation_dl.py:13; the reference's
    spelling of 'interpretation' is preserved)."""
    from scipy.sparse import issparse

    X = np.asarray(source_adata.obsm[spatial_key], dtype=np.float32)
    keys = [keys] if isinstance(keys, str) else (list(keys) if keys else list(source_adata.var_names))
    V = source_adata[:, np.asarray(keys)].X if layer == "X" else source_adata[:, np.asarray(keys)].layers[layer]
    Y = (V.toarray() if issparse(V) else np.asarray(V)).astype(np.float32)

    model = DeepInterpolation(device=device, **kwargs)
    model.train(X, Y, max_iter=max_iter)
    target_points = np.asarray(target_points, dtype=np.float32)
    pred = model.predict(target_points)
    interp_adata = AnnData(
        X=pred,
        obs=pd.DataFrame(index=[f"target_{i}" for i in range(len(target_points))]),
        var=pd.DataFrame(index=keys),
    )
    interp_adata.obsm[spatial_key] = target_points
    interp_adata.uns["__type"] = "UMI"
    return interp_adata
