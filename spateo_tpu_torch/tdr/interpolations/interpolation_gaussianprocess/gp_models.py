"""GP model classes (parity surface: reference gp_models.py): the exact model
solves the full kernel system on the host, as in the JAX package; the
inducing-point model is the SGPR of `interpolation_gp` on a device."""

from __future__ import annotations

import numpy as np

from ....core.bridge import _to_device


class Exact_GPModel:
    """Exact GP regression (parity: reference gp_models.py Exact_GPModel),
    host numpy; suitable for small N."""

    def __init__(self, train_x, train_y, lengthscale: float = 1.0, noise: float = 1e-2):
        self.train_x = np.asarray(train_x, float)
        self.train_y = np.asarray(train_y, float)
        self.lengthscale = lengthscale
        self.noise = noise
        self._alpha = None

    def fit(self):
        X = self.train_x
        d2 = ((X[:, None] - X[None, :]) ** 2).sum(-1)
        K = np.exp(-d2 / (2 * self.lengthscale**2))
        self._alpha = np.linalg.solve(K + self.noise * np.eye(len(X)), self.train_y)
        return self

    def predict(self, x):
        if self._alpha is None:
            self.fit()
        x = np.asarray(x, float)
        d2 = ((x[:, None] - self.train_x[None, :]) ** 2).sum(-1)
        return np.exp(-d2 / (2 * self.lengthscale**2)) @ self._alpha


class Approx_GPModel:
    """Inducing-point GP (parity: reference gp_models.py Approx_GPModel),
    the SGPR collapsed bound fitted on `device`."""

    def __init__(self, inducing_points, lengthscale: float = 1.0, device="cuda"):
        self.inducing_points = np.asarray(inducing_points, float)
        self.lengthscale = lengthscale
        self.device = device
        self.params = None

    def fit(self, X, Y, n_epochs: int = 200, lr: float = 0.05, seed: int = 0):
        from ..interpolation_gp import _fit_sgpr

        self.params, _ = _fit_sgpr(np.asarray(X, np.float32), np.asarray(Y, np.float32),
                                   self.inducing_points.astype(np.float32), n_epochs=n_epochs, lr=lr,
                                   device=self.device)
        self._XY = (_to_device(np.asarray(X, np.float64), self.device), _to_device(np.asarray(Y, np.float64), self.device))
        return self

    def predict(self, x):
        from ..interpolation_gp import _sgpr_predict

        X, Y = self._XY
        return _sgpr_predict(self.params, X, Y, _to_device(np.asarray(x, np.float64), self.device)).cpu().numpy()
