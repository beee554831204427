"""GLM link functions and distribution families
(capability parity: reference spateo/tools/CCI_effects_modeling/distributions.py:16-1396
— vendored statsmodels-like Link/Variance/Distribution classes).

A copy of `spateo_tpu.tools.CCI_effects_modeling.distributions` (numpy and
scipy only), kept here so that the port never imports the JAX package. The
host side of MuSIC (deviance, log-likelihood, predictions) uses these; the
batched IWLS on the device has its own log-link formulas
(`regression_utils._glm_funcs`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import special

EPS = np.finfo(float).eps


# ---------------------------------------------------------------------------
# Link functions
# ---------------------------------------------------------------------------
class Link:
    def __call__(self, mu):
        raise NotImplementedError

    def inverse(self, z):
        raise NotImplementedError

    def deriv(self, mu):
        """d eta / d mu."""
        raise NotImplementedError

    def inverse_deriv(self, z):
        """d mu / d eta."""
        return 1.0 / self.deriv(self.inverse(z))


class identity(Link):
    def __call__(self, mu):
        return mu

    def inverse(self, z):
        return z

    def deriv(self, mu):
        return np.ones_like(np.asarray(mu, dtype=float))


class log(Link):
    def __call__(self, mu):
        return np.log(np.clip(mu, EPS, None))

    def inverse(self, z):
        return np.exp(np.clip(z, -50, 50))

    def deriv(self, mu):
        return 1.0 / np.clip(mu, EPS, None)


class logit(Link):
    def __call__(self, mu):
        mu = np.clip(mu, EPS, 1 - EPS)
        return np.log(mu / (1 - mu))

    def inverse(self, z):
        z = np.clip(z, -50, 50)
        return 1.0 / (1.0 + np.exp(-z))

    def deriv(self, mu):
        mu = np.clip(mu, EPS, 1 - EPS)
        return 1.0 / (mu * (1 - mu))


# ---------------------------------------------------------------------------
# Variance functions
# ---------------------------------------------------------------------------
class VarianceFunction:
    def __call__(self, mu):
        raise NotImplementedError


class constant_var(VarianceFunction):
    def __call__(self, mu):
        return np.ones_like(np.asarray(mu, dtype=float))


class mu_var(VarianceFunction):
    def __call__(self, mu):
        return np.clip(mu, EPS, None)


class mu_squared_var(VarianceFunction):
    def __call__(self, mu):
        return np.clip(mu, EPS, None) ** 2


class binary_var(VarianceFunction):
    def __call__(self, mu):
        mu = np.clip(mu, EPS, 1 - EPS)
        return mu * (1 - mu)


class nb_var(VarianceFunction):
    def __init__(self, disp: float = 1.0):
        self.disp = disp

    def __call__(self, mu):
        mu = np.clip(mu, EPS, None)
        return mu + self.disp * mu**2


# ---------------------------------------------------------------------------
# Distribution families
# ---------------------------------------------------------------------------
class Distribution:
    """Base family (parity surface: reference distributions.py Distribution)."""

    link: Link
    variance: VarianceFunction

    def initial_predictions(self, y):
        return (np.asarray(y, dtype=float) + np.mean(y)) / 2.0

    def deviance(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        raise NotImplementedError

    def deviance_residuals(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        raise NotImplementedError

    def log_likelihood(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        raise NotImplementedError

    def clip(self, vals):
        """Clip to the valid positive range (reference distributions.py clip)."""
        return np.clip(vals, EPS, 1e8)

    def predict(self, eta):
        return self.link.inverse(eta)

    def get_predictors(self, mu):
        return self.link(mu)

    def weights(self, mu):
        """IRLS weights 1 / (V(mu) * g'(mu)^2)."""
        return 1.0 / (self.variance(mu) * self.link.deriv(mu) ** 2 + EPS)


class Gaussian(Distribution):
    """(parity: reference distributions.py:880)."""

    def __init__(self, link: Optional[Link] = None):
        self.link = link or identity()
        self.variance = constant_var()

    def deviance(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        """Gaussian deviance (reference distributions.py:906-929)."""
        if freq_weights is None:
            freq_weights = 1.0
        return float(np.sum(freq_weights * (np.asarray(endog, float) - fitted) ** 2) / scale)

    def deviance_residuals(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        """Gaussian deviance residuals (reference distributions.py:931-953)."""
        if freq_weights is None:
            freq_weights = 1.0
        return (freq_weights * (np.asarray(endog, float) - fitted) / np.sqrt(self.variance(fitted))) / scale

    def log_likelihood(self, endog, fitted, freq_weights=None, scale: Optional[float] = None):
        """Gaussian log-likelihood (reference distributions.py:955-977;
        scale=None estimates it from the residual variance)."""
        if freq_weights is None:
            freq_weights = 1.0
        endog = np.asarray(endog, float)
        if scale is None:
            scale = float(np.var(endog - fitted)) + EPS
        return float(
            np.sum(
                freq_weights
                * ((endog * fitted - fitted**2 / 2) / scale - endog**2 / (2 * scale) - 0.5 * np.log(2 * np.pi * scale))
            )
        )


class Poisson(Distribution):
    """(parity: reference distributions.py:763)."""

    def __init__(self, link: Optional[Link] = None):
        self.link = link or log()
        self.variance = mu_var()

    def deviance(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        """Poisson deviance (reference distributions.py:801-826 — the
        reference's form 2*sum(w*y*log(y/mu))/scale, which drops the
        sum(y - mu) term that vanishes under a canonically-linked fit)."""
        if freq_weights is None:
            freq_weights = 1.0
        endog = np.asarray(endog, dtype=float)
        fitted = self.clip(fitted)
        endog_fitted = self.clip(endog / fitted)
        return float(2 * np.sum(freq_weights * endog * np.log(endog_fitted)) / scale)

    def deviance_residuals(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        """Poisson deviance residuals (reference distributions.py:827-852)."""
        if freq_weights is None:
            freq_weights = 1.0
        endog = np.asarray(endog, dtype=float)
        fitted = self.clip(fitted)
        endog_fitted = self.clip(endog / fitted)
        inner = 2 * freq_weights * (endog * np.log(endog_fitted) - (endog - fitted))
        return np.sign(endog - fitted) * np.sqrt(np.maximum(inner, 0.0)) / scale

    def log_likelihood(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        """Poisson log-likelihood (reference distributions.py:854-878)."""
        if freq_weights is None:
            freq_weights = 1.0
        endog = np.asarray(endog, dtype=float)
        fitted = self.clip(fitted)
        ll = np.sum(freq_weights * (endog * np.log(fitted) - fitted - special.gammaln(endog + 1)))
        return float(scale * ll)


class NegativeBinomial(Distribution):
    """NB2 with fixed dispersion (parity: reference distributions.py:1250)."""

    def __init__(self, link: Optional[Link] = None, disp: float = 1.0):
        self.link = link or log()
        self.disp = disp
        self.variance = nb_var(disp)

    def deviance(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        """NB deviance (reference distributions.py:1295-1331 verbatim,
        including its use of the dispersion attribute directly)."""
        if freq_weights is None:
            freq_weights = 1.0
        endog = np.asarray(endog, dtype=float)
        fitted = self.clip(fitted)
        endog_fitted = self.clip(endog / fitted)
        dispersion = self.disp
        return float(
            2
            * np.sum(
                freq_weights
                * (
                    endog * np.log(endog_fitted + dispersion)
                    - endog * np.log(dispersion)
                    - np.log(1 + fitted / dispersion)
                )
            )
            / scale
        )

    def deviance_residuals(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        """NB deviance residuals (reference distributions.py:1333-1345 —
        upstream reuses the Poisson residual form here)."""
        if freq_weights is None:
            freq_weights = 1.0
        endog = np.asarray(endog, dtype=float)
        fitted = self.clip(fitted)
        endog_fitted = self.clip(endog / fitted)
        inner = 2 * freq_weights * (endog * np.log(endog_fitted) - (endog - fitted))
        return np.sign(endog - fitted) * np.sqrt(np.maximum(inner, 0.0)) / scale

    def log_likelihood(self, endog, fitted, freq_weights=None, scale: float = 1.0):
        """NB log-likelihood (reference distributions.py:1347-1378 verbatim:
        the dispersion attribute plays the size role r)."""
        if freq_weights is None:
            freq_weights = 1.0
        dispersion = self.disp
        endog = self.clip(np.asarray(endog, dtype=float))
        fitted = self.clip(fitted)
        return float(
            np.sum(
                freq_weights
                * (
                    special.gammaln(dispersion + endog)
                    - special.gammaln(dispersion)
                    - special.gammaln(endog + 1)
                    + dispersion * np.log(dispersion / (dispersion + fitted * scale))
                    + endog * np.log(fitted * scale / (dispersion + fitted * scale))
                )
            )
        )


class Gamma(Distribution):
    """(parity: reference distributions.py:979)."""

    def __init__(self, link: Optional[Link] = None):
        self.link = link or log()
        self.variance = mu_squared_var()

    def deviance(self, endog, mu):
        endog = np.clip(np.asarray(endog, dtype=float), EPS, None)
        mu = np.clip(mu, EPS, None)
        return float(2 * np.sum((endog - mu) / mu - np.log(endog / mu)))

    def log_likelihood(self, endog, mu, scale: float = 1.0):
        endog = np.clip(np.asarray(endog, dtype=float), EPS, None)
        mu = np.clip(mu, EPS, None)
        return float(np.sum(-endog / mu - np.log(mu) + (scale - 1) * np.log(endog) - special.gammaln(scale)))


class Binomial(Distribution):
    """(parity: reference distributions.py:1108)."""

    def __init__(self, link: Optional[Link] = None):
        self.link = link or logit()
        self.variance = binary_var()

    def initial_predictions(self, y):
        return (np.asarray(y, dtype=float) + 0.5) / 2.0

    def deviance(self, endog, mu):
        endog = np.asarray(endog, dtype=float)
        mu = np.clip(mu, EPS, 1 - EPS)
        t1 = np.where(endog > 0, endog * np.log(np.clip(endog, EPS, None) / mu), 0.0)
        t2 = np.where(endog < 1, (1 - endog) * np.log(np.clip(1 - endog, EPS, None) / (1 - mu)), 0.0)
        return float(2 * np.sum(t1 + t2))

    def log_likelihood(self, endog, mu):
        mu = np.clip(mu, EPS, 1 - EPS)
        return float(np.sum(endog * np.log(mu) + (1 - endog) * np.log(1 - mu)))


# -- reference-named aliases / extra links (reference distributions.py
# exposes capitalized Link classes and Power/sqrt/inverse_power variants) ---


class Power(Link):
    """Power link g(mu) = mu**power (parity: reference distributions.py
    Power)."""

    def __init__(self, power: float = 1.0):
        self.power = power

    def __call__(self, mu):
        return np.power(np.asarray(mu, float), self.power)

    def inverse(self, z):
        return np.power(np.asarray(z, float), 1.0 / self.power)

    def deriv(self, mu):
        return self.power * np.power(np.asarray(mu, float), self.power - 1)

    def inverse_deriv(self, z):
        return np.power(np.asarray(z, float), (1.0 / self.power) - 1) / self.power


class sqrt(Power):
    """Square-root link (parity: reference distributions.py sqrt)."""

    def __init__(self):
        super().__init__(power=0.5)


class inverse_power(Power):
    """Reciprocal link (parity: reference distributions.py inverse_power)."""

    def __init__(self):
        super().__init__(power=-1.0)


# capitalized aliases the reference also exports
Log = log
Logit = logit
Binomial_Variance = binary_var
Negative_Binomial_Variance = nb_var


class Power_Variance(VarianceFunction):
    """V(mu) = mu**power (parity: reference distributions.py
    Power_Variance)."""

    def __init__(self, power: float = 1.0):
        self.power = power

    def __call__(self, mu):
        return np.power(np.abs(np.asarray(mu, float)), self.power)

    def deriv(self, mu):
        return self.power * np.power(np.abs(np.asarray(mu, float)), self.power - 1)


# ---------------------------------------------------------------------------
# Reference-named link / variance classes (distributions.py:80 Logit,
# :288 Log, :480 Binomial_Variance, :542 Negative_Binomial_Variance — the
# statsmodels-style capitalized API the reference exposes alongside the
# family classes). second_deriv is analytic here (the reference numerically
# differentiates deriv with statsmodels' complex-step helper).
# ---------------------------------------------------------------------------
MAX = np.finfo(np.float32).max


class Logit(logit):
    """Logit link with the reference's clip/second_deriv surface
    (reference distributions.py:80-238)."""

    def clip(self, vals: np.ndarray) -> np.ndarray:
        return np.clip(vals, EPS, 1 - EPS)

    def second_deriv(self, p: np.ndarray) -> np.ndarray:
        # d/dp [1/(p(1-p))] = (2p - 1) / (p^2 (1-p)^2)
        p = self.clip(np.asarray(p, float))
        return (2 * p - 1) / (p**2 * (1 - p) ** 2)


class Log(log):
    """Log link with the reference's clip/second_deriv surface
    (reference distributions.py:288-360)."""

    def clip(self, vals: np.ndarray) -> np.ndarray:
        return np.clip(vals, EPS, MAX)

    def second_deriv(self, y: np.ndarray) -> np.ndarray:
        # d/dy [1/y] = -1/y^2
        y = self.clip(np.asarray(y, float))
        return -1.0 / y**2


class Binomial_Variance:
    """V(fitted) = p (1 - p) n with p = fitted / n
    (reference distributions.py:480-530)."""

    def __init__(self, n: int = 1):
        self.n = n

    def clip(self, vals: np.ndarray) -> np.ndarray:
        return np.clip(vals, EPS, 1 - EPS)

    def __call__(self, fitted: np.ndarray) -> np.ndarray:
        p = self.clip(np.asarray(fitted, float) / self.n)
        return p * (1 - p) * self.n

    def deriv(self, fitted: np.ndarray) -> np.ndarray:
        return 1 - 2 * self.clip(np.asarray(fitted, float)) / self.n


binom_variance = Binomial_Variance()


class Negative_Binomial_Variance:
    """V(fitted) = fitted + disp * fitted**2
    (reference distributions.py:542-597)."""

    def __init__(self, disp: float = 0.5):
        self.disp = disp

    def clip(self, vals: np.ndarray) -> np.ndarray:
        return np.clip(vals, EPS, MAX)

    def __call__(self, fitted: np.ndarray) -> np.ndarray:
        fitted = self.clip(np.asarray(fitted, float))
        return fitted + self.disp * fitted**2

    def deriv(self, fitted: np.ndarray) -> np.ndarray:
        return 1 + self.disp * 2 * self.clip(np.asarray(fitted, float))


nbinom_variance = Negative_Binomial_Variance()


# module-level variance instances (parity: reference distributions.py:458-477)
fitted = Power_Variance()
fitted.__doc__ = "Variance equal in magnitude to the mean: V(mu) = |mu|."
fitted_squared = Power_Variance(power=2)
fitted_squared.__doc__ = "Variance equal to the squared mean: V(mu) = |mu|**2."
fitted_cubed = Power_Variance(power=3)
fitted_cubed.__doc__ = "Variance equal to the cubed mean: V(mu) = |mu|**3."
