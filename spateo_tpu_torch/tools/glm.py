"""GLM-based differential expression (capability parity: reference
spateo/tools/glm.py:17,142,159,189) — statsmodels/patsy-free.

The NB2 GLM is fit by the framework's own IWLS; the formula interface
supports `~cr(<var>, df=N)` natural-spline terms, `~<categorical>` factors
and `~1` null models.

Counterpart of `spateo_tpu.tools.glm`: host code, copied, on the port's
`regression_utils.iwls` and `distributions.NegativeBinomial`.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import pandas as pd
from scipy import stats
from scipy.sparse import issparse

from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from ..svg.utils import multipletests_bh
from .CCI_effects_modeling.distributions import NegativeBinomial
from .CCI_effects_modeling.regression_utils import iwls


def _natural_spline_basis(x: np.ndarray, df: int) -> np.ndarray:
    """Natural cubic spline basis with df degrees of freedom."""
    x = np.asarray(x, dtype=float)
    knots = np.quantile(x, np.linspace(0, 1, df + 1))
    inner = knots[1:-1]
    lo, hi = knots[0], knots[-1]

    def d(k, xx):
        num = np.maximum(xx - k, 0) ** 3 - np.maximum(xx - hi, 0) ** 3
        return num / max(hi - k, 1e-12)

    cols = [x]
    for k in inner:
        cols.append(d(k, x) - d(lo, x))
    return np.stack(cols, axis=1)


def _design_from_formula(formula: str, df_factors: pd.DataFrame) -> np.ndarray:
    """Parse a minimal formula subset: '~1', '~var', '~cr(var, df=3)',
    additive combinations with '+'."""
    rhs = formula.split("~")[1].strip()
    n = len(df_factors)
    cols = [np.ones((n, 1))]
    if rhs != "1":
        for term in [t.strip() for t in rhs.split("+")]:
            m = re.match(r"cr\((.+?),\s*df=(\d+)\)", term)
            if m:
                var, df = m.group(1), int(m.group(2))
                cols.append(_natural_spline_basis(df_factors[var].values.astype(float), df))
            elif term in df_factors.columns:
                vals = df_factors[term]
                if vals.dtype == object or str(vals.dtype) == "category":
                    dummies = pd.get_dummies(vals, drop_first=True, dtype=float)
                    cols.append(dummies.values)
                else:
                    cols.append(np.asarray(vals, dtype=float).reshape(-1, 1))
            elif term != "1":
                raise ValueError(f"Formula term {term} not found in adata.obs.")
    return np.concatenate(cols, axis=1)


class _FitResult:
    def __init__(self, llf, mu, df_model):
        self.llf = llf
        self.mu = mu
        self.df_model = df_model


def glm_test(
    data: pd.DataFrame,
    fullModelFormulaStr: str = "~cr(time, df=3)",
    reducedModelFormulaStr: str = "~1",
):
    """Fit NB2 GLMs for the full and reduced formulas (parity: glm.py:142-156
    — same parameter names and defaults; statsmodels GLM is replaced by the
    in-house IWLS + NegativeBinomial family)."""
    y = np.asarray(data["expression"], dtype=float).ravel()
    fam = NegativeBinomial()

    def fit(formula):
        X = _design_from_formula(formula, data)
        betas, y_hat, n_iter, _ = iwls(y, X, distr="nb", max_iter=100)
        mu = np.clip(y_hat.ravel(), 1e-8, None)
        llf = fam.log_likelihood(y, mu)
        return _FitResult(llf, mu, X.shape[1])

    return fit(fullModelFormulaStr), fit(reducedModelFormulaStr)


def zinb_test(data, full_count_formula: str, reduced_count_formula: str, zero_infl_formula: Optional[str] = None):
    """ZINB likelihood-ratio setup (parity: glm.py:159). Zero inflation is
    estimated as the excess-zero mixture weight at the NB fit."""
    full, reduced = glm_test(data, full_count_formula, reduced_count_formula)
    y = np.asarray(data["expression"], dtype=float).ravel()

    def zinb_llf(res):
        pi = np.clip((y == 0).mean() - np.exp(-res.mu).mean(), 1e-6, 0.99)
        fam = NegativeBinomial()
        ll_nb = fam.log_likelihood(y[y > 0], res.mu[y > 0])
        n0 = (y == 0).sum()
        ll0 = n0 * np.log(pi + (1 - pi) * np.exp(-res.mu[y == 0]).mean() + 1e-30)
        return ll0 + (1 - pi) * ll_nb

    full.llf = zinb_llf(full)
    reduced.llf = zinb_llf(reduced)
    return full, reduced


def lrt(full, restr) -> float:
    """Likelihood-ratio test p-value (parity: glm.py:189)."""
    stat = 2 * (full.llf - restr.llf)
    dof = max(full.df_model - restr.df_model, 1)
    return float(stats.chi2.sf(max(stat, 0), dof))


def glm_degs(
    adata: AnnData,
    X_data: Optional[np.ndarray] = None,
    genes: Optional[list] = None,
    layer: Optional[str] = None,
    key_added: str = "glm_degs",
    fullModelFormulaStr: str = "~cr(time, df=3)",
    reducedModelFormulaStr: str = "~1",
    qval_threshold: Optional[float] = 0.05,
    llf_threshold: Optional[float] = -2000,
    ci_alpha: float = 0.05,
    use_zinb: bool = False,
    zero_infl_formula: Optional[str] = None,
    inplace: bool = True,
) -> Optional[AnnData]:
    """Differential expression via GLM likelihood-ratio tests (parity:
    glm.py:17)."""
    adata_work = adata if inplace else adata.copy()
    if X_data is None:
        genes = list(adata_work.var_names) if genes is None else list(genes)
        X_data = adata_work[:, np.asarray(genes)].X if layer is None else adata_work[:, np.asarray(genes)].layers[layer]
    else:
        assert genes is not None and len(genes) == X_data.shape[1]

    # factors referenced by the formulas
    factors = set()
    for f in (fullModelFormulaStr, reducedModelFormulaStr):
        rhs = f.split("~")[1]
        for term in rhs.split("+"):
            term = term.strip()
            m = re.match(r"cr\((.+?),\s*df=\d+\)", term)
            factors.add(m.group(1) if m else term)
    factors.discard("1")
    missing = factors - set(adata_work.obs.columns)
    assert not missing, f"adata object doesn't include the factors {missing} from the model formula."
    df_factors = adata_work.obs[list(factors)].copy()

    sparse = issparse(X_data)
    records = []
    deg_dict = {}
    for i, gene in enumerate(genes):
        expression = np.asarray(X_data[:, i].todense()).ravel() if sparse else np.asarray(X_data[:, i]).ravel()
        df_factors["expression"] = expression
        try:
            if use_zinb:
                full, null = zinb_test(df_factors, fullModelFormulaStr, reducedModelFormulaStr, zero_infl_formula)
                family = "ZINB"
            else:
                full, null = glm_test(df_factors, fullModelFormulaStr, reducedModelFormulaStr)
                family = "NB2"
            pval = lrt(full, null)
            records.append((gene, "ok", family, full.llf, pval))
            gene_df = df_factors.copy()
            gene_df["mu"] = full.mu
            deg_dict[gene] = gene_df
        except Exception:
            records.append((gene, "fail", "NB2", np.nan, 1.0))
    deg_df = pd.DataFrame(records, columns=["gene", "status", "family", "log-likelihood", "pval"]).set_index("gene")
    deg_df["qval"] = multipletests_bh(np.nan_to_num(deg_df["pval"].values, nan=1.0))
    deg_df = deg_df.dropna().sort_values(by=["qval", "pval", "log-likelihood"])
    if qval_threshold is not None or llf_threshold is not None:
        cut = deg_df
        if qval_threshold is not None:
            cut = cut[cut["qval"] <= qval_threshold]
        if llf_threshold is not None:
            cut = cut[cut["log-likelihood"] <= llf_threshold]
        adata_work.uns[key_added] = {"glm_result": cut, "correlation": {g: deg_dict[g] for g in cut.index if g in deg_dict}}
    else:
        adata_work.uns[key_added] = {"glm_result": deg_df, "correlation": deg_dict}
    return None if inplace else adata_work
