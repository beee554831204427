"""The port's MuSIC interpretation (`MuSIC_Interpreter`) and molecule
selection (`MuSIC_Molecule_Selector`) against the JAX package's on the CPU.

Both packages' interpreters read one output directory, written by the JAX
package's `MuSIC.fit` of a 300-cell `lr` model (the data of
`test_tools.py::TestMuSICDownstreamBreadth`, plus two TFs, STAT3 driving the
ligand); the port takes the fitted design through
`core.bridge.music_state_from_reference`. Bars:

- host code (coefficients, significance, effect potentials, vector fields,
  summaries, the downstream design): equal, or 1e-12 of scale where a float
  sum is taken;
- the CCI DEG GLM given the same weights W (the JAX package's, passed to the
  port): 1e-5 of scale, as `test_torch_music.py` holds the IRLS; the port's
  own downstream weights against the JAX package's: the weight bar of that
  file (2e-3 absolute, at most 1e-4 of the nonzeros in or out of support);
- `permutation_test`: the same permutations (spied on `mpi_fit`), the effects
  to 1e-4 of scale (each refit's conditioned weights are each package's own,
  as in `test_torch_music.py`'s whole fits, 5e-5), and p-values equal but
  where a permutation's statistic lies within 1e-4 of scale of the observed
  one: such ties may count on either side, and the test counts them;
- the downstream PCA (`compute_dim_reduction=True`) to 1e-10 of scale
  (scikit-learn's `covariance_eigh` PCA in the JAX package, the port's float64
  transcription).
"""

import os
import shutil
import tempfile

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.tools import find_neighbors as jfn
from spateo_tpu_torch.core.bridge import adata_from_reference, music_state_from_reference
from spateo_tpu_torch.tools.CCI_effects_modeling import MuSIC_downstream as tds

HOST_TOL = 1e-12
SOLVER_TOL = 1e-5
WEIGHT_ATOL, FLIP_SHARE = 2e-3, 1e-4
PERM_TOL = 1e-4
PCA_TOL = 1e-10
IA = "TGFB1:TGFBR1_TGFBR2"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and for numpy's pools: the tier-1 run
    shares the CPU among its workers, where those pools only contend."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _scaled(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _adata(n=300, seed=0):
    """TestMuSICDownstreamBreadth's senders and receivers, with STAT3 driving
    the ligand and JUN unrelated."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    genes = ["TGFB1", "TGFBR1", "TGFBR2", "TGT1", "STAT3", "JUN"]
    X = rng.poisson(0.3, (n, len(genes))).astype(np.float32)
    senders = pts[:, 0] < 50
    X[senders, 0] += rng.poisson(5.0, senders.sum())
    X[~senders, 1] += rng.poisson(3.0, (~senders).sum())
    X[~senders, 2] += rng.poisson(3.0, (~senders).sum())
    near = ~senders & (pts[:, 0] < 65)
    X[near, 3] += rng.poisson(6.0, near.sum())
    X[:, 4] = rng.poisson(3.0, n)
    X[:, 5] = rng.poisson(3.0, n)
    X[:, 0] += rng.poisson(np.exp(0.45 * np.log1p(X[:, 4])))
    adata = st.AnnData(
        X=X,
        obs=pd.DataFrame({"cell_type": np.where(senders, "sender", "receiver")}, index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=genes),
    )
    adata.obsm["spatial"] = pts
    st.SKM.init_adata_type(adata, "UMI")
    return adata, senders


def _args(out):
    return dict(mod_type="lr", group_key="cell_type", distr="gaussian", output_path=out, custom_targets=["TGT1"],
                custom_ligands=["TGFB1"], custom_receptors=["TGFBR1", "TGFBR2"], bw_fixed=True, bw=8.0,
                fit_intercept=True, species="human")


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """The JAX package's fit, its output directory and its data."""
    tmp = str(tmp_path_factory.mktemp("music_fit"))
    adata, senders = _adata()
    parser, args_list = st.tl.define_spateo_argparse(**_args(f"{tmp}/out.csv"))
    model = st.tl.MuSIC(parser, args_list)
    model.adata = adata
    model.fit(verbose=False)
    return tmp, model, senders


#: The fitted JAX model's attributes the JAX interpreter takes over (the port's
#: takes the same through `music_state_from_reference` and `load_state`).
_JAX_STATE = ("X", "X_df", "feature_names", "targets_expr", "coords", "n_samples", "sample_names", "ct_vec",
              "x_chunk", "ligands_expr", "ligands_expr_nonlag", "receptors_expr", "spatial_weights_membrane_bound",
              "spatial_weights_secreted")


def _interpreters(fitted, tmp):
    """A JAX and a port `MuSIC_Interpreter` around a copy of the fit's output
    directory. Each reads its coefficients from there once the design's
    sample names are set (which index them by cell)."""
    src, model, _ = fitted
    shutil.copytree(src, f"{tmp}/fit")
    pj, lj = st.tl.define_spateo_argparse(**_args(f"{tmp}/fit/out.csv"))
    ji = st.tl.MuSIC_Interpreter(pj, lj)
    ji.adata = model.adata.copy()
    for k in _JAX_STATE:
        setattr(ji, k, getattr(model, k))
    ji.lr_db = model.lr_db
    pt, lt = stt.tl.define_spateo_argparse(**_args(f"{tmp}/fit/out.csv"))
    ti = stt.tl.MuSIC_Interpreter(pt, lt, device="cpu")
    ti.adata = adata_from_reference(model.adata)
    ti.load_state(music_state_from_reference(model))
    for i in (ji, ti):
        i.load_coeffs()
    return ji, ti


#: The ligands of `_multi_signal_interpreters`: STAT3 drives TGFB1 and BMP2,
#: MYC drives IL6.
LIGANDS = ["TGFB1", "BMP2", "IL6", "WNT5A", "CXCL12"]


def _multi_signal_interpreters(tmp, n_ligands=3):
    """Both packages' interpreters on 300 cells whose ligand table holds the
    first `n_ligands` of `LIGANDS`, with three TFs. With 3 ligands the binary
    profiles take at most 8 values, no more than bw + 1 = 11, so the fit falls
    back to the coordinates as its neighbour space."""
    rng = np.random.default_rng(7)
    n = 300
    ligands, tfs = LIGANDS[:n_ligands], ["STAT3", "JUN", "MYC"]
    T = rng.poisson(3.0, (n, 3)).astype(float)
    L = rng.poisson(0.5, (n, 5)).astype(float)
    L[:, 0] += rng.poisson(np.exp(0.5 * np.log1p(T[:, 0])))
    L[:, 1] += rng.poisson(np.exp(0.4 * np.log1p(T[:, 0])))
    L[:, 2] += rng.poisson(np.exp(0.5 * np.log1p(T[:, 2])))
    L = L[:, :n_ligands]
    X = np.c_[L, T].astype(np.float32)
    out = []
    for pkg, kw in ((st, {}), (stt, {"device": "cpu"})):
        adata = st.AnnData(X=X.copy(), obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                           var=pd.DataFrame(index=ligands + tfs))
        adata.obsm["spatial"] = np.random.default_rng(1).uniform(0, 100, (n, 2)).astype(np.float32)
        st.SKM.init_adata_type(adata, "UMI")
        parser, args_list = pkg.tl.define_spateo_argparse(mod_type="ligand", species="human",
                                                          output_path=f"{tmp}/{pkg.__name__}/out.csv",
                                                          custom_ligands=ligands, custom_targets=["TGFB1"])
        interp = pkg.tl.MuSIC_Interpreter(parser, args_list, **kw)
        interp.adata = adata if pkg is st else adata_from_reference(adata)
        interp.load_and_process()
        interp.ligands_expr_nonlag = pd.DataFrame(L, index=interp.adata.obs_names, columns=ligands)
        out.append(interp)
    return out


# ---------------------------------------------------------------------------
# coefficients and significance
# ---------------------------------------------------------------------------
def test_load_coeffs_and_significance_match_jax(fitted):
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _interpreters(fitted, tmp)
        assert list(ti.coeffs) == list(ji.coeffs) == ["TGT1"]
        pd.testing.assert_frame_equal(ti.coeffs["TGT1"], ji.coeffs["TGT1"])
        pd.testing.assert_frame_equal(ti.standard_errors["TGT1"], ji.standard_errors["TGT1"])
        sj, stt_ = ji.compute_coeff_significance(), ti.compute_coeff_significance()
        pd.testing.assert_frame_equal(ti.pvalues["TGT1"], ji.pvalues["TGT1"])
        pd.testing.assert_frame_equal(ti.qvalues["TGT1"], ji.qvalues["TGT1"])
        pd.testing.assert_frame_equal(stt_["TGT1"], sj["TGT1"])
        pd.testing.assert_frame_equal(ti.effect_distribution(), ji.effect_distribution())
        pd.testing.assert_frame_equal(ti.top_interactions(3), ji.top_interactions(3))


def test_significance_with_fitted_se_and_keep_threshold_match_jax():
    """`TestCoeffSignificanceFittedSE` and `TestKeepColumnThreshold` through
    both packages: zero coefficient or zero SE gives p = 1, columns nonzero
    in too few cells are zeroed with their SEs."""
    n = 100
    idx = [f"c{i}" for i in range(n)]
    b = np.full(n, 2.0)
    b[0] = 0.0
    se = np.full(n, 0.5)
    se[1] = 0.0
    sparse_col = np.zeros(n)
    sparse_col[:10] = 1.0
    out = []
    for pkg, kw in ((st, {}), (stt, {"device": "cpu"})):
        with tempfile.TemporaryDirectory() as tmp:
            parser, args_list = pkg.tl.define_spateo_argparse(mod_type="ligand", species="human",
                                                              output_path=f"{tmp}/out.csv", custom_ligands=["TGFB1"],
                                                              custom_targets=["TGT"])
            interp = pkg.tl.MuSIC_Interpreter(parser, args_list, keep_coeff_threshold_proportion_cells=0.5, **kw)
            interp.coeffs = {"TGT": pd.DataFrame({"b_TGFB1": b, "b_sparse": sparse_col.copy()}, index=idx)}
            interp.standard_errors = {"TGT": pd.DataFrame({"se_TGFB1": se, "se_sparse": np.full(n, 0.1)}, index=idx)}
            interp._apply_keep_column_threshold()
            sig = interp.compute_coeff_significance()
            out.append((interp.coeffs["TGT"], interp.standard_errors["TGT"], interp.pvalues["TGT"], sig["TGT"]))
    for a, b_ in zip(*out):
        pd.testing.assert_frame_equal(a, b_)
    coeffs, ses, pv, sig = out[1]
    assert (coeffs["b_sparse"] == 0).all() and (ses["se_sparse"] == 0).all()
    assert pv["b_TGFB1"].iloc[0] == 1.0 and pv["b_TGFB1"].iloc[1] == 1.0 and pv["b_TGFB1"].iloc[2] < 1e-3
    assert bool(sig["b_TGFB1"].iloc[2])


# ---------------------------------------------------------------------------
# effect potentials
# ---------------------------------------------------------------------------
def test_effect_potential_matches_jax(fitted):
    """`TestEffectPotential` through both packages: the same sparse potential
    and normalised sums from the fit's weights; other weights change them;
    the sums are stored in .obs under the same names."""
    _, model, _ = fitted
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _interpreters(fitted, tmp)
        kw = dict(target="TGT1", ligand="TGFB1", receptor="TGFBR1_TGFBR2",
                  spatial_weights_membrane_bound=model.spatial_weights_membrane_bound,
                  spatial_weights_secreted=model.spatial_weights_secreted)
        Pj, nsj, nrj = ji.get_effect_potential(**kw)
        Pt, nst, nrt = ti.get_effect_potential(**kw)
        assert Pt.shape == (300, 300) and abs(Pt - Pj).max() <= HOST_TOL * abs(Pj).max()
        assert _scaled(nst, nsj) <= HOST_TOL and _scaled(nrt, nrj) <= HOST_TOL
        W_alt = sp.identity(300, format="csr")
        _, ns2, _ = ti.get_effect_potential(target="TGT1", ligand="TGFB1", receptor="TGFBR1_TGFBR2",
                                            spatial_weights_membrane_bound=W_alt, spatial_weights_secreted=W_alt)
        assert not np.allclose(nst, ns2)
        keys = [k for k in ji.adata.obs.columns if k.startswith("norm_sum_")]
        assert keys and all(k in ti.adata.obs.columns for k in keys)


def test_effect_potential_loads_or_computes_the_weights(fitted):
    """Without weights passed: both packages load the fit's saved weights
    (equal potentials); with none saved, the port computes them on its
    device (`_compute_all_wi`) within the weight bar of the JAX package's."""
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _interpreters(fitted, tmp)
        for i in (ji, ti):
            i.spatial_weights_secreted = i.spatial_weights_membrane_bound = None
        Pj, _, _ = ji.get_effect_potential(target="TGT1", ligand="TGFB1", receptor="TGFBR1_TGFBR2")
        Pt, _, _ = ti.get_effect_potential(target="TGT1", ligand="TGFB1", receptor="TGFBR1_TGFBR2")
        assert abs(Pt - Pj).max() <= HOST_TOL * abs(Pj).max()
        shutil.rmtree(f"{tmp}/fit/out/spatial_weights")
        for i in (ji, ti):
            i.spatial_weights_secreted = i.spatial_weights_membrane_bound = None
            i._load_or_compute_weights("secreted")
        Wj, Wt = ji.spatial_weights_secreted.toarray(), ti.spatial_weights_secreted.toarray()
        assert np.abs(Wt - Wj).max() <= WEIGHT_ATOL
        assert ((Wt > 0) != (Wj > 0)).sum() <= FLIP_SHARE * max((Wj > 0).sum(), 1)


def test_effect_matrix_vector_field_and_pathway_match_jax(fitted):
    """`TestMuSICDownstreamBreadth.test_effects_and_direction` through both
    packages, plus the pathway potential; `visualize=True` writes the same
    obs columns (the 99.7th-percentile clamp in `_plot`) and draws an equal
    figure (pixels and artists, `tests/_figure_parity.py`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from _figure_parity import assert_same_figure

    _, _, senders = fitted
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _interpreters(fitted, tmp)
        for i in (ji, ti):
            i.add_interaction_effect_to_adata("TGT1", IA)
        np.testing.assert_array_equal(ti.adata.obs[f"{IA}_effect_on_TGT1"], ji.adata.obs[f"{IA}_effect_on_TGT1"])
        figs = []
        for i in (ji, ti):
            i.add_interaction_effect_to_adata("TGT1", IA, visualize=True)
            figs.append(plt.gcf())
        assert list(ti.adata.obs.columns) == list(ji.adata.obs.columns)
        for c in ji.adata.obs.columns:
            np.testing.assert_array_equal(np.asarray(ti.adata.obs[c]), np.asarray(ji.adata.obs[c]))
        assert figs[0] is not figs[1]
        assert_same_figure(*figs)
        plt.close("all")
        pd.testing.assert_frame_equal(ti.cell_type_specific_interactions(lower_threshold=0.0),
                                      ji.cell_type_specific_interactions(lower_threshold=0.0))
        Pj, nsj, nrj = ji.get_effect_potential_matrix("TGT1", IA)
        Pt, nst, nrt = ti.get_effect_potential_matrix("TGT1", IA)
        assert abs(Pt - Pj).max() <= HOST_TOL * abs(Pj).max()
        assert _scaled(nst, nsj) <= HOST_TOL and _scaled(nrt, nrj) <= HOST_TOL
        svf_j, rvf_j = ji.define_effect_vf(Pj, nsj, nrj, IA, "TGT1")
        svf_t, rvf_t = ti.define_effect_vf(Pt, nst, nrt, IA, "TGT1")
        assert _scaled(svf_t, svf_j) <= HOST_TOL and _scaled(rvf_t, rvf_j) <= HOST_TOL
        moving = senders & (np.linalg.norm(svf_t, axis=1) > 1e-9)
        assert svf_t[moving, 0].mean() > 0
        pathway = ti.lr_db[ti.lr_db["from"] == "TGFB1"]["pathway"].iloc[0]
        Aj, saj, raj = ji.get_pathway_potential(pathway, "TGT1")
        At, sat, rat = ti.get_pathway_potential(pathway, "TGT1")
        assert abs(At - Aj).max() <= HOST_TOL * abs(Aj).max() and _scaled(sat, saj) <= HOST_TOL


def test_effect_plots_run_and_categorise_as_jax_does(fitted):
    """The 3D plot family of `TestMuSICDownstreamBreadth` with the Agg
    backend: the same categories and overlaps as the JAX package's."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _interpreters(fitted, tmp)
        fig, ax = ti.plot_interaction_effect_3D("TGT1", IA)
        assert sum(len(np.asarray(c._offsets3d[0])) for c in ax.collections if hasattr(c, "_offsets3d")) == 300
        plt.close(fig)
        out = []
        for i in (ji, ti):
            fig, _, cats = i.plot_multiple_interaction_effects_3D([f"{IA}:TGT1"])
            plt.close(fig)
            fig, _, ov = i.visualize_overlap_between_interacting_components_3D("TGT1", IA)
            plt.close(fig)
            out.append((cats, ov))
        pd.testing.assert_series_equal(out[1][0], out[0][0])
        pd.testing.assert_series_equal(out[1][1], out[0][1])
        with pytest.raises(ValueError, match="downstream"):
            ti.plot_tf_effect_3D("TGFB1", "STAT3")


# ---------------------------------------------------------------------------
# CCI DEG detection
# ---------------------------------------------------------------------------
def _with_jax_weights(monkeypatch):
    """The port's downstream weights replaced by the JAX package's
    `get_wi_batch` on the same neighbour space; returns the call count."""
    calls = []

    def jax_weights(coords, bw, **kw):
        calls.append(bw)
        kw.pop("device")
        return torch.from_numpy(jfn.get_wi_batch(coords, bw, **kw))

    monkeypatch.setattr(tds, "get_wi_batch_tensor", jax_weights)
    return calls


@pytest.mark.parametrize("distr", ["poisson", "gaussian"])
def test_cci_deg_detection_matches_jax_given_the_same_weights(fitted, monkeypatch, distr):
    """`TestCCIDegGLM` through both packages: the same design, and given the
    same weights the per-TF table and the per-cell coefficients within
    `SOLVER_TOL`; the driving TF found by both."""
    _with_jax_weights(monkeypatch)
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _interpreters(fitted, tmp)
        dj, yj = ji.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3", "JUN"])
        dt, yt = ti.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3", "JUN"])
        pd.testing.assert_frame_equal(dt, dj)
        pd.testing.assert_frame_equal(yt, yj)
        np.testing.assert_array_equal(ti._cci_deg_jaccard, ji._cci_deg_jaccard)
        rj = ji.CCI_deg_detection("TGFB1", distr=distr)
        rt = ti.CCI_deg_detection("TGFB1", distr=distr)
        assert list(rt.index) == list(rj.index)
        for col in ("coefficient", "se"):
            assert _scaled(rt[col], rj[col]) <= SOLVER_TOL
        assert (rt["significant"] == rj["significant"]).all()
        cj, ct = ji.downstream_model_ligand_coeffs["TGFB1"], ti.downstream_model_ligand_coeffs["TGFB1"]
        assert list(ct.columns) == list(cj.columns) and _scaled(ct.values, cj.values) <= SOLVER_TOL
        pd.testing.assert_frame_equal(ti.downstream_model_ligand_design_matrix, ji.downstream_model_ligand_design_matrix)
        assert _scaled(ti.downstream_model_ligand_predictions.values,
                       ji.downstream_model_ligand_predictions.values) <= SOLVER_TOL
        assert os.path.exists(f"{tmp}/fit/cci_deg_detection/ligand_analysis/downstream/predictions.csv")
        if distr == "poisson":
            assert rt.index[0] == "STAT3" and bool(rt.loc["STAT3", "significant"])


def test_downstream_weights_match_jax():
    """The port's own [n, n] downstream weights (the adaptive bisquare of 0.5%
    of n, at least 10 neighbours) on the coordinates and on a five-molecule
    Jaccard space against the JAX package's `get_wi_batch`: NaN where the
    JAX package's are (a profile shared by more than 10 cells has a 10th
    neighbour at distance 0, and 0 / 0 is NaN), within the weight bar
    elsewhere."""
    with tempfile.TemporaryDirectory() as tmp:
        _, ti = _multi_signal_interpreters(tmp, n_ligands=5)
        ti.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3", "JUN", "MYC"])
        for space in (np.asarray(ti.adata.obsm["spatial"], float), np.asarray(ti._cci_deg_jaccard, float)):
            Wt = ti._downstream_weights(space, 10).numpy()
            Wj = jfn.get_wi_batch(space, 10, fixed_bw=False, exclude_self=False, kernel="bisquare")
            np.testing.assert_array_equal(np.isnan(Wt), np.isnan(Wj))
            ok = ~np.isnan(Wj)
            assert np.abs(Wt[ok] - Wj[ok]).max() <= WEIGHT_ATOL
            assert ((Wt[ok] > 0) != (Wj[ok] > 0)).sum() <= FLIP_SHARE * max((Wj[ok] > 0).sum(), 1)


def test_shared_jaccard_profiles_give_nan_coefficients_as_jax_does(monkeypatch):
    """Five molecules: more than bw + 1 distinct binary profiles, so the fit
    keeps the Jaccard space, where shared profiles make NaN weights; both
    packages then report NaN mean coefficients (the JAX package's answer,
    ROADMAP Queue 3)."""
    _with_jax_weights(monkeypatch)
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _multi_signal_interpreters(tmp, n_ligands=5)
        for i in (ji, ti):
            i.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3", "JUN", "MYC"])
        assert np.unique(ti._cci_deg_jaccard, axis=0).shape[0] > 11
        rj, rt = ji.CCI_deg_detection("TGFB1", distr="poisson"), ti.CCI_deg_detection("TGFB1", distr="poisson")
        assert rj["coefficient"].isna().all() and rt["coefficient"].isna().all()


def test_fit_all_builds_the_weights_once_and_matches_jax(monkeypatch):
    """`fit_all=True` over three molecules builds the weights once, gives each
    molecule what a fit of it alone gives, and (given the same weights) the
    JAX package's coefficients within `SOLVER_TOL`; the driving TFs come
    first for the molecules they drive."""
    calls = _with_jax_weights(monkeypatch)
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _multi_signal_interpreters(tmp)
        for i in (ji, ti):
            i.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3", "JUN", "MYC"])
        mols = list(ti._cci_deg_targets.columns)
        assert len(mols) == 3
        ji.CCI_deg_detection(distr="poisson", fit_all=True)
        ti.CCI_deg_detection(distr="poisson", fit_all=True)
        assert len(calls) == 1
        for m in mols:
            cj, ct = ji.downstream_model_ligand_coeffs[m], ti.downstream_model_ligand_coeffs[m]
            assert _scaled(ct.values, cj.values) <= SOLVER_TOL
        together = {m: ti.downstream_model_ligand_coeffs[m].copy() for m in mols}
        for m in mols:
            ti._cci_deg_weights = None
            res = ti.CCI_deg_detection(m, distr="poisson")
            pd.testing.assert_frame_equal(ti.downstream_model_ligand_coeffs[m], together[m])
            if m in ("TGFB1", "BMP2", "IL6"):
                assert res.index[0] == ("MYC" if m == "IL6" else "STAT3")
        assert len(calls) == 4


def test_downstream_summaries_match_jax(fitted, monkeypatch):
    """`TestCCIDegGLM`'s summaries after the same fit: TF effects, the
    enriched-TF bars, the DEG bars and heatmap."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _with_jax_weights(monkeypatch)
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _interpreters(fitted, tmp)
        for i in (ji, ti):
            i.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3", "JUN"])
            i.CCI_deg_detection("TGFB1", distr="poisson")
        ej, et = ji.summarize_tf_effects(target_type="ligand"), ti.summarize_tf_effects(target_type="ligand")
        assert list(et.index) == list(ej.index) and _scaled(et.values, ej.values) <= SOLVER_TOL
        assert et.loc["STAT3", "TGFB1"] > et.loc["JUN", "TGFB1"]
        bj, bt = ji.enriched_tfs_barplot(target_type="ligand"), ti.enriched_tfs_barplot(target_type="ligand")
        assert list(bt.index) == list(bj.index) and bt.index[0] == "STAT3"
        pj = ji.enriched_tfs_barplot(target_type="ligand", plot_type="proportion")
        pt = ti.enriched_tfs_barplot(target_type="ligand", plot_type="proportion")
        pd.testing.assert_series_equal(pt, pj)
        pd.testing.assert_series_equal(ti.deg_effect_barplot("TGFB1"), ji.deg_effect_barplot("TGFB1"))
        Mj, Mt = ji.deg_effect_heatmap(target_type="ligand"), ti.deg_effect_heatmap(target_type="ligand")
        assert list(Mt.index) == list(Mj.index) and list(Mt.columns) == list(Mj.columns)
        fig, ax, ser = ti.enriched_tfs_barplot(target_type="ligand", save_show_or_return="axes")
        assert len(ax.patches) == len(ser)
        plt.close(fig)


def test_cci_deg_setup_reference_semantics_match_jax():
    """`TestCCIDegSetupReferenceSemantics` through both packages: complex
    columns split, the 1% filter, pathway sums, per-cell-type designs and a
    per-cell-type fit, the rejected combination."""
    rng = np.random.default_rng(3)
    n = 300
    genes = ["TGFB1", "IL12A", "IL12B", "RARELY", "STAT3", "JUN"]
    X = np.c_[rng.poisson(2, n), rng.poisson(2, n), rng.poisson(2, n), np.zeros(n), rng.poisson(2, n),
              rng.poisson(3, n)].astype(np.float32)
    X[0, 3] = 1.0
    obs = pd.DataFrame({"group": ["A"] * 150 + ["B"] * 150}, index=[f"c{i}" for i in range(n)])
    out = []
    for pkg, kw in ((st, {}), (stt, {"device": "cpu"})):
        with tempfile.TemporaryDirectory() as tmp:
            adata = st.AnnData(X=X.copy(), obs=obs.copy(), var=pd.DataFrame(index=genes))
            adata.obsm["spatial"] = np.random.default_rng(0).uniform(0, 100, (n, 2)).astype(np.float32)
            st.SKM.init_adata_type(adata, "UMI")
            parser, args_list = pkg.tl.define_spateo_argparse(mod_type="ligand", species="human",
                                                              output_path=f"{tmp}/out.csv", custom_ligands=["TGFB1"],
                                                              custom_targets=["TGFB1"], group_key="group")
            interp = pkg.tl.MuSIC_Interpreter(parser, args_list, **kw)
            interp.adata = adata if pkg is st else adata_from_reference(adata)
            interp.load_and_process()
            interp.ligands_expr_nonlag = pd.DataFrame(
                {"TGFB1": X[:, 0], "IL12A_IL12B": np.minimum(X[:, 1], X[:, 2]), "RARELY": X[:, 3]},
                index=interp.adata.obs_names,
            )
            design, targets = interp.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3"])
            by_ct = interp.CCI_deg_detection_setup(use_ligands=False, use_cell_types=True,
                                                   sender_receiver_or_target_degs="sender", custom_tfs=["STAT3"],
                                                   group_key="group")
            res = interp.CCI_deg_detection("TGFB1", cell_type="A", distr="poisson")
            with pytest.raises(ValueError, match="cannot be 'target'"):
                interp.CCI_deg_detection_setup(use_pathways=True, sender_receiver_or_target_degs="target")
            out.append((design, targets, interp._cci_deg_jaccard, {k: v["targets"] for k, v in by_ct.items()}, res))
    (dj, yj, jj, cj, rj), (dt, yt, jt, ct, rt) = out
    pd.testing.assert_frame_equal(dt, dj)
    pd.testing.assert_frame_equal(yt, yj)
    np.testing.assert_array_equal(jt, jj)
    assert "IL12A_IL12B" not in yt.columns and {"IL12A", "IL12B"} <= set(yt.columns) and "RARELY" not in yt.columns
    assert set(ct) == set(cj) == {"A", "B"}
    for k in ct:
        pd.testing.assert_frame_equal(ct[k], cj[k])
    assert list(rt.index) == list(rj.index) and _scaled(rt["coefficient"], rj["coefficient"]) <= 1e-3


def test_compute_dim_reduction_matches_jax(monkeypatch):
    """`compute_dim_reduction=True` on the five-molecule signal: the elbow
    and the PCA of the standardised signal within `PCA_TOL` of the JAX
    package's (scikit-learn's PCA, whose `svd_flip` signs the port keeps);
    then a fit in that space, given the same weights: the same table, NaN
    where the JAX package's is (shared profiles share a PCA point)."""
    _with_jax_weights(monkeypatch)
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _multi_signal_interpreters(tmp, n_ligands=5)
        for i in (ji, ti):
            i.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3", "JUN", "MYC"],
                                      compute_dim_reduction=True)
        assert ti._cci_deg_pca.shape == ji._cci_deg_pca.shape and ti._cci_deg_pca.shape[1] >= 2
        assert _scaled(ti._cci_deg_pca, ji._cci_deg_pca) <= PCA_TOL
        rj = ji.CCI_deg_detection("TGFB1", distr="poisson", use_dim_reduction=True)
        rt = ti.CCI_deg_detection("TGFB1", distr="poisson", use_dim_reduction=True)
        np.testing.assert_array_equal(rt["coefficient"].isna(), rj["coefficient"].isna())
        ok = rj["coefficient"].notna()
        assert not ok.any() or _scaled(rt["coefficient"][ok], rj["coefficient"][ok]) <= SOLVER_TOL


def test_pca_fit_matches_sklearn():
    """`pca_fit` and `PCA` against `sklearn.decomposition.PCA` for the
    solvers `auto` picks (covariance_eigh, full, and randomized at 2,000 x
    1,500) and the first two by name: components, projections and variances
    within `PCA_TOL` of scale, the same signs; a fraction of the variance
    with the randomized or ARPACK solver raises, as in scikit-learn."""
    from sklearn.decomposition import PCA as SkPCA

    from spateo_tpu_torch.tools.dimensionality_reduction import PCA, pca_fit

    rng = np.random.default_rng(0)
    for n, d, k, solver in ((400, 12, 5, "auto"), (300, 40, 10, "auto"), (60, 20, 19, "auto"),
                            (200, 30, 6, "full"), (200, 30, 6, "covariance_eigh")):
        X = rng.normal(size=(n, d)) @ rng.normal(size=(d, d))
        a = SkPCA(n_components=k, svd_solver=solver).fit(X)
        b = PCA(n_components=k, svd_solver=solver, device="cpu").fit(X)
        assert _scaled(b.components_, a.components_) <= PCA_TOL
        assert _scaled(b.transform(X), a.transform(X)) <= PCA_TOL
        for attr in ("explained_variance_", "explained_variance_ratio_", "singular_values_", "mean_"):
            assert _scaled(getattr(b, attr), getattr(a, attr)) <= PCA_TOL
        assert abs(b.noise_variance_ - a.noise_variance_) <= PCA_TOL * a.explained_variance_[0]
    X = rng.normal(size=(300, 8))
    fit, X_pca = pca_fit(X, n_components=30, device="cpu")
    assert fit.n_components_ == 7 and _scaled(X_pca, SkPCA(n_components=7).fit(X).transform(X)) <= PCA_TOL
    X = rng.normal(size=(2000, 1500))
    a = SkPCA(n_components=10, random_state=0).fit(X)
    b = PCA(n_components=10, random_state=0, device="cpu").fit(X)
    assert a._fit_svd_solver == "randomized"
    assert _scaled(b.components_, a.components_) <= PCA_TOL
    assert _scaled(b.explained_variance_, a.explained_variance_) <= PCA_TOL
    for solver in ("randomized", "arpack"):
        with pytest.raises(ValueError, match="must be between 1 and"):
            SkPCA(n_components=0.9, svd_solver=solver).fit(X[:200, :50])
        with pytest.raises(ValueError, match="must be between 1 and"):
            PCA(n_components=0.9, svd_solver=solver, device="cpu").fit(X[:200, :50])
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            PCA(n_components=bad, device="cpu").fit(X[:200, :50])


@pytest.mark.parametrize("fraction", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("n,d,solver", [(400, 12, "auto"), (300, 40, "auto"), (200, 30, "full"),
                                        (200, 30, "covariance_eigh")])
def test_pca_fraction_matches_sklearn(fraction, n, d, solver):
    """0 < n_components < 1 keeps the fewest components whose cumulative
    explained-variance ratio exceeds it, as scikit-learn 1.9's `PCA` (which
    the JAX package's `pca_fit` calls): the same `n_components_`, exactly,
    and components, projections and variances within `PCA_TOL` of scale;
    "auto" picks covariance_eigh at 400 x 12 and full at 300 x 40."""
    from sklearn.decomposition import PCA as SkPCA

    from spateo_tpu.tools.dimensionality_reduction import pca_fit as jax_pca_fit
    from spateo_tpu_torch.tools.dimensionality_reduction import PCA, pca_fit

    rng = np.random.default_rng(int(fraction * 100) + n)
    X = rng.normal(size=(n, d)) @ rng.normal(size=(d, d))
    a = SkPCA(n_components=fraction, svd_solver=solver).fit(X)
    b = PCA(n_components=fraction, svd_solver=solver, device="cpu").fit(X)
    assert a._fit_svd_solver == {"auto": "covariance_eigh" if n >= 10 * d else "full"}.get(solver, solver)
    assert b.n_components_ == a.n_components_ and 1 <= b.n_components_ < d
    assert b.explained_variance_ratio_.sum() > fraction
    assert _scaled(b.components_, a.components_) <= PCA_TOL
    assert _scaled(b.transform(X), a.transform(X)) <= PCA_TOL
    for attr in ("explained_variance_", "explained_variance_ratio_", "singular_values_"):
        assert _scaled(getattr(b, attr), getattr(a, attr)) <= PCA_TOL
    assert abs(b.noise_variance_ - a.noise_variance_) <= PCA_TOL * a.explained_variance_[0]
    if solver == "auto":
        fa, Pa = jax_pca_fit(X, n_components=fraction)
        fb, Pb = pca_fit(X, n_components=fraction, device="cpu")
        assert fb.n_components_ == fa.n_components_ and _scaled(Pb, Pa) <= PCA_TOL


# ---------------------------------------------------------------------------
# permutation test
# ---------------------------------------------------------------------------
def _spy(interp):
    """Record each `mpi_fit`'s y and coefficients."""
    calls = []
    orig = interp.mpi_fit

    def spy(y, X, *a, **k):
        out = orig(y, X, *a, **k)
        calls.append((np.array(y, float), np.array(out, float)))
        return out

    interp.mpi_fit = spy
    return calls


@pytest.mark.parametrize("nonzeros_only", [False, True])
def test_permutation_test_matches_jax(fitted, nonzeros_only):
    """20 permutations from one seed: the same scrambles in both packages;
    the effects within `PERM_TOL`; each p-value equal but for comparisons of
    a permutation's statistic with the observed one that lie within
    `PERM_TOL` of scale (ties rounding may flip, counted)."""
    with tempfile.TemporaryDirectory() as tmp:
        ji, ti = _interpreters(fitted, tmp)
        cj, ct = _spy(ji), _spy(ti)
        rj = ji.permutation_test("TGT1", n_permutations=20, permute_nonzeros_only=nonzeros_only, seed=3)
        rt = ti.permutation_test("TGT1", n_permutations=20, permute_nonzeros_only=nonzeros_only, seed=3)
        assert len(cj) == len(ct) == 21
        for (yj, _), (yt, _) in zip(cj, ct):
            np.testing.assert_array_equal(yt, yj)
        assert list(rt.index) == list(rj.index)
        assert _scaled(rt["mean_abs_effect"], rj["mean_abs_effect"]) <= PERM_TOL
        stats = [np.stack([np.abs(b).mean(axis=0) for _, b in calls]) for calls in (cj, ct)]
        scale = np.abs(stats[0]).max()
        ge = [s[1:] >= s[0][None, :] for s in stats]
        flipped = ge[0] != ge[1]
        near = np.minimum(np.abs(stats[0][1:] - stats[0][0]), np.abs(stats[1][1:] - stats[1][0])) <= PERM_TOL * scale
        assert not (flipped & ~near).any()
        counts = ge[1].sum(axis=0)
        np.testing.assert_allclose(rt["perm_pvalue"].values, (counts + 1) / 21, rtol=0, atol=1e-15)
        print(f"nonzeros_only={nonzeros_only}: {int(flipped.sum())} tied comparisons flipped")
        pd.testing.assert_frame_equal(ti._perm_truth["TGT1"], ji._perm_truth["TGT1"])
        assert _scaled(ti._perm_predictions["TGT1"].values, ji._perm_predictions["TGT1"].values) <= PERM_TOL
        if nonzeros_only:
            nz = cj[0][0] != 0
            assert all(((y != 0) == nz).all() for y, _ in ct)
        ej, et = ji.eval_permutation_test("TGT1"), ti.eval_permutation_test("TGT1")
        assert list(et.index) == list(ej.index) and list(et.columns) == list(ej.columns)


# ---------------------------------------------------------------------------
# MuSIC_Molecule_Selector
# ---------------------------------------------------------------------------
def _selector_adata():
    """`TestMoleculeSelector`'s data: test_music_fidelity.py's `lr_adata`
    with a housekeeping gene (GAPDH) added."""
    rng = np.random.default_rng(11)
    n = 250
    pts = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    genes = ["TGFB1", "TGFBR1", "TGFBR2", "DLL1", "NOTCH1", "TGT1"]
    X = rng.poisson(0.2, (n, len(genes))).astype(np.float32)
    senders = pts[:, 0] < 50
    X[senders, 0] += rng.poisson(5.0, senders.sum())
    X[senders, 3] += rng.poisson(4.0, senders.sum())
    X[~senders, 1] += rng.poisson(3.0, (~senders).sum())
    X[~senders, 2] += rng.poisson(3.0, (~senders).sum())
    X[~senders, 4] += rng.poisson(3.0, (~senders).sum())
    near = ~senders & (pts[:, 0] < 65)
    X[near, 5] += rng.poisson(6.0, near.sum())
    X = np.c_[X, np.random.default_rng(0).poisson(5.0, (n, 1))].astype(np.float32)
    adata = st.AnnData(X=X, obs=pd.DataFrame({"cell_type": np.where(senders, "sender", "receiver")},
                                             index=[f"c{i}" for i in range(n)]),
                       var=pd.DataFrame(index=genes + ["GAPDH"]))
    adata.obsm["spatial"] = pts
    st.SKM.init_adata_type(adata, "UMI")
    return adata


def test_molecule_selector_matches_jax():
    adata = _selector_adata()
    out = []
    for pkg, kw in ((st, {}), (stt, {"device": "cpu"})):
        with tempfile.TemporaryDirectory() as tmp:
            parser, args_list = pkg.tl.define_spateo_argparse(mod_type="lr", species="human",
                                                              output_path=f"{tmp}/out.csv", target_expr_threshold=0.05,
                                                              bw_fixed=True, bw=10.0)
            data = adata.copy() if pkg is st else adata_from_reference(adata)
            sel = pkg.tl.MuSIC_Molecule_Selector(parser, args_list, adata=data, **kw)
            frame = sel.find_targets()
            files = {f: open(f"{tmp}/out/{f}.txt").read() for f in ("ligands", "receptors", "targets")}
            out.append((frame, sel.ligands, sel.receptors, sel.targets, files))
    (fj, lj, rj, tj, filej), (ft, lt, rt, tt, filet) = out
    pd.testing.assert_frame_equal(ft, fj)
    assert (lt, rt, tt, filet) == (lj, rj, tj, filej)
    assert "TGFB1" in lt and any("TGFBR" in r for r in rt)
    assert "GAPDH" not in tt and not set(tt) & set(rt) and "TGT1" in tt


def test_molecule_selector_rejects_niche_models():
    with tempfile.TemporaryDirectory() as tmp:
        parser, args_list = stt.tl.define_spateo_argparse(mod_type="niche", species="human",
                                                          output_path=f"{tmp}/out.csv")
        sel = stt.tl.MuSIC_Molecule_Selector(parser, args_list, adata=adata_from_reference(_selector_adata()),
                                             device="cpu")
        with pytest.raises(ValueError, match="receptor"):
            sel.find_targets()


def test_chip_smoke_phases_24_and_25_rehearse_on_the_cpu(capsys):
    """`chip_smoke.py`'s phase 24 at a small size on the CPU (1,500 cells, 5
    permutations, a 256² pair, a 1,000 x 200 NMF) with its planted checks,
    and phase 25 with the CPU on both sides (every difference 0)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    chip_smoke.phase_interpretation(n_cells=1500, n_perm=5, raster=256, nmf_genes=200, device="cpu")
    chip_smoke.phase_interpretation_cuda_vs_cpu(card="cpu")
    out = capsys.readouterr().out
    assert "phase 24 took" in out and "phase 25: card vs CPU" in out
