"""The port's SVG layer (`spateo_tpu_torch.svg`, `preprocessing.bin_adata`,
`tools.spatially_variable_gene_ot`) against the JAX package's on the CPU.

The neighbour graphs: the JAX package asks scikit-learn's kd-tree, the port
(whose GPU machine has no scikit-learn) takes each point's k nearest by
distance, then index, with the kd-tree's float64 distances. On jittered
coordinates no two distances tie, so graphs, geodesic matrices, smoothing
and whole scans are compared with the JAX package's outputs; on lattice
coordinates the k-th distance is tied and the port's rule is pinned against
a numpy brute-force reference instead, and
`test_lattice_results_move_from_sklearns_choice` measures how far the
lattice results move from the JAX package's.

Bars: Wasserstein scores and everything derived from them (loess baselines,
standard deviations, z-scores, p-values) to 1e-5 of each column's scale
(measured 4e-7); positive ratios, graphs, geodesic matrices and smoothed X
exactly, or to 1e-12 where float64 sums are taken in another order; the
between-slice scan's `fgw` problems equal, and its table after one outer
iteration a solve to 1e-4 of scale (the solver itself in `test_torch_ot.py`).
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.svg import utils as jsu
from spateo_tpu_torch.svg import utils as tsu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-5
GW_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU among its
    workers, where torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _coords(side=20, jitter=0.3, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(float(side)), np.arange(float(side)))
    c = np.c_[xs.ravel(), ys.ravel()]
    return c + rng.uniform(-jitter, jitter, c.shape) if jitter else c


def _expr(coords, G=40, n_planted=5, seed=0):
    """Poisson background at 0.5-3, and `n_planted` genes each expressed in
    one horizontal band."""
    rng = np.random.default_rng(seed + 1)
    n = len(coords)
    X = rng.poisson(rng.uniform(0.5, 3, G), (n, G)).astype(float)
    h = coords[:, 1].max() + 1
    for g in range(n_planted):
        band = (coords[:, 1] >= g * h / n_planted) & (coords[:, 1] < (g + 1) * h / n_planted)
        X[:, g] = np.where(band, rng.poisson(6, n), rng.poisson(0.2, n))
    return X


def _pair(coords, X, genes=None):
    """The same AnnData in both packages."""
    genes = genes or [f"g{i}" for i in range(X.shape[1])]
    out = []
    for pkg in (st, stt):
        a = pkg.AnnData(X=X.copy(), var=pd.DataFrame(index=genes),
                        obs=pd.DataFrame(index=[f"c{i}" for i in range(len(coords))]))
        a.obsm["spatial"] = coords.copy()
        pkg.SKM.init_adata_type(a, "UMI")
        out.append(a)
    return out


def _same_frames(wj, wt, tol=SCORE_TOL, exact=("positive_ratio", "raw_pos_rate", "positive_ratio1",
                                               "positive_ratio2")):
    assert list(wj.index) == list(wt.index) and list(wj.columns) == list(wt.columns)
    for c in wj.columns:
        a, b = np.asarray(wt[c].values, float), np.asarray(wj[c].values, float)
        if c in exact:
            np.testing.assert_array_equal(a, b, err_msg=c)
        else:
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=c)
            fin = ~np.isnan(b)
            assert not fin.any() or _scaled(a[fin], b[fin]) <= tol, c


@pytest.mark.parametrize("k", [1, 9, 31])
def test_knn_graph_equals_sklearn_without_ties(k):
    """Jittered coordinates: the port's graph (k neighbours and the point
    itself, distance mode) equals the JAX package's scikit-learn graph
    entry for entry."""
    c = _coords(seed=2)
    np.testing.assert_array_equal(tsu._knn_distance_graph(c, k).toarray(), jsu._knn_distance_graph(c, k).toarray())


@pytest.mark.parametrize("k", [8, 9, 31])
@pytest.mark.parametrize("side", [20, 13])
def test_knn_lattice_ties_by_distance_then_index(k, side):
    """On a lattice the k-th distance is tied; the port keeps, of the tied
    points, the smallest indices: a stable numpy sort of the full distance
    rows by (distance, index) gives the same indices and distances."""
    c = _coords(side, jitter=0)
    idx, dist = tsu.knn_indices(c, k)
    D = np.sqrt(((c[:, None, :] - c[None, :, :]) ** 2).sum(-1))
    ref = np.argsort(D, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx, ref)
    np.testing.assert_array_equal(dist, np.take_along_axis(D, ref, 1))


def test_lattice_results_move_from_sklearns_choice():
    """On a 16 x 16 lattice (n_neighbors 8, smoothing over 8): how far the
    port's results lie from the JAX package's, whose scikit-learn kd-tree
    keeps other tied points. Measured: neighbour sets differ in 5 of 256
    rows at k = 8 and 219 at k = 31; the geodesic matrix 8.4e-3 of its
    scale; smoothed X 0.24 of its scale in 144 rows; over 12 genes,
    Wasserstein scores 1.1e-4 and z-scores 1.5e-4 of scale, the top 5 genes
    the same. Bounds are about twice those."""
    c = _coords(16, jitter=0)
    rows = {}
    for k in (8, 31):
        gj, gt = (f(c, k).toarray() > 0 for f in (jsu._knn_distance_graph, tsu._knn_distance_graph))
        rows[k] = int((gj != gt).any(1).sum())
    assert 0 < rows[8] <= 10 and 0 < rows[31] <= 256
    aj, at = _pair(c, _expr(c, G=12))
    kw = dict(n_neighbors=8, min_dis_cutoff=2, max_dis_cutoff=3)
    geo = _scaled(tsu.cal_geodesic_distance(at, **kw).obsp["distance"],
                  jsu.cal_geodesic_distance(aj, **kw).obsp["distance"])
    assert 0 < geo <= 1.7e-2
    assert 0 < _scaled(stt.svg.smooth(at).X, st.svg.smooth(aj).X) <= 0.5
    wj = st.svg.svg_iden_reg(aj, **kw)
    wt = stt.svg.svg_iden_reg(at, device="cpu", **kw)
    assert _scaled(wt["Wasserstein_distance"], wj["Wasserstein_distance"]) <= 2.3e-4
    assert _scaled(wt["zscore"], wj["zscore"]) <= 3e-4
    assert list(wt["zscore"].nlargest(5).index) == list(wj["zscore"].nlargest(5).index)


def test_geodesic_and_euclidean_distances_match_jax():
    """Filters (some cells dropped by each cutoff) and Floyd-Warshall: the
    same cells and the same float64 matrix."""
    c = _coords(seed=3)
    aj, at = _pair(c, _expr(c))
    bj = jsu.cal_geodesic_distance(aj, n_neighbors=8, min_dis_cutoff=0.9, max_dis_cutoff=2.2)
    bt = tsu.cal_geodesic_distance(at, n_neighbors=8, min_dis_cutoff=0.9, max_dis_cutoff=2.2)
    assert 200 < bt.n_obs < 400 and list(bt.obs_names) == list(bj.obs_names)
    np.testing.assert_array_equal(bt.obsp["distance"], bj.obsp["distance"])
    ej = jsu.cal_euclidean_distance(aj, min_dis_cutoff=0.8, max_dis_cutoff=20.0)
    et = tsu.cal_euclidean_distance(at, min_dis_cutoff=0.8, max_dis_cutoff=20.0)
    assert list(et.obs_names) == list(ej.obs_names)
    np.testing.assert_array_equal(et.obsp["distance"], ej.obsp["distance"])


@pytest.mark.parametrize("method,kw", [("geodesic", dict(n_neighbors=8, min_dis_cutoff=0.9, max_dis_cutoff=2.2)),
                                       ("euclidean", dict(min_dis_cutoff=2.0, max_dis_cutoff=50.0))])
def test_svg_iden_reg_matches_jax(method, kw):
    """The whole no-bootstrap scan, column by column, on jittered
    coordinates; the planted band genes rank first in both."""
    c = _coords(16, seed=0)
    aj, at = _pair(c, _expr(c, G=12))
    wj = st.svg.svg_iden_reg(aj, cell_distance_method=method, **kw)
    wt = stt.svg.svg_iden_reg(at, cell_distance_method=method, device="cpu", **kw)
    _same_frames(wj, wt)
    assert set(wt["Wasserstein_distance"].nlargest(5).index) == {f"g{i}" for i in range(5)}


def test_cal_wass_dist_bs_matches_jax():
    """Bootstrap scan (3 rounds) with rank p-values, column by column, and
    the binned, scaled AnnData it returns."""
    c = _coords(12, seed=4)
    aj, at = _pair(c, _expr(c, G=12))
    kw = dict(n_neighbors=8, min_dis_cutoff=2.0, max_dis_cutoff=3.0, bootstrap=3, rank_p=True, bin_num=4)
    wj, bj = st.svg.cal_wass_dist_bs(aj, **kw)
    wt, bt = stt.svg.cal_wass_dist_bs(at, device="cpu", **kw)
    _same_frames(wj, wt)
    np.testing.assert_array_equal(np.asarray(bt.X), np.asarray(bj.X))


def test_gene_target_scan_matches_jax_and_stops_at_20_sweeps():
    """A gene's own pattern as the target (`cal_wass_dis_nobs(target=gene)`,
    `cal_wass_dis_target_on_genes`): the banded gene has zero bins, so each
    chunk stops after 20 sweeps (the NaN stop test), in both packages."""
    c = _coords(14, seed=5)
    X = _expr(c, G=16)
    X[:, 0] = np.where(c[:, 1] < 5, X[:, 0] + 3, 0)
    aj, at = _pair(c, X)
    kw = dict(n_neighbors=8, min_dis_cutoff=2.0, max_dis_cutoff=3.0)
    wj = st.svg.cal_wass_dis_nobs(aj, target="g0", **kw)
    reads = tsu._sinkhorn_batch_run.host_reads
    wt = stt.svg.cal_wass_dis_nobs(at, target="g0", device="cpu", **kw)
    assert tsu._sinkhorn_batch_run.host_reads - reads == 2  # one chunk, two blocks of 10 sweeps
    _same_frames(wj, wt)
    rj, _ = st.svg.cal_wass_dis_target_on_genes(aj, target_genes=["g0", "g1"], **kw)
    rt, _ = stt.svg.cal_wass_dis_target_on_genes(at, target_genes=["g0", "g1"], device="cpu", **kw)
    for g in ("g0", "g1"):
        _same_frames(rj[g], rt[g])


def _spy_fgw(monkeypatch, module, outer):
    """Record every call of `module.fgw` as (M, C1, C2, p, q, alpha, eps,
    max_iter) in host float64, then solve with `outer` outer iterations."""
    calls, real = [], module.fgw

    def host(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)

    def spy(M, C1, C2, a, b, alpha=0.1, eps=5e-3, G_init=None, max_iter=100, **kw):
        calls.append(dict(M=host(M), C1=host(C1), C2=host(C2), p=host(a), q=host(b),
                          alpha=alpha, eps=eps, max_iter=max_iter))
        return real(M, C1, C2, a, b, alpha=alpha, eps=eps, G_init=G_init, max_iter=outer, **kw)

    monkeypatch.setattr(module, "fgw", spy)
    return calls


def _same_fgw_calls(cj, ct):
    """Both packages hand `fgw` the same problem: the same float32 costs
    (what each solver reads), histograms, alpha = 1,
    eps = max(1e-2 max C, 1e-4) and 30 outer iterations."""
    assert len(ct) == len(cj) > 0
    for j, t in zip(cj, ct):
        assert t["alpha"] == j["alpha"] == 1.0 and t["max_iter"] == j["max_iter"] == 30
        assert t["eps"] == j["eps"] == max(1e-2 * max(j["C1"].max(), j["C2"].max()), 1e-4)
        for k in ("M", "C1", "C2"):
            np.testing.assert_array_equal(t[k].astype(np.float32), j[k].astype(np.float32))
        for k in ("p", "q"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-7, atol=0)
            assert abs(t[k].sum() - 1) < 1e-6
        assert not j["M"].any()


def test_cal_gro_wass_bs_matches_jax(monkeypatch):
    """Between-slice GW scan with 5 bootstrap rounds, column by column.

    g0, g1 and g4 have a zero-count cell, so their GW is NaN and reported as
    0 in both packages (`test_gw_of_a_gene_with_a_zero_count_cell_is_nan_then_0`);
    g5 has none, so its scores are finite and hold the wrapper's costs,
    histograms, shuffles and table to the JAX package's. Both packages'
    `fgw` are spied on: the problems they are handed must agree (with
    alpha = 1, the eps formula and 30 outer iterations), and each solve is
    cut to one outer iteration, where the two agree to 1e-4 of scale (the
    mirror descent amplifies the packages' float32 differences ~3x an outer
    iteration, so at 30 they are set by rounding; see the test below). Five
    rounds, not two: g5's two shuffled scores lie 0.008 apart on a mean of
    8.5, so their std cancels the scores' 5e-7 relative gap up to 1e-3 of
    itself (measured); five spread to a std of 0.16."""
    import spateo_tpu.ops.ot as jot
    import spateo_tpu_torch.ops.ot as tot

    c1, c2 = _coords(9, seed=6), _coords(9, seed=7)
    X1, X2 = _expr(c1, G=6, n_planted=2), _expr(c2, G=6, n_planted=2, seed=3)
    X1[:, 5] += 1
    X2[:, 5] += 1
    a1j, a1t = _pair(c1, X1)
    a2j, a2t = _pair(c2, X2)
    cj, ct = _spy_fgw(monkeypatch, jot, 1), _spy_fgw(monkeypatch, tot, 1)
    kw = dict(n_neighbors=8, min_dis_cutoff=2.0, max_dis_cutoff=3.0, gene_set=["g0", "g1", "g4", "g5"], bootstrap=5)
    gj, _, _ = st.svg.cal_gro_wass_bs(a1j, a2j, **kw)
    gt, b1, b2 = stt.svg.cal_gro_wass_bs(a1t, a2t, device="cpu", **kw)
    _same_fgw_calls(cj, ct)
    gw = gt["Gromov-wasserstein_distance"]
    assert (gw[["g0", "g1", "g4"]] == 0).all() and gw["g5"] > 0 and gt.loc["g5", "std"] > 0
    _same_frames(gj, gt, tol=1e-4)
    assert _scaled(gw, gj["Gromov-wasserstein_distance"]) <= 1e-4
    with pytest.raises(ValueError, match="gene_set"):
        stt.svg.cal_gro_wass_bs(a1t, a2t, device="cpu", **dict(kw, gene_set=["nope"]))


def test_gw_of_a_gene_with_a_zero_count_cell_is_nan_then_0(monkeypatch):
    """A fault of the JAX package the port keeps (ROADMAP Queue 3): a zero
    entry in p or q makes the rows (columns) of log T all -inf, so the first
    outer iteration's log-sum-exp gives -inf - -inf = NaN; the loop stops and
    `cal_gw_dis_on_genes` returns NaN, which `cal_gro_wass_bs` reports as 0.
    A gene without zero counts gets a finite distance in both packages, from
    the same problem handed to `fgw` (spied on, with its full 30 outer
    iterations). At 30 its value is set by rounding (the mirror descent at
    this eps amplifies the packages' float32 differences ~3x an outer
    iteration: plans 5.6e-5 of scale apart after one, 0.5 after 30,
    objectives up to 14% apart on 4 of 24 genes of random layouts,
    measured), so here only finiteness is held; `test_cal_gro_wass_bs_matches_jax`
    holds the value after one outer iteration, and `test_torch_ot.py` the
    GW solver itself."""
    import spateo_tpu.ops.ot as jot
    import spateo_tpu_torch.ops.ot as tot
    from spateo_tpu.svg.get_svg import bin_scale_adata_get_distance as jbin
    from spateo_tpu.svg.get_svg_between_slice import cal_gw_dis_on_genes as jgw
    from spateo_tpu_torch.svg.get_svg import bin_scale_adata_get_distance as tbin
    from spateo_tpu_torch.svg.get_svg_between_slice import cal_gw_dis_on_genes as tgw

    c1, c2 = _coords(9, seed=6), _coords(9, seed=7)
    X1, X2 = _expr(c1, G=6, n_planted=2), _expr(c2, G=6, n_planted=2, seed=3)
    X1[:, 5] += 1
    X2[:, 5] += 1
    (a1j, a1t), (a2j, a2t) = _pair(c1, X1), _pair(c2, X2)
    kw = dict(n_neighbors=8, min_dis_cutoff=2.0, max_dis_cutoff=3.0)
    (b1j, C1), (b2j, C2) = jbin(a1j, **kw), jbin(a2j, **kw)
    (b1t, D1), (b2t, D2) = tbin(a1t, **kw), tbin(a2t, **kw)
    assert (np.asarray(b1t.X)[:, 0] == 0).any() and (np.asarray(b1t.X)[:, 5] > 0).all()
    cj, ct = _spy_fgw(monkeypatch, jot, 30), _spy_fgw(monkeypatch, tot, 30)
    _, gj, _, _ = jgw((C1, C2, b1j, b2j), (0, ["g0", "g5"]))
    _, gt, _, _ = tgw((D1, D2, b1t, b2t), (0, ["g0", "g5"]), device="cpu")
    _same_fgw_calls(cj, ct)
    assert np.isnan(gj[0]) and np.isnan(gt[0])
    assert np.isfinite(gt[1]) and np.isfinite(gj[1])


def test_smoothing_and_sampling_match_jax():
    """Smoothing over the 8 nearest cells and the 400 -> 100 random
    downsample: the same cells and X (float64 sums in another order)."""
    c = _coords(seed=8)
    aj, at = _pair(c, _expr(c))
    sj, fj = st.svg.smoothing_and_sampling(aj, downsampling=100)
    stt_s, ft = stt.svg.smoothing_and_sampling(at, downsampling=100, device="cpu")
    assert list(stt_s.obs_names) == list(sj.obs_names)
    np.testing.assert_allclose(np.asarray(ft.X), np.asarray(fj.X), rtol=1e-12, atol=0)
    dj, dt = st.svg.downsampling(aj, 50), stt.svg.downsampling(at, 50)
    assert list(dt.obs_names) == list(dj.obs_names)


def test_smooth_on_a_lattice_follows_the_rule():
    """Lattice coordinates: each cell's smoothed X is the mean of X over its
    8 nearest cells by (distance, index), from a numpy brute force."""
    c = _coords(12, jitter=0)
    X = _expr(c, G=7)
    _, at = _pair(c, X)
    out = np.asarray(stt.svg.smooth(at).X)
    D = np.sqrt(((c[:, None, :] - c[None, :, :]) ** 2).sum(-1))
    nn = np.argsort(D, axis=1, kind="stable")[:, :8]
    np.testing.assert_allclose(out, X[nn].sum(1) / 8, rtol=1e-12)


def test_host_helpers_match_jax():
    """Binning, scaling, loess, Holm-Sidak and BH, rank p-values and the
    shuffles: host code, equal outputs."""
    c = _coords(10, seed=9) * 3
    X = _expr(c, G=8)
    aj, at = _pair(c, X)
    bj, bt = st.pp.bin_adata(aj, bin_size=4), stt.pp.bin_adata(at, bin_size=4)
    assert list(bt.obs_names) == list(bj.obs_names)
    np.testing.assert_array_equal(bt.X.toarray(), bj.X.toarray())
    np.testing.assert_array_equal(bt.obsm["spatial"], bj.obsm["spatial"])
    np.testing.assert_array_equal(tsu.bin_adata(at, 4).X.toarray(), jsu.bin_adata(aj, 4).X.toarray())
    np.testing.assert_array_equal(np.asarray(tsu.scale_to(at).X), np.asarray(jsu.scale_to(aj).X))
    np.testing.assert_array_equal(np.asarray(tsu.shuffle_adata(at, 3).X), np.asarray(jsu.shuffle_adata(aj, 3).X))
    from spateo_tpu.tools import spatially_variable_gene_ot as jsvo
    from spateo_tpu_torch.tools import spatially_variable_gene_ot as tsvo

    np.testing.assert_array_equal(tsvo.shuffle_adata(at, 0).X, jsvo.shuffle_adata(aj, 0).X)
    rng = np.random.default_rng(0)
    x, y = rng.uniform(size=60), rng.normal(size=60)
    np.testing.assert_array_equal(tsu.loess_1d(x, y)[1], jsu.loess_1d(x, y)[1])
    np.testing.assert_array_equal(tsu.loess_reg(x, y)[1], jsu.loess_reg(x, y)[1])
    p = rng.uniform(size=50) ** 3
    np.testing.assert_array_equal(tsu.multipletests_hs(p), jsu.multipletests_hs(p))
    np.testing.assert_array_equal(tsu.multipletests_bh(p), jsu.multipletests_bh(p))
    genes = [f"g{i % 6}" for i in range(30)]
    ws = rng.uniform(size=30)
    w_df = pd.DataFrame({"mean": rng.uniform(size=6), "Wasserstein_distance": rng.uniform(size=6)},
                        index=[f"g{i}" for i in range(6)])
    assert tsu.cal_rank_p(genes, ws, w_df, bin_num=3)[0] == jsu.cal_rank_p(genes, ws, w_df, bin_num=3)[0]
    for fn in ("add_pos_ratio_to_adata",):
        getattr(tsu, fn)(at), getattr(jsu, fn)(aj)
    np.testing.assert_array_equal(tsu.get_genes_by_pos_ratio(at, 0.5), jsu.get_genes_by_pos_ratio(aj, 0.5))
    assert tsu.filter_adata_by_pos_ratio(at, 0.5).n_vars == jsu.filter_adata_by_pos_ratio(aj, 0.5).n_vars


def test_svg_and_paste_run_without_jax_or_sklearn():
    """`svg_iden_reg` and `paste_align` on the CPU in a fresh interpreter
    where scikit-learn cannot be imported: neither loads JAX, `spateo_tpu`
    or scikit-learn."""
    code = (
        "import sys; sys.modules['sklearn'] = None\n"
        "import numpy as np, pandas as pd; import spateo_tpu_torch as stt\n"
        "rng = np.random.default_rng(0); n = 144\n"
        "c = np.c_[np.repeat(np.arange(12.), 12), np.tile(np.arange(12.), 12)] + rng.uniform(-.3, .3, (n, 2))\n"
        "X = rng.poisson(2.0, (n, 6)).astype(float)\n"
        "def mk(c):\n"
        "    a = stt.AnnData(X=X.copy(), var=pd.DataFrame(index=[f'g{i}' for i in range(6)]),"
        " obs=pd.DataFrame(index=[f'c{i}' for i in range(n)]))\n"
        "    a.obsm['spatial'] = c.copy(); stt.SKM.init_adata_type(a, 'UMI'); return a\n"
        "w = stt.svg.svg_iden_reg(mk(c), min_dis_cutoff=2.0, max_dis_cutoff=3.0, device='cpu')\n"
        "assert w.shape[0] == 6 and np.isfinite(w['zscore']).all()\n"
        "s, _ = stt.svg.smoothing_and_sampling(mk(c), downsampling=50, device='cpu')\n"
        "models, pis = stt.align.paste_align([mk(c), mk(c + 1.0)], numItermax=10, verbose=False, device='cpu')\n"
        "assert pis[0].shape == (n, n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'spateo_tpu') and sys.modules[m]]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_chip_smoke_svg_and_paste_paths_on_cpu():
    """`chip_smoke.py` phase 18's helpers at a small size on the CPU (16
    genes, 4 planted; the card runs 4,000 with a recall bar of its own):
    most planted genes lead the scan's z-scores (3 of 4 measured), and
    PASTE's rotation on the pair of sections with counts drawn anew agrees
    with the JAX package's on the same pair to `PASTE_ANGLE_BAR` degrees.
    Both miss the planted rotation there (118.9 and 119.5 deg, measured;
    ROADMAP Queue 3), as they do at the card's size."""
    sys.path.insert(0, REPO)
    import chip_smoke

    w0, small, stages = chip_smoke.svg_scan(chip_smoke.cortex_section(2_000, 16, n_planted=4, seed=0), "cpu")
    assert small.n_obs == 400 and len(w0) == 16 and {"scan", "loess", "graph"} <= set(stages)
    assert chip_smoke.svg_recall(w0, n_planted=4) >= 0.5
    pair = chip_smoke.paste_sections(2_000, 64)
    aligned, refs, pi, log, _ = chip_smoke.paste_main(pair, "cpu", n_sampling=300)
    assert pi.shape == (300, 300) and log.iterations == [200] and "V_mapping" in refs[0].obsm
    jpair = []
    for a in pair:
        j = st.AnnData(X=a.X.copy(), var=pd.DataFrame(index=list(a.var_names)), obs=pd.DataFrame(index=list(a.obs_names)))
        j.obsm["spatial"] = np.asarray(a.obsm["spatial"]).copy()
        st.SKM.init_adata_type(j, st.SKM.ADATA_UMI_TYPE)
        jpair.append(j)
    _, jrefs, _ = st.align.paste_align_ref(jpair, n_sampling=300, sampling_method="trn", numItermax=200, verbose=False)
    errs = [chip_smoke.rotation_error_deg(r[1].uns["models_align"]["R"]) for r in (refs, jrefs)]
    assert abs(errs[0] - errs[1]) <= chip_smoke.PASTE_ANGLE_BAR, errs
