"""The rest of Starro in the port held against the JAX package on the CPU:
image and threshold ops, the NB fits (EM and VI), Moran's I, the staged
scoring methods with density bins and certain masks, stain masks, the Ward
tree and density bins, safe erosion, the labeling functions, benchmarking,
simulation, and the whole segmentation tutorial chain.

Every raster is made with numpy from a seed and handed to both packages.
Tolerances, per test:

- integer and boolean outputs (labels, masks, bins, thresholds, areas), and
  convolutions of integer rasters: exact;
- convolutions of float rasters: 2e-6 of the raster's scale (the JAX
  package's per-bin and large-kernel convolutions are XLA convolutions,
  whose order of addition is its own);
- the NB-mixture EM: rtol 1e-4 (lgamma and digamma differ at the ulp);
  conditionals and posteriors: 1e-5; Moran's I: 1e-5 of scale;
- VI after 500 Adam steps: rtol 5e-2 on the parameters (Adam's late steps
  amplify rounding near the flat optimum); VI conditionals given the same
  parameters: 1e-5.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.ops import em as jem
from spateo_tpu.ops import image as jimg
from spateo_tpu.ops import threshold as jthr
from spateo_tpu.segmentation import density as jden
from spateo_tpu.segmentation import icell as jic
from spateo_tpu.segmentation import label as jlab
from spateo_tpu.segmentation import moran as jmor
from spateo_tpu.segmentation import utils as jut
from spateo_tpu.segmentation import vi as jvi
from spateo_tpu_torch.core.bridge import adata_from_reference
from spateo_tpu_torch.ops import em as tem
from spateo_tpu_torch.ops import image as timg
from spateo_tpu_torch.ops import threshold as tthr
from spateo_tpu_torch.segmentation import density as tden
from spateo_tpu_torch.segmentation import icell as tic
from spateo_tpu_torch.segmentation import moran as tmor
from spateo_tpu_torch.segmentation import utils as tut
from spateo_tpu_torch.segmentation import vi as tvi

REPO = Path(__file__).resolve().parent.parent
CPU = dict(device="cpu")


def _tile(shape=(96, 128), seed=0):
    """NB(1, 0.5) background, disks of NB(8, 0.35) cells, and a second
    NB(1, 0.5) draw on the right half: two tissue depths."""
    r = np.random.default_rng(seed)
    X = r.negative_binomial(1, 0.5, shape).astype(np.float32)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    for _ in range(shape[0] * shape[1] // 400):
        cy, cx, rr = r.integers(0, shape[0]), r.integers(0, shape[1]), r.integers(3, 7)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= rr * rr
        X[m] += r.negative_binomial(8, 0.35, int(m.sum()))
    X[:, shape[1] // 2 :] += r.negative_binomial(1, 0.5, (shape[0], shape[1] - shape[1] // 2))
    return X


def _bins(shape=(96, 128)):
    b = np.ones(shape, int)
    b[:, shape[1] // 2 :] = 2
    b[:5] = 0
    return b


def _certain(shape=(96, 128)):
    c = np.zeros(shape, bool)
    c[40:44, 40:44] = True
    return c


def _disks(shape, n, seed, rmin=3, rmax=12):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    m = np.zeros(shape, bool)
    for _ in range(n):
        cy, cx, rr = r.integers(0, shape[0]), r.integers(0, shape[1]), r.integers(rmin, rmax)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rr * rr
    return m


def _agg(X, **layers):
    a = st.AnnData(X=X, layers=layers)
    st.SKM.init_adata_type(a, st.SKM.ADATA_AGG_TYPE)
    return a, adata_from_reference(a)


def _iou(a, b):
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)


# -- ops: image and thresholds ---------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5, 9, 15])
@pytest.mark.parametrize(
    "mode,with_bins", [("gauss", False), ("gauss", True), ("circle", False), ("circle", True), ("square", False),
                       ("square", True), ("median", False)]
)
def test_conv2d_matches_jax(mode, with_bins, k):
    """Integer rasters under the binary and cv2-fixed (dyadic) kernels:
    exact, since every product and partial sum is exact in f32. Otherwise
    2e-6 of scale: the JAX package's CPU build fuses each tap's multiply
    and add (FMA) and runs per-bin and large kernels as XLA convolutions."""
    rng = np.random.default_rng(k)
    bins = _bins((64, 80)) if with_bins else None
    for X, exact in (
        (rng.negative_binomial(2, 0.3, (64, 80)).astype(np.float32), mode != "gauss" or k <= 7),
        (rng.uniform(size=(64, 80)).astype(np.float32), mode == "median"),
    ):
        ref = np.asarray(jimg.conv2d(X, k, mode, bins))
        out = timg.conv2d(X, k, mode, bins, **CPU).numpy()
        if exact:
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def test_conv2d_arguments_and_scales():
    X = np.random.default_rng(0).uniform(size=(20, 24)).astype(np.float32)
    for bad in (dict(k=4), dict(k=3, mode="box")):
        with pytest.raises(ValueError):
            timg.conv2d(X, **bad, **CPU)
    with pytest.raises(ValueError):
        timg.conv2d(X, 3, "median", bins=np.ones(X.shape, int), **CPU)
    np.testing.assert_array_equal(timg.conv2d(X, 3, bins=np.zeros(X.shape, int), **CPU).numpy(), 0)
    np.testing.assert_array_equal(timg.scale_to_01(X, **CPU).numpy(), np.asarray(jimg.scale_to_01(X)))
    np.testing.assert_array_equal(timg.scale_to_255(X, **CPU).numpy(), np.asarray(jimg.scale_to_255(X)))
    np.testing.assert_allclose(timg.gaussian_blur(X, 5, **CPU).numpy(), np.asarray(jimg.gaussian_blur(X, 5)), atol=2e-6)
    for k in (1, 3, 5, 7, 9):
        np.testing.assert_array_equal(timg.gaussian_kernel_1d(k), jimg.gaussian_kernel_1d(k))
    u8 = (X * 255).astype(np.uint8)
    np.testing.assert_array_equal(timg.clahe(u8, 2.0, (4, 4)), jimg.clahe(u8, 2.0, (4, 4)))


@pytest.mark.parametrize("kind", ["counts", "uniform", "stain"])
def test_thresholds_match_jax(kind):
    """Multi-Otsu (2, 3 and 5 classes) and the knee: exact; the local
    surface (k 55, an XLA convolution in JAX): rtol 1e-5."""
    rng = np.random.default_rng(3)
    X = {
        "counts": rng.negative_binomial(2, 0.3, (64, 80)).astype(np.float32),
        "uniform": rng.uniform(size=(64, 80)).astype(np.float32),
        "stain": rng.integers(0, 255, (64, 80)).astype(np.uint8),
    }[kind]
    for classes in (2, 3, 5):
        np.testing.assert_array_equal(tthr.threshold_multiotsu(X, classes, **CPU), jthr.threshold_multiotsu(X, classes))
    assert tthr.knee_threshold(X) == jthr.knee_threshold(X)
    for method, k in (("gaussian", 55), ("gaussian", 5), ("mean", 7)):
        ref = np.asarray(jthr.threshold_local(X, k, method, offset=-5))
        np.testing.assert_allclose(tthr.threshold_local(X, k, method, offset=-5, **CPU).numpy(), ref, rtol=1e-5)
    with pytest.raises(ValueError):
        tthr.threshold_local(X, 5, "median", **CPU)


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_apply_threshold_matches_jax(threshold):
    X = np.random.default_rng(5).uniform(size=(48, 64)).astype(np.float32)
    np.testing.assert_array_equal(tut.apply_threshold(X, 3, threshold, **CPU), jut.apply_threshold(X, 3, threshold))


# -- density bins: the Ward tree against scikit-learn ---------------------------------------


@pytest.mark.parametrize("shape,quantum", [((8, 9), 4), ((16, 16), 4), ((32, 20), 0), ((24, 24), 2)])
def test_ward_tree_matches_sklearn(shape, quantum):
    """Children, parents and distances equal to sklearn's `ward_tree` under
    the same grid connectivity, and every cut labelled as `_hc_cut` labels
    it, on rasters with many ties (values rounded to 1/quantum)."""
    from sklearn import cluster

    X = np.random.default_rng(sum(shape)).uniform(size=shape)
    if quantum:
        X = np.round(X * quantum) / quantum
    ch, _, nl, par, dist = cluster.ward_tree(
        X.reshape(-1, 1), connectivity=jden._create_spatial_adjacency(shape), return_distance=True
    )
    ch2, nl2, par2, dist2 = tden._ward_tree(X, shape)
    assert nl2 == nl
    np.testing.assert_array_equal(ch2, ch)
    np.testing.assert_array_equal(par2, par)
    np.testing.assert_array_equal(dist2, dist)
    for n_clusters in (1, 2, 3, 7, X.size):
        np.testing.assert_array_equal(tden._hc_cut(n_clusters, ch2, nl2), cluster._agglomerative._hc_cut(n_clusters, ch, nl))
    with pytest.raises(ValueError):
        tden._hc_cut(X.size + 1, ch2, nl2)
    np.testing.assert_array_equal(tden._schc(X), jden._schc(X))
    np.testing.assert_array_equal(tden._schc(X, 0.5), jden._schc(X, 0.5))


@pytest.mark.parametrize("binsize,background", [(1, None), (4, True), (4, (10, 100)), (8, False)])
def test_segment_densities_matches_jax(binsize, background):
    """The same bins as the JAX package's (its Ward tree is scikit-learn's),
    then `merge_densities`."""
    a_ref, a_port = _agg(_tile((64, 128), 1))
    st.cs.segment_densities(a_ref, "X", binsize, 3, 3, background=background)
    stt.cs.segment_densities(a_port, "X", binsize, 3, 3, background=background, **CPU)
    np.testing.assert_array_equal(a_port.layers["X_bins"], a_ref.layers["X_bins"])
    assert len(np.unique(a_port.layers["X_bins"])) >= 2
    st.cs.merge_densities(a_ref, "X", {1: 2})
    stt.cs.merge_densities(a_port, "X", {1: 2})
    np.testing.assert_array_equal(a_port.layers["X_bins"], a_ref.layers["X_bins"])


# -- safe erosion ------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw", [dict(k=3, min_area=20), dict(k=5, min_area=50, square=True), dict(k=3, min_area=10, n_iter=2),
           dict(k=3, min_area=5, max_iter=3)]
)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_safe_erode_matches_jax(seed, kw):
    """Boolean masks bit for bit, including an isolated last pixel (whose
    root the JAX scatter drops); the host reads are counted."""
    m = _disks((60, 70), 12, seed)
    m[-1, -1], m[-2, -2:], m[-1, -2] = True, False, False
    before = tut.safe_erode.host_reads
    np.testing.assert_array_equal(tut.safe_erode(m, **kw, **CPU), jut.safe_erode(m, **kw))
    assert tut.safe_erode.host_reads > before


def test_safe_erode_float_matches_jax():
    """Float rasters (grey erosion, thresholded with close/open) equal the
    JAX package's while the objects stay clear of the border: its patches
    turn the +inf padding into NaN (inf * 0 in the patch convolution), a
    band that grows by k // 2 a step; the port pads with +inf as cv2.erode
    does. With `float_k` or `float_threshold` missing both raise."""
    m = np.zeros((64, 72), bool)
    m[12:-12, 12:-12] = _disks((40, 48), 8, 4, 3, 9)
    X = (m * np.random.default_rng(4).uniform(0.5, 1, m.shape)).astype(np.float32)
    for kw in (dict(k=3, min_area=20, n_iter=2), dict(k=3, min_area=30, n_iter=3, square=True)):
        out = tut.safe_erode(X, float_k=3, float_threshold=0.3, **kw, **CPU)
        np.testing.assert_array_equal(out, jut.safe_erode(X, float_k=3, float_threshold=0.3, **kw))
        assert out.any()
    with pytest.raises(ValueError):
        tut.safe_erode(X, 3, **CPU)


# -- NB fits -----------------------------------------------------------------------------


def _density(bins=None):
    return timg.conv2d(_tile(), 5, bins=bins, **CPU).numpy()


@pytest.mark.parametrize("with_bins", [False, True])
def test_initial_nb_params_match_jax(with_bins):
    """The Otsu split's initial parameters: equal (numpy means and variances
    as in the JAX package, the same Otsu threshold)."""
    bins = _bins() if with_bins else None
    res = _density(bins)
    assert tic._initial_nb_params(res, bins) == jic._initial_nb_params(res, bins)


@pytest.mark.parametrize("with_bins", [False, True])
def test_run_em_matches_jax(with_bins):
    """run_em from the same seed (the same numpy downsample): rtol 1e-4.
    Given the same fit: conditionals within 1e-5, the posterior within 2e-5
    (lgamma's last-bit differences at |log pmf| ~ 70 pass through exp and
    the ratio), NaN where JAX has NaN."""
    bins = _bins() if with_bins else None
    res = _density(bins)
    params = jic._initial_nb_params(res, bins)
    ref = jem.run_em(res, downsample=0.05, params=params, bins=bins, seed=0)
    out = tem.run_em(res, downsample=0.05, params=params, bins=bins, seed=0, **CPU)
    for a, b in (zip(ref.values(), out.values()) if with_bins else [(ref, out)]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.array(y), np.array(x), rtol=1e-4)
    np.testing.assert_allclose(tem.confidence(res, ref, bins, **CPU), jem.confidence(res, ref, bins), atol=2e-5)
    for x, y in zip(tem.conditionals(res, ref, bins, **CPU), jem.conditionals(res, ref, bins)):
        np.testing.assert_allclose(x, y, atol=1e-5)
    np.testing.assert_allclose(tem.nbn_pmf(3.0, 0.3, res[:4], **CPU), jem.nbn_pmf(3.0, 0.3, res[:4]), atol=1e-5)
    with pytest.raises(stt.SegmentationError):
        tem.run_em(res, params=dict(w=(0.5, 0.5)), **CPU)


def test_batched_em_rows_are_their_own_fits():
    """Rows of one batched fit equal the one-row fits exactly (each row's
    sums are taken on their own), whatever the batch."""
    rng = np.random.default_rng(0)
    S = 700
    X = torch.from_numpy(rng.negative_binomial(2, 0.1, (3, S)).astype(np.float32))
    w0 = torch.tensor([[0.7, 0.3]] * 3)
    mu0 = torch.tensor([[5.0, 40.0], [3.0, 30.0], [8.0, 60.0]])
    var0 = mu0 * 3
    ones = torch.ones((3, S), dtype=torch.bool)
    batched = tem._nbn_em_batched(X, ones, w0, mu0, var0, 300, 1e-6, rowwise=True)
    for b in range(3):
        single = tem._nbn_em_batched(X[b : b + 1], ones[:1], w0[b : b + 1], mu0[b : b + 1], var0[b : b + 1], 300, 1e-6)
        for x, y in zip(batched, single):
            assert torch.equal(x[b], y[0])


@pytest.mark.parametrize("mask", [False, True])
def test_moran_matches_jax(mask):
    """moranI's (z, c, I, p) within 1e-5 of each array's scale (60x70 < 46,341
    pixels, where the JAX package's int32 products do not wrap);
    run_moran's map and run_moran_and_mask_pixels' mask."""
    X = _density()[:60, :70]
    m = _bins()[:60, :70] > 0 if mask else None
    kern = jmor._moran_kernel_weights(7)
    for a, b in zip(tmor.moranI(X, kern, m, **CPU), jmor.moranI(X, kern, m)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    ref = jmor.run_moran(X, mask=m)
    np.testing.assert_allclose(tmor.run_moran(X, mask=m, **CPU), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    a_ref, a_port = _agg(X)
    st.cs.run_moran_and_mask_pixels(a_ref, "X", mask=m)
    stt.cs.run_moran_and_mask_pixels(a_port, "X", mask=m, **CPU)
    out, ref = a_port.layers["X_mask"], np.asarray(a_ref.layers["X_mask"])
    assert out.any() == ref.any() and (not ref.any() or _iou(out, ref) >= 0.999)
    assert out.any() or mask


@pytest.mark.parametrize("with_bins", [False, True])
def test_run_vi_matches_jax(with_bins):
    """500 Adam steps from the same initial values and downsample: rtol 5e-2
    on every parameter; conditionals given the JAX fit's parameters: 1e-5."""
    bins = _bins() if with_bins else None
    res = _density(bins)
    params = jic._initial_nb_params(res, bins)
    ref = jvi.run_vi(res, bins=bins, params=params, seed=0)
    out = tvi.run_vi(res, bins=bins, params=params, seed=0, **CPU)
    for a, b in (zip(ref.values(), out.values()) if with_bins else [(ref, out)]):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(b[key], a[key], rtol=5e-2)
    for x, y in zip(tvi.conditionals(res, ref, bins, **CPU), jvi.conditionals(res, ref, bins)):
        np.testing.assert_allclose(x, y, atol=1e-5)


def test_vi_mixture_options_match_jax():
    """Random initial values (no w/mu/var) and zero inflation draw from the
    same `default_rng(seed)`; conditionals with weights and a gate: 1e-5."""
    x = np.random.default_rng(2).negative_binomial(2, 0.2, 400).astype(np.float32)
    ref = jvi.NegativeBinomialMixture(x, zero_inflated=True, seed=3)
    out = tvi.NegativeBinomialMixture(x, zero_inflated=True, seed=3, **CPU)
    for name in ("_w0", "_counts0", "_logits0", "_z0"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name))
    ref.train(60)
    out.train(60)
    pr, po = ref.get_params(), out.get_params()
    for key in pr:
        np.testing.assert_allclose(po[key], pr[key], rtol=5e-2, atol=1e-3)
    for a, b in zip(
        tvi.NegativeBinomialMixture.conditionals(pr, x, use_weights=True, **CPU),
        jvi.NegativeBinomialMixture.conditionals(pr, x, use_weights=True),
    ):
        np.testing.assert_allclose(a, b, atol=1e-5)
    with pytest.raises(stt.SegmentationError):
        tvi.NegativeBinomialMixture(x, w=(0.5, 0.5), **CPU)


# -- the staged scoring methods ---------------------------------------------------------------

SCORE_TOL = {"gauss": 1e-6, "moran": 1e-6, "em": 1e-4, "em+gauss": 1e-4, "em+bp": 1e-4, "vi+bp": 1e-4}


@pytest.mark.parametrize("with_bins", [False, True])
@pytest.mark.parametrize("method", ["gauss", "moran", "em", "em+gauss", "em+bp", "vi+bp", "vi+gauss"])
def test_score_pixels_matches_jax(method, with_bins, monkeypatch):
    """`_score_pixels` for all seven methods, without and with bins and a
    certain mask, against the JAX package's (VI methods given the JAX fit's
    parameters, so that the composition is what is compared): within
    SCORE_TOL, NaN where JAX has NaN (EM posteriors outside the bins). The
    JAX package's vi+gauss raises; the port's is held against the same
    composition built from the JAX package's VI pieces."""
    bins, certain = (_bins(), _certain()) if with_bins else (None, None)
    X = _tile()
    kw = dict(
        em_kwargs=dict(seed=0, downsample=0.05) if "em" in method else None,
        vi_kwargs=dict(seed=0) if "vi" in method else None,
        bp_kwargs=dict(max_iter=30) if "bp" in method else None,
    )
    if "vi" in method:
        fits = {}
        real = jvi.run_vi

        def jax_fit(*a, **k):
            k.pop("device", None)
            fits["vi"] = real(*a, **k)
            return fits["vi"]

        monkeypatch.setattr(tvi, "run_vi", jax_fit)
    out = tic._score_pixels(X, 5, method, certain_mask=certain, bins=bins, **kw, **CPU).numpy()
    assert out.shape == X.shape and out.dtype == np.float32
    if method == "vi+gauss":
        with pytest.raises(UnboundLocalError):
            jic._score_pixels(X, 5, method, certain_mask=certain, bins=bins, **kw)
        res = np.asarray(jimg.conv2d(X.astype(float), 5, "circle", bins=bins))
        params = fits["vi"]
        post = np.full(X.shape, np.nan)
        for label, p in (params.items() if with_bins else [(None, params)]):
            m = bins == label if with_bins else np.ones(X.shape, bool)
            c0, c1 = jvi.NegativeBinomialMixture.conditionals(p, res[m], use_weights=True)
            post[m] = c1 / (c0 + c1)
        if with_bins:
            post = np.clip(post + certain, 0, 1)
        ref = np.asarray(jimg.conv2d(post, 5, "gauss", bins=bins))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5, equal_nan=True)
        return
    ref = np.asarray(jic._score_pixels(X, 5, method, certain_mask=certain, bins=bins, **kw))
    np.testing.assert_allclose(out, ref, rtol=0, atol=SCORE_TOL[method], equal_nan=True)
    assert np.isfinite(out).any()


def test_score_pixels_rejects_bad_inputs():
    X = _tile((32, 40))
    for kw in (dict(method="bogus"), dict(method="em", certain_mask=np.ones((3, 3), bool)),
               dict(method="em", bins=np.ones((3, 3), int))):
        with pytest.raises(stt.SegmentationError):
            tic._score_pixels(X, 3, **kw, **CPU)


@pytest.mark.parametrize(
    "options",
    [dict(method="EM+BP", bins=True), dict(method="EM+BP", threshold=0.6), dict(method="EM", use_knee=True),
     dict(method="EM+BP", certain=True, bp_kwargs=dict(max_iter=20, k=5)), dict(method="gauss", mk=5),
     dict(method="moran", moran_kwargs=dict(k=5)), dict(method="EM+gauss", bins=True, certain=True)],
    ids=["bins", "threshold", "knee", "certain", "gauss", "moran", "em+gauss_bins_certain"],
)
def test_score_and_mask_pixels_staged_matches_jax(options):
    """The public entry point on the staged path: the same layers, scores
    within 1e-4 (NaN where JAX has NaN), masks with IoU >= 0.999."""
    options = dict(options)
    layers = {}
    if options.pop("bins", False):
        layers["X_bins"] = _bins()
    if options.pop("certain", False):
        layers["certain"] = _certain()
        options["certain_layer"] = "certain"
    a_ref, a_port = _agg(_tile(), **layers)
    options.setdefault("em_kwargs", dict(seed=0, downsample=0.05))
    st.cs.score_and_mask_pixels(a_ref, "X", 5, **options)
    stt.cs.score_and_mask_pixels(a_port, "X", 5, **options, **CPU)
    np.testing.assert_allclose(a_port.layers["X_scores"], a_ref.layers["X_scores"], atol=1e-4, equal_nan=True)
    m = a_port.layers["X_mask"]
    assert m.dtype == bool and 0 < m.mean() < 1
    assert _iou(m, a_ref.layers["X_mask"]) >= 0.999


def test_score_and_mask_pixels_fast_path_condition():
    """EM+BP with nothing that leaves the fused program takes it (the same
    call `starro_em_bp` makes); a `mesh=` that is not a `DeviceMesh` raises
    (the sharded path is `tests/test_torch_parallel_starro.py`'s)."""
    a = stt.AnnData(X=_tile((64, 96)))
    stt.SKM.init_adata_type(a, stt.SKM.ADATA_AGG_TYPE)
    stt.cs.score_and_mask_pixels(a, "X", 3, "EM+BP", em_kwargs=dict(seed=0), bp_kwargs=dict(max_iter=15), **CPU)
    scores, mask = stt.cs.starro_em_bp(a.X, k=3, seed=0, bp_max_iter=15, **CPU)
    np.testing.assert_array_equal(a.layers["X_scores"], scores.numpy())
    np.testing.assert_array_equal(a.layers["X_mask"], mask.numpy())
    with pytest.raises(TypeError, match="DeviceMesh"):
        stt.cs.score_and_mask_pixels(a, "X", 3, "EM", mesh=object(), **CPU)


@pytest.mark.parametrize("which", ["cells", "nuclei"])
def test_stain_masks_match_jax(which):
    """Stain masks from a uint8 image of blurred disks: cells (multi-Otsu)
    exact; nuclei (the k 55 local surface is an XLA convolution in JAX)
    IoU >= 0.999. A missing stain layer raises."""
    m = _disks((96, 112), 18, 7, 4, 9)
    img = np.clip(np.asarray(jimg.conv2d(m * 200.0, 7, "gauss")) + np.random.default_rng(7).integers(0, 30, m.shape), 0,
                  255).astype(np.uint8)
    a_ref, a_port = _agg(np.zeros(m.shape, np.float32), stain=img)
    fn = "mask_cells_from_stain" if which == "cells" else "mask_nuclei_from_stain"
    getattr(st.cs, fn)(a_ref)
    getattr(stt.cs, fn)(a_port, **CPU)
    out, ref = a_port.layers["stain_mask"], np.asarray(a_ref.layers["stain_mask"])
    assert out.dtype == bool and 0 < out.mean() < 1
    if which == "cells":
        np.testing.assert_array_equal(out, ref)
    else:
        assert _iou(out, ref) >= 0.999
    del a_port.layers["stain"]
    with pytest.raises(stt.SegmentationError):
        getattr(stt.cs, fn)(a_port, **CPU)


# -- labeling ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def masked():
    """A mask with touching disks and one large blob, its scores and UMI."""
    m = _disks((80, 96), 14, 11, 4, 9)
    m[50:75, 5:40] = True
    X = (m * 5 + np.random.default_rng(1).integers(0, 3, m.shape)).astype(np.float32)
    return m, X


def _label_pair(masked, **layers):
    m, X = masked
    return _agg(X, X_mask=m, **layers)


def test_find_peaks_watershed_expand_match_jax(masked):
    """find_peaks_from_mask -> watershed -> expand_labels -> augment_labels,
    and find_peaks: equal layers."""
    a_ref, a_port = _label_pair(masked)
    for pkg, a, kw in ((st, a_ref, {}), (stt, a_port, CPU)):
        pkg.cs.find_peaks_from_mask(a, "X", 3, **kw)
        pkg.cs.watershed(a, "X", 5, **kw)
        pkg.cs.expand_labels(a, "X", distance=3, max_area=120, mask_layer="X_mask", **kw)
        pkg.cs.find_peaks(a, "X", 5, 2, out_layer="peaks", mask_layer="X_mask", **kw)
        pkg.cs.augment_labels(a, "peaks", "X_labels")
        pkg.cs.replace_labels(a, "X_labels", {1: 2, 3: 0}, out_layer="replaced")
    for key in ("X_distances", "X_markers", "X_labels", "X_labels_expanded", "peaks", "X_labels_augmented", "replaced"):
        np.testing.assert_array_equal(a_port.layers[key], np.asarray(a_ref.layers[key]), err_msg=key)
    assert a_port.layers["X_labels"].max() >= 5
    a_port.layers["bool_layer"] = masked[0]
    with pytest.raises(stt.SegmentationError):
        stt.cs.find_peaks(a_port, "bool_layer", 3, 2, **CPU)


@pytest.mark.parametrize("seeded", [False, True])
def test_label_connected_components_matches_jax(masked, seeded):
    """label_connected_components with and without seed labels: equal."""
    m, _ = masked
    seeds = np.zeros(m.shape, int)
    seeds[60:64, 10:14] = 1
    a_ref, a_port = _label_pair(masked, seeds=seeds)
    kw = dict(area_threshold=150, min_area=30, distance=4, max_area=200, seed_layer="seeds" if seeded else None)
    st.cs.label_connected_components(a_ref, "X", **kw)
    stt.cs.label_connected_components(a_port, "X", **kw, **CPU)
    out = a_port.layers["X_labels"]
    np.testing.assert_array_equal(out, np.asarray(a_ref.layers["X_labels"]))
    assert out.max() >= 5
    # every component small: nothing to erode
    a_ref, a_port = _label_pair(masked)
    st.cs.label_connected_components(a_ref, "X", area_threshold=10**6)
    stt.cs.label_connected_components(a_port, "X", area_threshold=10**6, **CPU)
    np.testing.assert_array_equal(a_port.layers["X_labels"], np.asarray(a_ref.layers["X_labels"]))


def test_peaks_with_erosion_and_fused_watershed_match_jax(masked):
    """find_peaks_with_erosion on the mask and on float scores (cells clear
    of the border, see test_safe_erode_float_matches_jax), and
    watershed_fused's labels and centroids: equal."""
    m, X = masked
    inner = np.zeros_like(m)
    inner[12:-12, 12:-12] = m[12:-12, 12:-12]
    scores = (inner * np.random.default_rng(2).uniform(0.5, 1, m.shape)).astype(np.float32)
    a_ref, a_port = _label_pair(masked, X_scores=scores)
    for pkg, a, kw in ((st, a_ref, {}), (stt, a_port, CPU)):
        pkg.cs.find_peaks_with_erosion(a, "X", min_area=20, out_layer="from_scores", **kw)
        del a.layers["X_scores"]
        pkg.cs.find_peaks_with_erosion(a, "X", min_area=20, out_layer="from_mask", **kw)
    for key in ("from_scores", "from_mask"):
        np.testing.assert_array_equal(a_port.layers[key], np.asarray(a_ref.layers[key]), err_msg=key)
    cj = st.cs.watershed_fused(a_ref, "X")
    ct = stt.cs.watershed_fused(a_port, "X", **CPU)
    np.testing.assert_array_equal(a_port.layers["X_labels"], np.asarray(a_ref.layers["X_labels"]))
    np.testing.assert_array_equal(ct, np.asarray(cj))
    with pytest.raises(stt.SegmentationError):
        stt.cs.find_peaks_with_erosion(a_port, "nope", **CPU)


def test_cell_area_filters_and_shape_match_jax(masked):
    m, X = masked
    labels = jlab._label_connected_components(m, area_threshold=10**6)
    a_ref, a_port = _agg(X, labels=labels)
    assert tut.cal_cell_area(labels) == jut.cal_cell_area(labels)
    st.cs.filter_cell_labels_by_area(a_ref, "labels", 30)
    stt.cs.filter_cell_labels_by_area(a_port, "labels", 30)
    st.cs.get_cell_shape(a_ref, "labels", thickness=2)
    stt.cs.get_cell_shape(a_port, "labels", thickness=2, **CPU)
    for key in ("labels", "labels_boundary"):
        np.testing.assert_array_equal(a_port.layers[key], np.asarray(a_ref.layers[key]), err_msg=key)


# -- benchmark and simulation ------------------------------------------------------------------


def test_simulate_and_compare_match_jax():
    """simulate_cells from a seed gives the JAX package's rasters; compare()
    (scikit-learn's formulas recomputed in numpy) gives its statistics to
    1e-12."""
    ref = st.cs.simulate_cells((64, 72), 12, seed=3)
    out = stt.cs.simulate_cells((64, 72), 12, seed=3)
    np.testing.assert_array_equal(out.X, ref.X)
    np.testing.assert_array_equal(out.layers["labels"], ref.layers["labels"])
    assert stt.SKM.get_adata_type(out) == "AGG" and out.uns["spatial"]["binsize"] == 1
    for a in (ref, out):
        a.layers["pred"] = np.where(a.layers["labels"] > 0, (a.layers["labels"] + 1) // 2, 0)
    dj = st.cs.compare(ref, "labels", "pred", seed=0)
    dt = stt.cs.compare(out, "labels", "pred", seed=0)
    assert list(dt.index) == list(dj.index) and list(dt.columns) == list(dj.columns)
    np.testing.assert_allclose(dt.to_numpy(float), dj.to_numpy(float), rtol=1e-12)


# -- the streamed batched EM, the whole chain, and imports -------------------------------------------


@pytest.mark.parametrize("em_batch", [2, 3])
def test_stream_batched_em_equals_per_tile_calls(em_batch):
    """`starro_em_bp_stream(em_batch=...)` yields exactly what per-tile calls
    yield, across a mid-stream shape change."""
    tiles = [_tile((64, 96), 0), _tile((64, 96), 1), _tile((72, 96), 2), _tile((64, 96), 3), _tile((64, 96), 4)]
    kw = dict(k=3, seed=0, em_max_iter=200, bp_max_iter=15, mask_only=True, **CPU)
    out = list(stt.cs.starro_em_bp_stream(tiles, em_batch=em_batch, **kw))
    assert len(out) == len(tiles)
    for X, (s, m) in zip(tiles, out):
        s_ref, m_ref = stt.cs.starro_em_bp(X, **kw)
        assert isinstance(m, np.ndarray) and m.shape == X.shape
        np.testing.assert_array_equal(m, m_ref)
        assert torch.equal(s, s_ref)


def write_gem(path):
    """`test_tutorial_flow.py`'s synthetic GEM tile (~35 planted cells on a
    120x120 raster, 24 genes, seed 7), written to `path`."""
    import gzip

    import pandas as pd

    rng = np.random.default_rng(7)
    H = W = 120
    genes = [f"g{i}" for i in range(24)]
    n_bg = 3500
    rows = [pd.DataFrame({"geneID": rng.choice(genes, n_bg), "x": rng.integers(0, H, n_bg),
                          "y": rng.integers(0, W, n_bg), "MIDCounts": np.ones(n_bg, int)})]
    for _ in range(35):
        cx, cy = rng.integers(12, H - 12), rng.integers(12, W - 12)
        n_rd = 260
        ang = rng.uniform(0, 2 * np.pi, n_rd)
        rad = rng.uniform(0, 5, n_rd)
        xs = np.clip((cx + rad * np.cos(ang)).astype(int), 0, H - 1)
        ys = np.clip((cy + rad * np.sin(ang)).astype(int), 0, W - 1)
        program = genes[:8] if cx < H // 2 else genes[8:16]
        rows.append(pd.DataFrame({"geneID": rng.choice(program, n_rd), "x": xs, "y": ys,
                                  "MIDCounts": rng.integers(1, 4, n_rd)}))
    with gzip.open(path, "wt") as f:
        pd.concat(rows, ignore_index=True).to_csv(f, sep="\t", index=False)
    return str(path)


def tutorial_chain(pkg, gem, device=None):
    """The Starro tutorial: GEM -> AGG raster -> density bins -> EM+BP with
    the bins -> peaks -> watershed -> connected components -> expansion ->
    cells x genes."""
    kw = {} if device is None else dict(device=device)
    agg = pkg.io.read_bgi_agg(gem)
    pkg.cs.segment_densities(agg, "X", 8, 3, 3, **kw)
    pkg.cs.score_and_mask_pixels(agg, "X", 5, "EM+BP", em_kwargs=dict(seed=0, downsample=0.2),
                                 bp_kwargs=dict(max_iter=20), **kw)
    pkg.cs.find_peaks_from_mask(agg, "X", 5, **kw)
    pkg.cs.watershed(agg, "X", **kw)
    pkg.cs.label_connected_components(agg, "X", area_threshold=200, min_area=20, out_layer="X_cc", **kw)
    pkg.cs.expand_labels(agg, "X", distance=2, max_area=200, **kw)
    cells = pkg.io.read_bgi(gem, segmentation_adata=agg, labels_layer="X_labels_expanded")
    return agg, cells


def test_tutorial_chain_matches_jax(tmp_path):
    """The whole chain in both packages on `test_tutorial_flow.py`'s GEM
    generator: the same bins, masks with IoU >= 0.99, each stage's labelled
    pixels with IoU >= 0.9, the same genes; >= 90% of the JAX package's cells
    matched by a port cell with label IoU >= 0.8, and >= 90% of the matched
    pairs within 10% of each other's total counts (the EM fits agree to
    1e-4, so a few threshold-straddling pixels move, and with them label
    numbers)."""
    gem = write_gem(tmp_path / "tile.gem.gz")
    agg_j, cells_j = tutorial_chain(st, gem)
    agg_t, cells_t = tutorial_chain(stt, gem, "cpu")
    np.testing.assert_array_equal(agg_t.layers["X_bins"], agg_j.layers["X_bins"])
    assert len(np.unique(agg_t.layers["X_bins"])) >= 2
    assert _iou(agg_t.layers["X_mask"], agg_j.layers["X_mask"]) >= 0.99
    for key in ("X_labels", "X_cc", "X_labels_expanded"):
        lt, lj = agg_t.layers[key], np.asarray(agg_j.layers[key])
        assert _iou(lt > 0, lj > 0) >= 0.9, key
    assert stt.SKM.get_adata_type(cells_t) == "UMI" and cells_t.n_obs >= 15
    assert list(cells_t.var_names) == list(cells_j.var_names)
    from spateo_tpu_torch.segmentation.benchmark import iou

    lj, lt = np.asarray(agg_j.layers["X_labels_expanded"]), agg_t.layers["X_labels_expanded"]
    m = iou(lj, lt).tolil()
    tot_t = dict(zip(cells_t.obs_names, np.asarray(cells_t.X.sum(axis=1)).ravel()))
    tot_j = dict(zip(cells_j.obs_names, np.asarray(cells_j.X.sum(axis=1)).ravel()))
    pairs = [(str(a), str(m.rows[a][int(np.argmax(m.data[a]))])) for a in range(1, m.shape[0])
             if m.rows[a] and max(m.data[a]) >= 0.8 and str(a) in tot_j]
    assert len(pairs) >= 0.9 * cells_j.n_obs
    close = [(a, b) for a, b in pairs if b in tot_t and abs(tot_t[b] - tot_j[a]) <= 0.1 * tot_j[a]]
    assert len(close) >= 0.9 * len(pairs)


def test_segmentation_and_io_import_no_jax_optax_sklearn_or_cv2():
    """Importing `stt.cs` and `stt.io` pulls in no JAX, optax, scikit-learn
    or OpenCV, and nothing of the JAX package."""
    code = (
        "import sys; import spateo_tpu_torch as stt; import spateo_tpu_torch.segmentation.density, "
        "spateo_tpu_torch.segmentation.vi, spateo_tpu_torch.segmentation.benchmark, "
        "spateo_tpu_torch.segmentation.simulation, spateo_tpu_torch.io.bgi; "
        "assert stt.cs.segment_densities and stt.io.read_bgi_agg and stt.cs.run_vi; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'sklearn', 'cv2', "
        "'spateo_tpu')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
