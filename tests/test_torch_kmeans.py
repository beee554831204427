"""The port's k-means (`spateo_tpu_torch.ops.kmeans`) against scikit-learn's,
on the CPU, and `sampling.kmeans_sample` against the JAX package's.

scikit-learn is imported here only: the port's `KMeans` and
`MiniBatchKMeans` replace it on paths the GPU machine runs. Bars: labels
equal and centres to 1e-12 (measured: 0.0 on every case below, the centre
sums run in sample order as scikit-learn's do).

One divergence is pinned rather than hidden: a mini-batch reassignment
draws its new centres from a batch sampled with replacement, so two centres
can land on one point. scikit-learn's BLAS then rounds the two equal columns
of its distance GEMM differently and picks whichever it rounded lower; the
port takes the first (`test_twin_centres_take_the_first`).
"""

import warnings

import numpy as np
import pytest
import torch

from spateo_tpu_torch.ops import kmeans as tk

sklearn_cluster = pytest.importorskip("sklearn.cluster")

CENTER_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and for scikit-learn's OpenMP and
    BLAS pools: the tier-1 run shares the CPU among its workers, where
    those pools only contend."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _points(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).uniform(0, 100, (n, 2)).astype(dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k, n_init", [(30, 10), (8, 3)])
def test_kmeans_matches_sklearn(seed, k, n_init):
    X = _points(600, seed)
    ref = sklearn_cluster.KMeans(n_clusters=k, random_state=seed, n_init=n_init).fit(X)
    got = tk.KMeans(n_clusters=k, random_state=seed, n_init=n_init, device="cpu").fit(X)
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, rtol=0, atol=CENTER_TOL)
    assert got.n_iter_ == ref.n_iter_
    assert got.inertia_ == pytest.approx(ref.inertia_, rel=1e-12)
    np.testing.assert_array_equal(got.predict(X), ref.predict(X))


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_float32_and_empty_clusters_match_sklearn(seed):
    """float32 input stays float32, as scikit-learn keeps it; duplicated
    points leave clusters empty, which take the farthest points."""
    X = _points(4000, seed, np.float32)
    ref = sklearn_cluster.KMeans(n_clusters=40, random_state=seed, n_init=4).fit(X)
    got = tk.KMeans(n_clusters=40, random_state=seed, n_init=4, device="cpu").fit(X)
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, rtol=0, atol=1e-4)
    Xd = np.repeat(np.random.default_rng(seed).uniform(0, 10, (30, 2)), 5, axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sklearn_cluster.KMeans(n_clusters=35, random_state=seed, n_init=3).fit(Xd)
    got = tk.KMeans(n_clusters=35, random_state=seed, n_init=3, device="cpu").fit(Xd)
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, rtol=0, atol=CENTER_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [50, 400])
def test_minibatch_kmeans_matches_sklearn(seed, k):
    """The validation and init draws, the count-weighted centre updates, the
    random reassignments and the EWA-inertia stop: the same steps, labels
    and centres."""
    X = _points(3000, seed + 10)
    ref = sklearn_cluster.MiniBatchKMeans(n_clusters=k, random_state=seed, n_init=3).fit(X)
    got = tk.MiniBatchKMeans(n_clusters=k, random_state=seed, n_init=3, device="cpu").fit(X)
    assert got.n_steps_ == ref.n_steps_
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, rtol=0, atol=CENTER_TOL)
    assert got.host_reads <= got.n_steps_ * 2


def test_minibatch_reassignment_past_half_the_batch_matches_sklearn():
    """900 centres against 1,024-point batches: most counts are 0 after the
    first step, so more than half a batch is due for reassignment and
    scikit-learn keeps the rest by an argsort of the counts."""
    X = _points(4000, 1)
    ref = sklearn_cluster.MiniBatchKMeans(n_clusters=900, random_state=1, n_init=3).fit(X)
    got = tk.MiniBatchKMeans(n_clusters=900, random_state=1, n_init=3, device="cpu").fit(X)
    assert got.n_steps_ == ref.n_steps_
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, rtol=0, atol=CENTER_TOL)


def test_twin_centres_take_the_first():
    """Two equal centres: every point nearest to them goes to the first."""
    C = torch.tensor([[0.0, 0.0], [5.0, 5.0], [5.0, 5.0]], dtype=torch.float64)
    X = torch.tensor([[4.0, 4.5], [6.0, 5.0], [0.1, 0.0]], dtype=torch.float64)
    labels, inertia = tk._assign(X, C, torch.ones(3, dtype=torch.float64))
    assert labels.tolist() == [1, 1, 0]
    assert float(inertia) == pytest.approx(1.25 + 1.0 + 0.01)


def test_kmeans_sample_matches_jax():
    """`sample_indices(method="kmeans")` picks the same cells as the JAX
    package's (scikit-learn's MiniBatchKMeans there)."""
    from spateo_tpu.alignment.methods import sampling as js
    from spateo_tpu_torch.alignment.methods import sampling as ts

    for seed in range(3):
        X = _points(2500, seed + 20)
        np.testing.assert_array_equal(ts.sample_indices(X, 200, "kmeans", seed, device="cpu"),
                                      js.sample_indices(X, 200, "kmeans", seed))


def test_too_few_samples_raise():
    for cls in (tk.KMeans, tk.MiniBatchKMeans):
        with pytest.raises(ValueError, match="n_clusters"):
            cls(n_clusters=10, device="cpu").fit(np.zeros((5, 2)))
