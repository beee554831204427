"""Sharded Starro (`segmentation.starro.starro_em_bp_sharded` and
`cs.score_and_mask_pixels(mesh=)`) held against the unsharded port and the
JAX package on the CPU.

The port's ranks are gloo groups of 4 and of 3 ranks on the CPU
(`_torch_ranks.run_groups`; 128 rows make blocks of 32 and of 43, 43, 42),
every rank returning the same bits. The raster is the JAX package's own
sharded test's (`tests/test_segmentation.py:268-282`: 128 x 96, k 3, seed
0, bp_max_iter 20).

Bars:

- Against the unsharded port with the settings the sharded path fixes (f32
  messages, the delta every iteration; the same uniforms from the same
  seed): scores within 1e-5, masks equal. With the 8-neighbourhood (the
  generic iteration) too.
- Against `spateo_tpu`'s `starro_em_bp` (its own slow test holds the sharded
  program equal to it): mask IoU >= 0.98, the bar the port's public Starro
  path has (`tests/test_torch_starro.py`), since the two packages draw the
  downsample from different generators.
- `score_and_mask_pixels(mesh=)`: the same layers as the unsharded call
  (scores within 1e-5, masks equal), and IoU >= 0.98 against the JAX
  package's call on the JAX test's second raster.
"""

import numpy as np
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from _torch_ranks import run_groups, same_bits
from spateo_tpu.segmentation import starro as js
from spateo_tpu_torch.segmentation import starro as ts

WORLDS = (4, 3)
KW = dict(k=3, seed=0, bp_max_iter=20)
PUBLIC_KW = dict(k=3, method="EM+BP", em_kwargs=dict(seed=0), bp_kwargs=dict(max_iter=20))
IOU_BAR = 0.98


def _raster(seed=0, block=(40, 70, 30, 60)):
    rng = np.random.default_rng(seed)
    X = rng.negative_binomial(1, 0.5, (128, 96)).astype(np.float32)
    y0, y1, x0, x1 = block
    X[y0:y1, x0:x1] += rng.negative_binomial(8, 0.35, (y1 - y0, x1 - x0)).astype(np.float32)
    return X


def _public_raster():
    """The JAX package's public mesh test raster (`tests/test_segmentation.py:292`)."""
    return _raster(3, (30, 80, 20, 70))


def _iou(a, b):
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = [
        ("starro", dict(X=_raster(), kw=KW)),
        ("starro", dict(X=_raster(), kw=dict(KW, bp_square=True))),
        ("starro_public", dict(X=_public_raster(), kw=PUBLIC_KW)),
    ]
    out = run_groups({w: jobs for w in WORLDS}, tmp_path_factory.mktemp("starro"))
    names = ("starro", "square", "public")
    return {w: {n: [r[i] for r in per_rank] for i, n in enumerate(names)} for w, per_rank in out.items()}


def _unsharded(X, square=False):
    """The unsharded port with the sharded path's settings: f32 messages,
    the delta every iteration (the fused 4-neighbour loop's plain version,
    or the generic loop for the 8-neighbourhood)."""
    ((s, m),) = ts._starro_em_bp_fused(
        [torch.from_numpy(X)], 3, 5, ts._n_samples(X.size, 0.001), 2000, 1e-6, ts._offsets(3, square), 0.6, 0.4,
        1e-6, 20, use_cuda_bp=not square, bp_msg_dtype="float32", seed=0, bp_check_every=1,
    )
    return s.numpy(), m.numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("job", ["starro", "square", "public"])
def test_every_rank_returns_the_same_bits(ranks, world, job):
    assert same_bits(ranks[world][job])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("square", [False, True])
def test_sharded_matches_unsharded_port(ranks, world, square):
    s, m = ranks[world]["square" if square else "starro"][0]
    s0, m0 = _unsharded(_raster(), square)
    assert s.shape == m.shape == (128, 96) and s.dtype == np.float32 and m.dtype == bool
    np.testing.assert_allclose(s, s0, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(m, m0)
    assert 0.01 < m.mean() < 0.5


@pytest.fixture(scope="module")
def jax_starro():
    s, m = js.starro_em_bp(_raster(), **KW)
    return np.asarray(s), np.asarray(m)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax(ranks, jax_starro, world):
    s, m = ranks[world]["starro"][0]
    assert _iou(m, jax_starro[1]) >= IOU_BAR
    assert np.isfinite(s).all() and s.min() >= 0.0 and s.max() <= 1.0


@pytest.mark.parametrize("world", WORLDS)
def test_score_and_mask_pixels_mesh(ranks, world):
    """The public driver with `mesh=` writes the layers the unsharded call
    writes, and agrees with the JAX package's call."""
    scores, mask = ranks[world]["public"][0]
    a = stt.AnnData(X=_public_raster())
    stt.SKM.init_adata_type(a, stt.SKM.ADATA_AGG_TYPE)
    stt.cs.score_and_mask_pixels(a, "X", device="cpu", **PUBLIC_KW)
    assert scores.dtype == a.layers["X_scores"].dtype and mask.dtype == a.layers["X_mask"].dtype == bool
    np.testing.assert_allclose(scores, a.layers["X_scores"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(mask, a.layers["X_mask"])
    aj = st.AnnData(X=_public_raster())
    st.SKM.init_adata_type(aj, "AGG")
    st.cs.score_and_mask_pixels(aj, "X", **PUBLIC_KW)
    assert _iou(mask, np.asarray(aj.layers["X_mask"])) >= IOU_BAR


def test_score_and_mask_pixels_refuses_a_foreign_mesh():
    """A mesh that is not a `DeviceMesh` raises, for every method (the
    staged path ignores a real mesh, as in the JAX package)."""
    a = stt.AnnData(X=_raster()[:32])
    stt.SKM.init_adata_type(a, stt.SKM.ADATA_AGG_TYPE)
    for method in ("EM+BP", "EM"):
        with pytest.raises(TypeError, match="DeviceMesh"):
            stt.cs.score_and_mask_pixels(a, "X", k=3, method=method, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ts.starro_em_bp_sharded(_raster(), mesh=object())
