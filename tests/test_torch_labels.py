"""The port's label ops (`spateo_tpu_torch.ops.labels`) held against the JAX
package's on the CPU.

Every raster is made with numpy from a seed and handed to both packages.
Integer outputs (labels, markers, masks, counts) must be equal exactly; the
chamfer distances too, since both add the same float32 weights and take
minima, which is exact in any order.
"""

import numpy as np
import pytest
import torch

from spateo_tpu.ops import labels as jl
from spateo_tpu_torch.ops import labels as tl

H, W = 48, 64


def _disks(centres, radius):
    yy, xx = np.mgrid[:H, :W]
    m = np.zeros((H, W), bool)
    for cy, cx in centres:
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= radius**2
    return m


def _raster(name):
    rng = np.random.default_rng(0)
    if name == "disks":
        yy, xx = np.mgrid[:H, :W]
        m = np.zeros((H, W), bool)
        for _ in range(9):
            cy, cx, r = rng.uniform(5, H - 5), rng.uniform(5, W - 5), rng.uniform(2.5, 7)
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        return m
    if name == "touching_disks":
        return _disks([(20, 20), (20, 32), (34, 44)], 6.5)
    if name == "empty":
        return np.zeros((H, W), bool)
    return np.ones((H, W), bool)


RASTERS = ["disks", "touching_disks", "empty", "full"]


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", RASTERS)
def test_connected_components_matches_jax(name, connectivity):
    m = _raster(name)
    lj, nj = jl.connected_components(m, connectivity)
    lt, nt = tl.connected_components(m, connectivity, device="cpu")
    assert nt == nj
    np.testing.assert_array_equal(lt, lj)


@pytest.mark.parametrize("name", RASTERS)
def test_distance_transform_matches_jax(name):
    m = _raster(name)
    np.testing.assert_array_equal(tl.distance_transform(m, device="cpu"), jl.distance_transform(m))


@pytest.mark.parametrize("min_distance", [1, 3])
@pytest.mark.parametrize("name", RASTERS)
def test_peak_local_max_matches_jax(name, min_distance):
    """Without a mask against `peak_local_max`; with one against the JAX
    package's own composition (its `peak_local_max` cannot take a mask: it
    writes into a read-only view of a device array)."""
    m = _raster(name)
    d = jl.distance_transform(m)
    np.testing.assert_array_equal(tl.peak_local_max(d, min_distance, device="cpu"), jl.peak_local_max(d, min_distance))
    half = m & (np.arange(W)[None, :] < W // 2)
    peaks = np.array(jl._local_max_kernel(d, min_distance)) & half
    want, _ = jl.connected_components(peaks)
    np.testing.assert_array_equal(tl.peak_local_max(d, min_distance, mask=half, device="cpu"), want)


@pytest.mark.parametrize("n_levels", [16, 64])
@pytest.mark.parametrize("name", RASTERS)
def test_watershed_matches_jax(name, n_levels):
    """Random elevation (ties are rare) and the distance transform (many
    ties: the strict > and the N8 order decide)."""
    m = _raster(name)
    d = jl.distance_transform(m)
    markers = jl.peak_local_max(d, 3).astype(np.int32)
    rng = np.random.default_rng(1)
    for elev in (rng.uniform(0, 1, (H, W)).astype(np.float32), d):
        np.testing.assert_array_equal(
            tl.watershed(elev, markers, m, n_levels, device="cpu"), jl.watershed(elev, markers, m, n_levels)
        )


@pytest.mark.parametrize("max_labels", [None, 3])
@pytest.mark.parametrize("name", RASTERS)
def test_label_cells_from_mask_matches_jax(name, max_labels):
    """Labels equal, centroids equal (sums of integers); `max_labels=3`
    truncates the peak list as `jnp.nonzero(size=...)` does."""
    m = _raster(name)
    lj, cj = jl.label_cells_from_mask(m, 3, max_labels=max_labels)
    lt, ct = tl.label_cells_from_mask(m, 3, max_labels=max_labels, device="cpu")
    assert isinstance(lt, torch.Tensor) and lt.dtype == torch.int32
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("name", RASTERS)
def test_expand_labels_capped_matches_jax(name, with_mask):
    m = _raster(name)
    rng = np.random.default_rng(2)
    seeds = jl.connected_components(m)[0] * (rng.uniform(size=(H, W)) < 0.3)
    mask = m if with_mask else None
    np.testing.assert_array_equal(
        tl.expand_labels_capped(seeds, 4, 40, mask=mask, device="cpu"), jl.expand_labels_capped(seeds, 4, 40, mask=mask)
    )


@pytest.mark.parametrize("name", RASTERS)
def test_find_boundaries_and_label_overlap_match_jax(name):
    lab = jl.connected_components(_raster(name))[0]
    np.testing.assert_array_equal(tl.find_boundaries(lab, device="cpu"), jl.find_boundaries(lab))
    other = jl.connected_components(_disks([(24, 30)], 12))[0]
    assert (tl.label_overlap(lab, other) != jl.label_overlap(lab, other)).nnz == 0
