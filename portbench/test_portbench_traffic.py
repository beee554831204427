"""The traffic generators repeat from a seed, and the section cell's tiles
and chunks are those its workload file describes."""

import json
from pathlib import Path

import numpy as np

from portbench import load_by_path

HERE = Path(__file__).resolve().parent
rasters = load_by_path("traffic/rasters.py")
slice_pairs = load_by_path("traffic/slice_pairs.py")


def test_rasters_repeat_exactly_from_a_seed_and_differ_between_seeds():
    a = rasters.make_pool(3, 96, 2**31 + 5, "cpu")
    b = rasters.make_pool(3, 96, 2**31 + 5, "cpu")
    c = rasters.make_pool(3, 96, 2**31 + 6, "cpu")
    assert a.shape == (3, 96, 96) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.all(a >= 0) and np.array_equal(a, np.round(a))


def test_rasters_follow_their_distributions():
    pool = rasters.make_pool(4, 512, 11, "cpu")
    # background NB(1, 0.5) has mean 1; cells add NB(8, 0.35) (mean 14.86)
    # over ~pi r^2 px, radius 4..9, one per 2,500 px2
    cover = np.mean([np.pi * r * r for r in range(4, 10)]) / 2500
    assert abs(pool.mean() - (1 + cover * 8 * 0.65 / 0.35)) < 0.08
    assert abs(np.median(pool) - 1) <= 1


def test_slice_pairs_repeat_exactly_and_plant_the_transform():
    params = json.loads((HERE / "workloads" / "morpho-pair.20k.json").read_text())["params"]
    params = dict(params, cells=500)
    a = slice_pairs.make_pair(params, 2**31 + 9, 1)
    b = slice_pairs.make_pair(params, 2**31 + 9, 1)
    c = slice_pairs.make_pair(params, 2**31 + 9, 2)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["fixed"], c["fixed"])
    th = params["rotation"]
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    assert np.allclose(a["moving"], a["truth"] @ R.T + params["shift"], atol=1e-5)
    assert a["fixed_pcs"].shape == a["moving_pcs"].shape == (500, params["pcs"])


def test_slice_pairs_draw_each_section_on_its_own_from_one_pattern():
    params = json.loads((HERE / "workloads" / "morpho-pair.20k.json").read_text())["params"]
    p = slice_pairs.make_pair(dict(params, cells=2000), 7, 0)
    # the moving section's cells are not the fixed one's
    d = ((p["truth"][:, None, :] - p["fixed"][None, :, :]) ** 2).sum(-1).min(1)
    assert np.median(d) > 1e-4
    # the PCs carry the spatial pattern: neighbours are more alike than strangers
    X = p["fixed_pcs"] / np.linalg.norm(p["fixed_pcs"], axis=1, keepdims=True)
    near = np.argsort(((p["fixed"][:200, None] - p["fixed"][None]) ** 2).sum(-1), axis=1)[:, 1]
    assert (X[:200] * X[near]).sum(1).mean() > (X[:200] * X[200:400]).sum(1).mean() + 0.05


def test_the_section_cells_tiles_and_chunk_breaks():
    wl = json.loads((HERE / "workloads" / "starro-bin1.section.json").read_text())
    cfg = json.loads((HERE / "configs" / "starro-bin1.json").read_text())
    shapes = rasters.tile_shapes(wl["params"]["tile"], wl["params"]["section"])
    assert len(shapes) == 100
    for row in range(9):
        assert shapes[10 * row : 10 * row + 10] == [(2048, 2048)] * 9 + [(2048, 1568)]
    assert shapes[90:] == [(1568, 2048)] * 9 + [(1568, 1568)]
    assert rasters.chunks(shapes * 2, cfg["settings"]["em_batch"]) == [9, 1] * 20


def test_the_interior_cells_chunks():
    wl = json.loads((HERE / "workloads" / "starro-bin1.interior.json").read_text())
    shapes = rasters.tile_shapes(wl["params"]["tile"], wl["params"]["section"]) * 64
    assert rasters.chunks(shapes, 16) == [16] * 4
    assert wl["params"]["pool"] % 16 == 1  # each chunk of 16 leaves out one raster
