"""The plain references agree with the program run on the CPU at a tiny
size: a 256 x 256 Starro stream and a 500-cell Morpho pair. This is the
references' own check; on the card the harness compares them with what the
timed path produced."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import load_by_path

HERE = Path(__file__).resolve().parent
rasters = load_by_path("traffic/rasters.py")
slice_pairs = load_by_path("traffic/slice_pairs.py")


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_starro_reference_agrees_with_the_stream_on_the_cpu():
    from spateo_tpu_torch.segmentation.starro import starro_em_bp_stream

    ref = load_by_path("reference/starro-bin1.py")
    settings = dict(config("starro-bin1")["settings"], em_batch=3)
    tiles = list(rasters.make_pool(3, 256, 2**31 + 3, "cpu"))
    out = list(starro_em_bp_stream(tiles, device="cpu", **settings))
    for raster, (scores, mask) in zip(tiles, out):
        # the CPU stream runs BP's generic loop with float32 messages
        r_mask, r_scores = ref.mask_and_scores(raster, settings, "cpu", "float32")
        assert ref.mismatch_share(mask, r_mask) <= 1e-4
        assert ref.score_gap(scores.numpy(), r_scores) <= 1e-5
        assert 0.02 < r_mask.mean() < 0.3


def test_starro_reference_rejects_other_neighbourhoods():
    ref = load_by_path("reference/starro-bin1.py")
    with pytest.raises(ValueError):
        ref.mask_and_scores(np.ones((32, 32), np.float32), dict(config("starro-bin1")["settings"], bp_k=5), "cpu")


def test_morpho_reference_agrees_with_morpho_align_on_the_cpu():
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.alignment.morpho_alignment import morpho_align

    ref = load_by_path("reference/morpho-pair.py")
    cfg = config("morpho-pair")
    s = cfg["settings"]
    params = json.loads((HERE / "workloads" / "morpho-pair.20k.json").read_text())["params"]
    p = slice_pairs.make_pair(dict(params, cells=500), 2**31 + 1, 0)
    out, _ = morpho_align([slice_pairs.adata(stt, p["fixed"], p["fixed_pcs"], s["rep_layer"]),
                           slice_pairs.adata(stt, p["moving"], p["moving_pcs"], s["rep_layer"])], device="cpu", **s)
    want = ref.align((p["fixed"], p["fixed_pcs"]), (p["moving"], p["moving_pcs"]), s, "cpu")
    got = out[1]
    extent = float(np.ptp(p["fixed"], axis=0).max())
    # within the limits a run holds the program to on the card
    assert np.abs(got.obsm["align_spatial"] - want["aligned"]).max() / extent <= ref.LIMITS["rigid_coord_gap"]
    assert np.abs(got.obsm["align_spatial_nonrigid"] - want["nonrigid"]).max() / extent <= ref.LIMITS["nonrigid_coord_gap"]
    assert np.abs(got.uns["VecFld_morpho"]["optimal_R"] - want["R"]).max() <= ref.LIMITS["rotation_gap"]
    # and both take the moving cells back near their places before the planted move
    for k, v in cfg["planted_limits"].items():
        miss = want["nonrigid" if "nonrigid" in k else "rigid"] - p["truth"]
        assert np.sqrt(np.mean(miss**2)) / extent <= v


def test_morpho_reference_refuses_other_representations():
    ref = load_by_path("reference/morpho-pair.py")
    pts = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError):
        ref.align((pts, pts), (pts, pts), dict(config("morpho-pair")["settings"], dissimilarity="kl"), "cpu")
