"""The atlas chain through the port on the CPU: `chip_smoke.atlas_chain`
(Starro stream -> labeling -> `morpho_align` chain -> `SparseVFC_batch` with
div/curl -> `jacobi_solve` and layer bins) at `tests/test_atlas_e2e.py`'s tiny
shape, held to that test's bars. On the card the same function is phase 13
of `chip_smoke.py`."""

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


@pytest.fixture(scope="module")
def atlas_result():
    import chip_smoke

    return chip_smoke.atlas_chain(n_slices=2, tile=256, spacing=10, n_genes=12, align_max_iter=60, svi_batch=400,
                                  vfc_M=24, vfc_iters=15, pde_max_itr=1500, n_layers=5, seed=0, device="cpu")


def test_segmentation_recovers_most_cells(atlas_result):
    # planted lattice: ((256 - 24) // 10 + 1)^2 = 576 cells per slice
    for n in atlas_result["cells_found_per_slice"]:
        assert n >= 0.6 * 576, atlas_result["cells_found_per_slice"]
    assert 0.05 < atlas_result["checks"]["mask_frac"] < 0.7


def test_alignment_chain_accuracy(atlas_result):
    assert atlas_result["checks"]["align_last_slice_med_err_px"] < 5.0


def test_morphofield_and_digitization(atlas_result):
    assert atlas_result["checks"]["div_finite"]
    assert atlas_result["vfc_iterations"] == [15]
    assert atlas_result["checks"]["digital_layer_bins"] >= 3
    assert atlas_result["pde_iters"] > 0


def test_stage_accounting(atlas_result):
    import chip_smoke

    r = atlas_result
    assert tuple(r["stage_seconds"]) == chip_smoke.ATLAS_STAGES
    assert all(v >= 0 for v in r["stage_seconds"].values())
    assert abs(sum(r["stage_seconds"].values()) - r["wall_seconds"]) < 1e-9
    assert r["total_cell_slices"] == r["cells_per_slice"] * r["n_slices"]
    assert r["cells_slices_per_min"] > 0 and r["stage_busy_seconds"] == {}
    assert np.isfinite(r["checks"]["align_last_slice_med_err_px"])
