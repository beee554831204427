"""The port's CPU run behind `chip_smoke.py`'s phase 26 bars: the three
interpolation engines on 10,000 of the E9.5 cloud's cells with the planted
expression onto 20,000 grid targets (the GP on 10 genes at the JAX defaults,
the SIREN on all 50 at its own), and phase 26b's stages on its 20,000-cell x
4,000-gene `cortex_section` but SpaGCN, which runs on a 5,000-cell x
1,000-gene one (its [n, n] float64 matrices take ~10 GB at 20,000 cells). Prints each engine's mean error against the
planted field, each clustering's ARI against the bands, UMAP's 15-NN
preservation, the bands' smallest Moran's I and the CCI p-value.

    python3 scripts/interp_cluster_bars.py [--threads 4]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--threads", type=int, default=4)
    torch.set_num_threads(parser.parse_args().threads)
    t0 = time.perf_counter()
    cells = cs.e95_cloud()
    sub = cells[np.random.default_rng(0).choice(len(cells), 10_000, replace=False)]
    targets = cs.ellipsoid_grid(20_000)
    res = cs.interp_engines(stt, cs.interp_source(stt, sub), targets, device="cpu", profile=False)
    for name, r in res.items():
        print(f"interpolation {name}: 10,000 cells onto {len(targets):,} targets, mean error {r['err']!r}, "
              f"{r['seconds']!r} s (CPU)")
    for cells_genes, skip in (((cs.CLUSTER_CELLS, cs.CLUSTER_GENES), ("spagcn",)), ((5_000, 1_000), ())):
        sec = cs.cluster_section(stt, *cells_genes, device="cpu")
        st = cs.cluster_stages(stt, sec, device="cpu", profile=False, skip=skip)
        for name, v in st.items():
            print(f"{cells_genes} {name}: " + ", ".join(f"{k} {x!r}" for k, x in v.items() if x is not None))
    print(f"total {time.perf_counter() - t0!r} s")


if __name__ == "__main__":
    main()
