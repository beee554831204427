"""The CPU runs behind `chip_smoke.py`'s phase 32 bars: scikit-learn's
Barnes-Hut `TSNE` (what the JAX package calls) at its defaults on phase 32a's
20,000-cell `cluster_section` (15-NN preservation, the bands' k-means ARI),
the port's t-SNE beside scikit-learn's on 5,000 of its cells, and
`points_inside_mesh` on 2,000 of phase 32b's probe points against phase 22's
Poisson surface built on the CPU (the share that agrees with the planted
ellipsoid). Needs scikit-learn.

    python3 scripts/tsne_widgets_bars.py [--threads 4]
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
from spateo_tpu_torch.tools._tsne import TSNE as PortTSNE  # noqa: E402


def answer(X30, emb, bands):
    from sklearn.cluster import KMeans

    from spateo_tpu_torch.tools.dimensionality_reduction import knn_preservation

    labels = KMeans(cs.SVG_BANDS, n_init=10, random_state=0).fit_predict(emb)
    return knn_preservation(X30, emb, 15, device="cpu"), cs.ari(labels, bands)


def main():
    from sklearn.manifold import TSNE

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--threads", type=int, default=4)
    threads = parser.parse_args().threads
    torch.set_num_threads(threads)
    t_all = time.perf_counter()
    ad = cs.cluster_section(stt, device="cpu")
    X30, bands = np.asarray(ad.obsm["X_pca"])[:, :30], np.asarray(ad.obs["band"])
    t0 = time.perf_counter()
    ref = TSNE(n_components=2, random_state=0, n_jobs=threads).fit(X30)
    pres, a = answer(X30, ref.embedding_, bands)
    print(f"scikit-learn TSNE, {len(X30):,} cells: 15-NN preservation {pres!r}, ARI {a!r}, KL {ref.kl_divergence_!r}, "
          f"{ref.n_iter_ + 1} iterations, {time.perf_counter() - t0!r} s (CPU, {threads} threads)")
    sub = np.random.default_rng(0).choice(len(X30), 5_000, replace=False)
    for name, fit in (("scikit-learn", lambda X: TSNE(random_state=0, n_jobs=threads).fit_transform(X)),
                      ("the port", lambda X: PortTSNE(device="cpu").fit_transform(X))):
        t0 = time.perf_counter()
        emb = fit(X30[sub])
        pres, a = answer(X30[sub], emb, bands[sub])
        print(f"{name} t-SNE, 5,000 cells: 15-NN preservation {pres!r}, ARI {a!r}, {time.perf_counter() - t0!r} s")
    from spateo_tpu_torch.tdr.widgets import ops as wo

    t0 = time.perf_counter()
    surface = cs.poisson_surface(stt, device="cpu")
    pts, truth = cs.inside_probe()
    pick = np.random.default_rng(1).choice(len(pts), 2_000, replace=False)
    inside = wo.points_inside_mesh(pts[pick], surface, device="cpu")
    print(f"points_inside_mesh, 2,000 of the probe's {len(pts):,} points against a {surface.n_faces:,}-face Poisson "
          f"surface: agrees with the ellipsoid on {float((inside == truth[pick]).mean())!r} "
          f"({time.perf_counter() - t0!r} s with the surface)")
    print(f"total {time.perf_counter() - t_all!r} s")


if __name__ == "__main__":
    main()
