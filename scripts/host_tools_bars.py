"""The port's CPU run behind `chip_smoke.py`'s phase 30 bars: phase 30's
stages (`host_tools_stages`) on a 5,000-cell x 1,000-gene `cortex_section`
after normalize_total + log1p, the cluster DEGs on 600 genes, and
`binary_morani_result` on a 512² `bench.make_raster`. Prints each stage's
seconds (CPU) and answer: the randomized PCA's top-6 explained variances
against the full SVD's, the samples' coverage, each band's planted genes in
its top 10, the GLM's planted recall, LISA's hot spots, the spatial-lag
model's own-band share, the bivariate pairs' share at p 0.05, the Moran
masks' IoU with the planted disks.

    python3 scripts/host_tools_bars.py [--threads 4]
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--threads", type=int, default=4)
    torch.set_num_threads(parser.parse_args().threads)
    t0 = time.perf_counter()
    ad = cs.host_tools_section(stt, 5_000, 1_000)
    st = cs.host_tools_stages(stt, ad, device="cpu", profile=False, raster=512, deg_genes=600)
    for name, v in st.items():
        print(f"{name}: " + ", ".join(f"{k} {x!r}" for k, x in v.items() if x is not None))
    print(f"total {time.perf_counter() - t0!r} s")


if __name__ == "__main__":
    main()
