"""Demo datasets (capability parity: reference spateo/sample_data.py:13-369).

Each accessor downloads a published AnnData to a local cache and reads it;
the dataset -> URL tables are the reference's published mirrors (dropbox
primary, figshare fallback — data pointers, not code). In an air-gapped
environment `synthetic()` generates a structured in-memory dataset so demos
and docs still run. A copy of `spateo_tpu.sample_data`, with the same URLs.
"""

from __future__ import annotations

import ntpath
import os
from pathlib import Path
from typing import Optional
from urllib.request import urlretrieve

import numpy as np

from .core.anndata import AnnData, read_h5ad
from .logging import logger_manager as lm


def download_data(url: str, file_path: Optional[str] = None, dir_name: str = "./data") -> str:
    """Download `url` into `dir_name` unless already cached
    (parity: reference sample_data.py:13)."""
    file_path = ntpath.basename(url.split("?")[0]) if file_path is None else file_path
    file_path = os.path.join(dir_name, file_path)
    lm.main_info("Downloading data to " + file_path)
    if not os.path.exists(file_path):
        Path(dir_name).mkdir(parents=True, exist_ok=True)
        urlretrieve(url, file_path)
    return file_path


def get_adata(url: str, filename: Optional[str] = None, dir_name: str = "./data") -> AnnData:
    """Download + read an example AnnData (parity: reference
    sample_data.py:40)."""
    file_path = download_data(url=url, file_path=filename, dir_name=dir_name)
    if not file_path.endswith(".h5ad"):
        raise ValueError(f"only .h5ad sample files are supported, got {file_path}")
    adata = read_h5ad(file_path)
    return adata


def _fetch(urls: dict, backup_urls: dict, filename: str, dir_name: str = "./data") -> AnnData:
    if filename not in urls:
        raise KeyError(f"unknown sample file `{filename}`; available: {sorted(urls)}")
    try:
        return get_adata(urls[filename], filename, dir_name)
    except Exception as exc:  # mirror fallback
        lm.main_warning(f"primary mirror failed ({exc}); trying backup")
        return get_adata(backup_urls[filename], filename, dir_name)


def drosophila(filename: str = "E7-9h_cellbin_tdr_v1.h5ad", backup_url: Optional[str] = None, **kwargs) -> AnnData:
    """Drosophila embryo Stereo-seq (parity: reference sample_data.py:64)."""
    urls = {
        "E7-9h_cellbin_tdr_v1.h5ad": "https://www.dropbox.com/s/ow8xkge0538309a/E7-9h_cellbin_tdr_v1.h5ad?dl=1",
        "E7-9h_cellbin_tdr_v2.h5ad": "https://www.dropbox.com/s/bvstb3en5kc6wui/E7-9h_cellbin_tdr_v2.h5ad?dl=1",
        "E7-9h_cellbin_tdr_v2_midgut.h5ad": "https://www.dropbox.com/s/q020zgxxemxl7j4/E7-9h_cellbin_tdr_v2_midgut.h5ad?dl=1",
        "E7-9h_cellbin_tdr_v3_midgut.h5ad": "https://www.dropbox.com/s/cz2nqpmoc3oo5f3/E7-9h_cellbin_tdr_v3_midgut.h5ad?dl=1",
        "E9-10h_cellbin_tdr_v1.h5ad": "https://www.dropbox.com/s/q2l8mqpn7qvz2xr/E9-10h_cellbin_tdr_v1.h5ad?dl=1",
        "E9-10h_cellbin_tdr_v2.h5ad": "https://www.dropbox.com/s/q02sx6acvcqaf35/E9-10h_cellbin_tdr_v2.h5ad?dl=1",
        "E9-10h_cellbin_tdr_v2_midgut.h5ad": "https://www.dropbox.com/s/we2fkpd1p3ww33f/E9-10h_cellbin_tdr_v2_midgut.h5ad?dl=1",
        "E9-10h_cellbin_tdr_v2_CNS.h5ad": "https://www.dropbox.com/s/a7bllwm760dmda6/E9-10h_cellbin_tdr_v2_CNS.h5ad?dl=1",
    }
    backups = {
        "E7-9h_cellbin_tdr_v1.h5ad": "https://figshare.com/s/296ada88086141393702",
        "E7-9h_cellbin_tdr_v2.h5ad": "https://figshare.com/s/8f9623f1fe99e47ed1bf",
        "E7-9h_cellbin_tdr_v2_midgut.h5ad": "https://figshare.com/s/32ab3b9672e8a49426bc",
        "E7-9h_cellbin_tdr_v3_midgut.h5ad": "https://figshare.com/s/fb2097c552c3ff802a74",
        "E9-10h_cellbin_tdr_v1.h5ad": "https://figshare.com/s/ee83e00ff016bb825e01",
        "E9-10h_cellbin_tdr_v2.h5ad": "https://figshare.com/s/174f15b4aa349269f90f",
        "E9-10h_cellbin_tdr_v2_CNS.h5ad": "https://figshare.com/s/ea71722ad3c15199ebce",
    }
    if backup_url:
        backups = {filename: backup_url}
    return _fetch(urls, backups, filename, **kwargs)


def mousebrain(filename: str = "mousebrain_bin60.h5ad", **kwargs) -> AnnData:
    """Mouse brain Stereo-seq (parity: reference sample_data.py:133)."""
    urls = {
        "mousebrain_bin30.h5ad": "https://www.dropbox.com/s/tyvhndoyj8se5xt/mousebrain_bin30.h5ad?dl=1",
        "mousebrain_bin50_raw.h5ad": "https://www.dropbox.com/s/vtapwsccpi885l2/mousebrain_bin50_raw.h5ad?dl=1",
        "mousebrain_bin60.h5ad": "https://www.dropbox.com/s/c5tu4drxda01m0u/mousebrain_bin60.h5ad?dl=1",
        "mousebrain_bin60_clustered.h5ad": "https://www.dropbox.com/s/wxgkim87uhpaz1c/mousebrain_bin60_clustered.h5ad?dl=1",
        "mousebrain_cellbin_clustered.h5ad": "https://www.dropbox.com/s/seusnva0dgg5de5/mousebrain_cellbin_clustered.h5ad?dl=1",
    }
    backups = {
        "mousebrain_bin30.h5ad": "https://figshare.com/s/06031809ad3d07f4ae47",
        "mousebrain_bin50_raw.h5ad": "https://figshare.com/s/5b990697c6710281bb94",
        "mousebrain_bin60.h5ad": "https://figshare.com/s/cdf561c40ff2445ae157",
        "mousebrain_bin60_clustered.h5ad": "https://figshare.com/s/b7eb6849985edba965a8",
        "mousebrain_cellbin_clustered.h5ad": "https://figshare.com/s/254ad2f3e6ed9d23d6f9",
    }
    return _fetch(urls, backups, filename, **kwargs)


def axolotl(filename: str = "axolotl_2DPI.h5ad", **kwargs) -> AnnData:
    """Axolotl brain regeneration Stereo-seq (parity: sample_data.py:175)."""
    urls = {
        "axolotl_2DPI.h5ad": "https://www.dropbox.com/s/7w2jxf41xazrqxo/axolotl_2DPI.h5ad?dl=1",
        "axolotl_2DPI_right.h5ad": "https://www.dropbox.com/s/pm5vvqcd4leahsb/axolotl_2DPI_right.h5ad?dl=1",
    }
    backups = {
        "axolotl_2DPI.h5ad": "https://figshare.com/s/216e022ff17d841dfc1f",
        "axolotl_2DPI_right.h5ad": "https://figshare.com/s/4995e72dc86b2349c54e",
    }
    return _fetch(urls, backups, filename, **kwargs)


def slideseq(filename: str = "slideseq_mouse_hippocampus.h5ad", **kwargs) -> AnnData:
    """Slide-seq mouse hippocampus (parity: sample_data.py:208)."""
    urls = {"slideseq_mouse_hippocampus.h5ad": "https://www.dropbox.com/s/d3tpusisbyzn6jk/slideseq.h5ad?dl=1"}
    backups = {"slideseq_mouse_hippocampus.h5ad": "https://figshare.com/s/6d69d6f9e90cbcbcdcbf"}
    return _fetch(urls, backups, filename, **kwargs)


def seqfish(filename: str = "seqfish_mouse_embryo.h5ad", **kwargs) -> AnnData:
    """seqFISH mouse embryo (parity: sample_data.py:240)."""
    urls = {"seqfish_mouse_embryo.h5ad": "https://www.dropbox.com/s/d8rdfhf89iyaqoq/seqFISH.h5ad?dl=1"}
    backups = {"seqfish_mouse_embryo.h5ad": "https://figshare.com/s/5d07f06e967e1d522b07"}
    return _fetch(urls, backups, filename, **kwargs)


def merfish(filename: str = "merfish_mouse_hypothalamus.h5ad", **kwargs) -> AnnData:
    """MERFISH mouse hypothalamus (parity: sample_data.py:273)."""
    urls = {"merfish_mouse_hypothalamus.h5ad": "https://www.dropbox.com/s/e1rnkwy2mzj3u93/merfish.h5ad?dl=1"}
    backups = {"merfish_mouse_hypothalamus.h5ad": "https://figshare.com/s/f9a867e1ae16b1ab9715"}
    return _fetch(urls, backups, filename, **kwargs)


def seqscope(filename: str = "seqscope_mouse_liver.h5ad", **kwargs) -> AnnData:
    """Seq-Scope mouse liver (parity: sample_data.py:306)."""
    urls = {"seqscope_mouse_liver.h5ad": "https://www.dropbox.com/s/hci9up2nsrbtezz/seqscope.h5ad?dl=1"}
    backups = {"seqscope_mouse_liver.h5ad": "https://figshare.com/s/aba72a9ec13b2e14d633"}
    return _fetch(urls, backups, filename, **kwargs)


def starmap(filename: str = "starmap_mouse_brain.h5ad", **kwargs) -> AnnData:
    """STARmap mouse brain (parity: sample_data.py:340)."""
    urls = {"starmap_mouse_brain.h5ad": "https://www.dropbox.com/s/nrk3till29c6gqn/starmap.h5ad?dl=1"}
    backups = {"starmap_mouse_brain.h5ad": "https://figshare.com/s/269c127b0e3e77b4f56a"}
    return _fetch(urls, backups, filename, **kwargs)


def synthetic(
    n_cells: int = 2000,
    n_genes: int = 50,
    n_domains: int = 3,
    seed: int = 0,
) -> AnnData:
    """Structured synthetic spatial dataset for offline demos/tests:
    `n_domains` spatial domains with domain-specific marker genes, counts ~
    NB, coordinates in .obsm['spatial']."""
    import pandas as pd

    from .configuration import SKM

    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 100, (n_cells, 2)).astype(np.float32)
    centers = rng.uniform(20, 80, (n_domains, 2))
    d2 = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    domain = np.argmin(d2, axis=1)

    X = rng.negative_binomial(2, 0.5, (n_cells, n_genes)).astype(np.float32)
    markers_per_domain = max(n_genes // (2 * n_domains), 1)
    for d in range(n_domains):
        cols = slice(d * markers_per_domain, (d + 1) * markers_per_domain)
        X[domain == d, cols] += rng.negative_binomial(8, 0.4, ((domain == d).sum(), markers_per_domain))

    adata = AnnData(
        X=X,
        obs=pd.DataFrame({"domain": [f"domain_{d}" for d in domain]}, index=[f"cell_{i}" for i in range(n_cells)]),
        var=pd.DataFrame(index=[f"gene_{j}" for j in range(n_genes)]),
    )
    adata.obsm["spatial"] = pts
    SKM.init_adata_type(adata, SKM.ADATA_UMI_TYPE)
    return adata
