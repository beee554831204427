"""Synthetic pairs of serial sections for Morpho, as a user prepares them
for `morpho_align` on joint PCs: two sections of one tissue, each with its
own cells, their counts of `genes` genes reduced to `pcs` joint principal
components (Spateo's `group_pca`: 2,000 HVGs, 50 components).

The tissue is one spatially patterned expression field over a 10 x 10
square: `types` cell types, each with its own mean profile over the genes
(a base level and a tenth of the genes as markers), whose local mixture
follows smooth plane waves of wavelength 2-6, so that the types form
domains. Each section draws its `cells` cells uniformly and independently
of the other's, a type for each from the mixture at its place, a library
size, and Poisson counts. The counts of both sections are normalised to
10,000, log1p-transformed, centred and projected on the joint covariance's
top `pcs` eigenvectors, as `group_pca` does.

The moving section is cut with a deformation: its cells lie at their true
places plus a smooth warp (a sum of plane waves of wavelength 3-8 whose
affine part is removed, scaled to `warp` per axis, root mean square), then
under the planted `rotation` (radians) and `shift`. A sound alignment takes
the moving cells back to their warped places (`truth`): the warp has no
rigid part to undo.

Everything is drawn on `device` with one `torch.Generator` seeded from the
run's seed and the pair's index, in a few large calls; the sections reach
the program as host arrays, as a user's AnnData holds them. A cell's
traffic (its workload file's `params`): `cells`, `genes`, `types`, `pcs`,
`warp`, `rotation`, `shift` and `pool`, the number of pairs made in set-up
and sent in turn.
"""

from __future__ import annotations

import math

import numpy as np


def _waves(g, n_waves: int, lo: float, hi: float, device):
    """Random plane waves: wave vectors of wavelength in [lo, hi] and phases."""
    import torch

    length = lo + (hi - lo) * torch.rand(n_waves, generator=g, device=device)
    angle = 2 * math.pi * torch.rand(n_waves, generator=g, device=device)
    k = (2 * math.pi / length)[:, None] * torch.stack([torch.cos(angle), torch.sin(angle)], 1)
    return k, 2 * math.pi * torch.rand(n_waves, generator=g, device=device)


def make_pair(params: dict, seed: int, i: int, device="cpu") -> dict:
    """Pair i of a run: `fixed`, `moving` (coordinates [n, 2]), `fixed_pcs`,
    `moving_pcs` ([n, pcs]) and `truth` (the moving cells' warped places
    before the planted rotation and shift), all float32 host arrays."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(i)) % (2**63))
    n, n_genes, n_types = int(params["cells"]), int(params["genes"]), int(params["types"])
    f32 = dict(dtype=torch.float32, device=device)
    uniform = lambda *shape: torch.rand(*shape, generator=g, **f32)
    normal = lambda *shape: torch.randn(*shape, generator=g, **f32)

    # the tissue: the types' profiles and the waves their mixture follows
    base = normal(n_genes) - 1.0
    markers = (uniform(n_types, n_genes) < 0.1).to(torch.float32) * (1.0 + normal(n_types, n_genes).abs())
    profile = torch.exp(base[None, :] + markers)  # [types, genes]
    k, phase = _waves(g, 24, 2.0, 6.0, device)
    weight = normal(24, n_types) * 1.5

    def counts(xy):
        mix = torch.softmax(torch.cos(xy @ k.T + phase) @ weight, dim=1)
        kind = torch.multinomial(mix, 1, generator=g)[:, 0]
        size = torch.exp(0.3 * normal(len(xy)))
        return torch.poisson(profile[kind] * size[:, None], generator=g)

    fixed = 10.0 * uniform(n, 2)
    true = 10.0 * uniform(n, 2)
    X = torch.cat([counts(fixed), counts(true)])  # [2n, genes]

    # the deformation: plane waves, their affine part removed, a fixed size
    kw, pw = _waves(g, 4, 3.0, 8.0, device)
    w = torch.cos(true @ kw.T + pw) @ normal(4, 2)
    design = torch.cat([true, torch.ones(n, 1, **f32)], 1).double()
    w = w - (design @ torch.linalg.lstsq(design, w.double()).solution).float()
    w = w * (float(params["warp"]) / w.pow(2).mean(0).sqrt())
    truth = true + w
    th = float(params["rotation"])
    R = torch.tensor([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]], **f32)
    moving = truth @ R.T + torch.tensor(params["shift"], **f32)

    # group_pca: normalise, log1p, centre, the joint covariance's top components
    X.mul_(1e4 / X.sum(1, keepdim=True).clamp_min(1.0)).log1p_()
    X.sub_(X.mean(0))
    _, vecs = torch.linalg.eigh((X.T @ X).double() / (2 * n - 1))
    top = vecs[:, -int(params["pcs"]):].flip(1).float()
    top = top * torch.sign(top[top.abs().argmax(0), torch.arange(top.shape[1], device=device)])
    pcs = X @ top
    host = lambda t: np.ascontiguousarray(t.cpu().numpy(), dtype=np.float32)
    return {"fixed": host(fixed), "moving": host(moving), "fixed_pcs": host(pcs[:n]), "moving_pcs": host(pcs[n:]),
            "truth": host(truth)}


def adata(core, coords: np.ndarray, pcs: np.ndarray, key: str):
    """An AnnData of the program's own class, as a user's section is after
    `group_pca`: its cells' places and their joint PCs under `key`."""
    import pandas as pd

    a = core.AnnData(X=np.zeros((len(coords), 1), np.float32),
                     obs=pd.DataFrame(index=[f"c{i}" for i in range(len(coords))]), var=pd.DataFrame(index=["g0"]))
    a.obsm["spatial"] = coords.copy()
    a.obsm[key] = pcs.copy()
    a.uns["__type"] = "UMI"
    return a
