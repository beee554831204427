"""Synthetic Stereo-seq bin1 UMI rasters, and the order in which a cell
sends them as tiles.

The rasters follow the JAX benchmark's `make_raster`: a background of
NB(1, 0.5) counts, and a disk of radius 4-9 px every 2,500 px², centred
anywhere, whose pixels each gain an NB(8, 0.35) count (overlapping disks
add). Here they are drawn on the device with one `torch.Generator` seeded
from the run's seed, the whole pool in a few large calls, and copied to the
host once: a user's stream starts from host rasters. NB(n, p) counts the
failures before the n-th success of probability p; it is drawn as a
Poisson of a Gamma(n, (1 - p) / p) rate, and NB(1, p) as the floor of
log(u) / log(1 - p).

A cell's traffic (its workload file's `params`) names the tile size, the
pool's size and the seed its rasters are drawn from (`pool_seed`), and the
section, if any. The run's seed orders the pool: tile i of the stream is
raster order[i % pool] of a permutation drawn from the run's seed.

- `"section": null`: an endless stream of full tiles from a section's
  interior;
- `"section": [H, W]`: the section in row-major tiles, edge tiles cut to
  what is left of it, over and over.

Every seed thus sends the same rasters in another order. The EM's work on
a raster depends on its counts (its iterations to convergence), and a
chunk's EM runs until its slowest tile has converged, so rasters drawn
from the run's seed made some seeds' runs twice as slow as others
(PERF.md); a pool of 17 with chunks of 16 leaves exactly one raster out of
each chunk, so every chunk does nearly the same work.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULTS = dict(background=[1, 0.5], cells=dict(px2_per_cell=2500, radius=[4, 10], nb=[8, 0.35]))


def _nb(gen, n: float, p: float, shape, device) -> torch.Tensor:
    rate = torch._standard_gamma(torch.full(shape, float(n), device=device), generator=gen) * ((1 - p) / p)
    return torch.poisson(rate, generator=gen)


def make_pool(n: int, tile: int, seed: int, device, params=None) -> np.ndarray:
    """[n, tile, tile] float32 host rasters drawn from `seed` on `device`."""
    p = {**DEFAULTS, **(params or {})}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    H = W = int(tile)
    bg_n, bg_p = p["background"]
    if bg_n != 1:
        raise ValueError("the background is NB(1, p)")
    u = 1.0 - torch.rand((n, H, W), generator=gen, device=device, dtype=torch.float64)  # (0, 1]
    X = torch.floor(torch.log(u) / np.log(1.0 - bg_p)).to(torch.float32)
    del u
    c = p["cells"]
    n_cells = (H * W) // int(c["px2_per_cell"])
    r_lo, r_hi = c["radius"]
    cy = torch.randint(0, H, (n, n_cells), generator=gen, device=device)
    cx = torch.randint(0, W, (n, n_cells), generator=gen, device=device)
    r = torch.randint(r_lo, r_hi, (n, n_cells), generator=gen, device=device)
    span = torch.arange(-(r_hi - 1), r_hi, device=device)
    dy, dx = span[:, None], span[None, :]
    y = cy[:, :, None, None] + dy
    x = cx[:, :, None, None] + dx
    inside = (dy * dy + dx * dx <= (r * r)[:, :, None, None]) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
    vals = _nb(gen, c["nb"][0], c["nb"][1], inside.shape, device)
    flat = (torch.arange(n, device=device)[:, None, None, None] * (H * W) + y * W + x)[inside]
    X.view(-1).index_add_(0, flat, vals[inside])
    return X.cpu().numpy()


def tile_shapes(tile: int, section=None):
    """The tiles' shapes in one pass over an [H, W] section, row-major, the
    last row and column cut to what is left; one full tile for an interior
    stream (`section` None)."""
    T = int(tile)
    if section is None:
        return [(T, T)]
    H, W = section
    return [(min(T, H - y), min(T, W - x)) for y in range(0, H, T) for x in range(0, W, T)]


class Tiles:
    """The tile stream of one cell: shapes and contents by index."""

    def __init__(self, params: dict, seed: int, device):
        self.tile = int(params["tile"])
        self.section = params.get("section")
        self.pool = make_pool(int(params["pool"]), self.tile, int(params["pool_seed"]), device, params.get("raster"))
        self.order = np.random.default_rng([int(seed) % (2**63), 3]).permutation(len(self.pool))
        self._shapes = tile_shapes(self.tile, self.section)

    def shapes_per_pass(self):
        """The tiles' shapes in one pass over the section, row-major; one
        full tile for an interior stream."""
        return list(self._shapes)

    def row_tiles(self) -> int:
        """Tiles in one row of the section (1 for an interior stream)."""
        return 1 if self.section is None else len(range(0, self.section[1], self.tile))

    def shape(self, i: int):
        return self._shapes[i % len(self._shapes)]

    def get(self, i: int) -> np.ndarray:
        h, w = self.shape(i)
        raster = self.pool[self.order[i % len(self.pool)]]
        return raster if (h, w) == raster.shape else np.ascontiguousarray(raster[:h, :w])

    def stream(self):
        """Tiles 0, 1, ... without end."""
        i = 0
        while True:
            yield self.get(i)
            i += 1


def chunks(shapes, em_batch: int):
    """The sizes of the chunks that a stream with `em_batch` forms from
    tiles of these shapes: runs of one shape, each cut at `em_batch`."""
    out, run, prev = [], 0, None
    for s in shapes:
        if s != prev or run == em_batch:
            if run:
                out.append(run)
            run, prev = 0, s
        run += 1
    if run:
        out.append(run)
    return out
