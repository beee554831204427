"""Named colormap surface (counterpart of `spateo_tpu.colormaps`; reference
spateo/configuration.py:300-460).

The same maps as the JAX package's, built from the same anchors and the same
Glasbey generator: the linear and diverging maps ("fire", "darkblue", ...,
"div_blue_red") from anchor colours along each colorcet table's trajectory,
and the two categorical maps ("glasbey_white", "glasbey_dark") by greedy
farthest-point sampling in CIELAB.

The GPU machine has no matplotlib, so importing this module needs none: the
palettes (`zebrafish_colors`, `zebrafish_256`, `cyc_10`, `cyc_20`) are data,
`glasbey_palette` computes hex colours in numpy, and the colormap objects
(`fire_cmap`, ..., `glasbey_dark_cmap`) are built, and registered with
matplotlib under their names, on first access of any of them, or by
`register_colormaps()`.
"""

from __future__ import annotations

import warnings
from typing import List

import numpy as np

__all__ = [
    "fire_cmap",
    "darkblue_cmap",
    "darkgreen_cmap",
    "darkred_cmap",
    "darkpurple_cmap",
    "div_blue_black_red_cmap",
    "div_blue_red_cmap",
    "glasbey_white_cmap",
    "glasbey_dark_cmap",
    "zebrafish_colors",
    "zebrafish_256",
    "cyc_10",
    "cyc_20",
    "glasbey_palette",
]


# ---------------------------------------------------------------------------
# CIELAB machinery for the Glasbey generator
# ---------------------------------------------------------------------------


def _srgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """Vectorized sRGB (0-1) -> CIELAB (D65). Standard two-step transform."""
    rgb = np.asarray(rgb, np.float64)
    lin = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    M = np.array(
        [
            [0.4124564, 0.3575761, 0.1804375],
            [0.2126729, 0.7151522, 0.0721750],
            [0.0193339, 0.1191920, 0.9503041],
        ]
    )
    xyz = lin @ M.T
    white = np.array([0.95047, 1.0, 1.08883])
    t = xyz / white
    f = np.where(t > (6 / 29) ** 3, np.cbrt(t), t / (3 * (6 / 29) ** 2) + 4 / 29)
    L = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1)


def _to_hex(rgb) -> str:
    """An RGB triple in [0, 1] as '#rrggbb', rounded as matplotlib's
    `to_hex` rounds."""
    return "#" + "".join(format(round(float(v) * 255), "02x") for v in rgb)


def glasbey_palette(
    n: int = 256,
    min_chroma: float = 20.0,
    min_lightness: float = 0.0,
    max_lightness: float = 100.0,
    grid: int = 24,
) -> List[str]:
    """Generate ``n`` maximally-distinct categorical colors (our Glasbey):
    greedy farthest-point sampling in CIELAB over a ``grid``^3 sRGB lattice,
    restricted to the requested chroma/lightness band. Deterministic."""
    g = np.linspace(0.0, 1.0, grid)
    r, gg, b = np.meshgrid(g, g, g, indexing="ij")
    rgb = np.stack([r.ravel(), gg.ravel(), b.ravel()], axis=1)
    lab = _srgb_to_lab(rgb)
    chroma = np.hypot(lab[:, 1], lab[:, 2])
    keep = (chroma >= min_chroma) & (lab[:, 0] >= min_lightness) & (lab[:, 0] <= max_lightness)
    rgb, lab = rgb[keep], lab[keep]
    # start from the most chromatic candidate; grow by max-min Lab distance
    first = int(np.argmax(np.hypot(lab[:, 1], lab[:, 2])))
    chosen = [first]
    min_d = np.linalg.norm(lab - lab[first], axis=1)
    for _ in range(1, n):
        nxt = int(np.argmax(min_d))
        chosen.append(nxt)
        d = np.linalg.norm(lab - lab[nxt], axis=1)
        min_d = np.minimum(min_d, d)
    return [_to_hex(c) for c in rgb[chosen]]


# linear maps — anchor trajectories of the colorcet tables the reference uses
# (configuration.py:308-318); diverging maps (configuration.py:314-318)
_LINEAR_ANCHORS = {
    "fire_cmap": ("fire", ["#000000", "#750000", "#e60000", "#ff8c00", "#ffd700", "#ffffe0"]),
    "darkblue_cmap": ("darkblue", ["#000000", "#00008b", "#1874cd", "#00bfff", "#bfefff"]),
    "darkgreen_cmap": ("darkgreen", ["#000000", "#004d00", "#2e8b57", "#7ccd7c", "#e0ffd0"]),
    "darkred_cmap": ("darkred", ["#000000", "#5e0000", "#b22222", "#ff4500"]),
    "darkpurple_cmap": ("darkpurple", ["#000033", "#2e0854", "#8b008b", "#e066ff", "#ffffff"]),
    "div_blue_black_red_cmap": ("div_blue_black_red", ["#1e90ff", "#000000", "#e60000"]),
    "div_blue_red_cmap": ("div_blue_red", ["#2166ac", "#f7f7f7", "#b2182b"]),
}
# categorical glasbey maps (configuration.py:320-322): white-background
# variant keeps the full lightness range; dark-background caps lightness
_GLASBEY_BANDS = {
    "glasbey_white_cmap": ("glasbey_white", 95.0),
    "glasbey_dark_cmap": ("glasbey_dark", 70.0),
}
_CMAPS: dict = {}


def register_colormaps() -> dict:
    """Build every named colormap once and register each with matplotlib
    under its name (where the name is free). Returns {attribute: colormap}."""
    if _CMAPS:
        return _CMAPS
    import matplotlib as mpl
    from matplotlib import colors

    built = {attr: colors.LinearSegmentedColormap.from_list(name, anchors, N=256)
             for attr, (name, anchors) in _LINEAR_ANCHORS.items()}
    for attr, (name, max_lightness) in _GLASBEY_BANDS.items():
        built[attr] = colors.LinearSegmentedColormap.from_list(
            name, glasbey_palette(256, min_chroma=20.0, min_lightness=10.0, max_lightness=max_lightness)
        )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for cmap in built.values():
            if cmap.name not in mpl.colormaps():
                mpl.colormaps.register(cmap=cmap, name=cmap.name)
    _CMAPS.update(built)
    return _CMAPS


def __getattr__(name):
    if name in _LINEAR_ANCHORS or name in _GLASBEY_BANDS:
        return register_colormaps()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# the zebrafish annotation palette (configuration.py:441-458) — a shipped
# 12-color constant, part of the public API surface
zebrafish_colors = [
    "#4876ff",
    "#85C7F2",
    "#cd00cd",
    "#911eb4",
    "#000080",
    "#808080",
    "#008080",
    "#ffc125",
    "#262626",
    "#3cb44b",
    "#ff4241",
    "#b77df9",
]

# matplotlib's tab10 and tab20c, as hex
cyc_10 = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]
cyc_20 = [
    "#3182bd", "#6baed6", "#9ecae1", "#c6dbef", "#e6550d",
    "#fd8d3c", "#fdae6b", "#fdd0a2", "#31a354", "#74c476",
    "#a1d99b", "#c7e9c0", "#756bb1", "#9e9ac8", "#bcbddc",
    "#dadaeb", "#636363", "#969696", "#bdbdbd", "#d9d9d9",
]
zebrafish_256 = [c.lower() for c in zebrafish_colors]
