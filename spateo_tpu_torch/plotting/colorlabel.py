"""Categorical palettes and the cell-contour colour-label plot (counterpart
of `spateo_tpu.plotting.colorlabel`; reference plotting/static/colorlabel.py:
12-326). The palettes are data: matplotlib's tab10 and tab20 are written out
as hex, so that importing them needs no matplotlib. `color_label` lives in
`geo` and `map2color` in `utils`, re-exported here under the reference module
name."""

from __future__ import annotations

from .geo import color_label  # noqa: F401
from .utils import map2color  # noqa: F401

DEFAULT_COLORS = ("red", "blue", "yellow", "magenta", "green", "indigo", "darkorange", "cyan", "pink", "yellowgreen")

# Custom bright colors palette (reference colorlabel.py:94):
bright_10 = [
    "#9d00fe",
    "#0000ff",
    "#ff0000",
    "#21b20c",
    "#f2e50b",
    "#6e260e",
    "#cd7f32",
    "#ff7518",
    "#ff0000",
    "#feb3c6",
]

# Scanpy-style categorical maps (reference colorlabel.py:109-176):
# matplotlib's tab10, as hex:
vega_10 = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]
vega_10_scanpy = vega_10.copy()
vega_10_scanpy[2] = "#279e68"  # green
vega_10_scanpy[4] = "#aa40fc"  # purple
vega_10_scanpy[8] = "#b5bd61"  # kakhi

# matplotlib's tab20, as hex:
vega_20 = [
    "#1f77b4", "#aec7e8", "#ff7f0e", "#ffbb78", "#2ca02c",
    "#98df8a", "#d62728", "#ff9896", "#9467bd", "#c5b0d5",
    "#8c564b", "#c49c94", "#e377c2", "#f7b6d2", "#7f7f7f",
    "#c7c7c7", "#bcbd22", "#dbdb8d", "#17becf", "#9edae5",
]
# reordered, some removed, some added (scanpy's default_20)
vega_20_scanpy = (
    vega_20[0:14:2]
    + vega_20[16::2]
    + vega_20[1:15:2]
    + vega_20[17::2]
    + ["#ad494a", "#8c6d31"]
)
vega_20_scanpy[2] = "#279e68"  # green
vega_20_scanpy[4] = "#aa40fc"  # purple
vega_20_scanpy[7] = "#b5bd61"  # kakhi
default_20 = vega_20_scanpy

# Zeileis et al. "Escaping RGBland" 28-color map (reference :142):
zeileis_28 = [
    "#023fa5", "#7d87b9", "#bec1d4", "#d6bcc0", "#bb7784", "#8e063b",
    "#4a6fe3", "#8595e1", "#b5bbe3", "#e6afb9", "#e07b91", "#d33f6a",
    "#11c638", "#8dd593", "#c6dec7", "#ead3c6", "#f0b98d", "#ef9708",
    "#0fcfc0", "#9cded6", "#d5eae7", "#f3e1eb", "#f6c4e1", "#f79cd4",
    "#7f7f7f", "#c7c7c7", "#1CE6FF", "#336600",
]
default_28 = zeileis_28

# Godsnot's 102-color "Kelly" extension (reference :178):
godsnot_102 = [
    "#FFFF00", "#1CE6FF", "#FF34FF", "#FF4A46", "#008941", "#006FA6",
    "#A30059", "#FFDBE5", "#7A4900", "#0000A6", "#63FFAC", "#B79762",
    "#004D43", "#8FB0FF", "#997D87", "#5A0007", "#809693", "#6A3A4C",
    "#1B4400", "#4FC601", "#3B5DFF", "#4A3B53", "#FF2F80", "#61615A",
    "#BA0900", "#6B7900", "#00C2A0", "#FFAA92", "#FF90C9", "#B903AA",
    "#D16100", "#DDEFFF", "#000035", "#7B4F4B", "#A1C299", "#300018",
    "#0AA6D8", "#013349", "#00846F", "#372101", "#FFB500", "#C2FFED",
    "#A079BF", "#CC0744", "#C0B9B2", "#C2FF99", "#001E09", "#00489C",
    "#6F0062", "#0CBD66", "#EEC3FF", "#456D75", "#B77B68", "#7A87A1",
    "#788D66", "#885578", "#FAD09F", "#FF8A9A", "#D157A0", "#BEC459",
    "#456648", "#0086ED", "#886F4C", "#34362D", "#B4A8BD", "#00A6AA",
    "#452C2C", "#636375", "#A3C8C9", "#FF913F", "#938A81", "#575329",
    "#00FECF", "#B05B6F", "#8CD0FF", "#3B9700", "#04F757", "#C8A1A1",
    "#1E6E00", "#7900D7", "#A77500", "#6367A9", "#A05837", "#6B002C",
    "#772600", "#D790FF", "#9B9700", "#549E79", "#FFF69F", "#201625",
    "#72418F", "#BC23FF", "#99ADC0", "#3A2465", "#922329", "#5B4534",
    "#FDE8DC", "#404E55", "#0089A3", "#CB7E98", "#A4E804", "#324E72",
]

# D. Zhu's color scheme for categorical data - interaction plots
# (reference colorlabel.py:285):
interaction_colors = [
    "#FF0000", "#FF69B4", "#FFF68F", "#FF8C00", "#C71585", "#00CED1",
    "#1874CD", "#8B4726", "#9400D3", "#00C957", "#8EE5EE", "#CDC673",
    "#7CFC00", "#8A2BE2", "#FFD700", "#FF1493", "#008000", "#4682B4",
    "#B22222", "#FF00FF", "#32CD32", "#1E90FF", "#FFD700", "#9AFF9A",
    "#EE0000", "#808080", "#C1FFC1", "#B22222", "#FFFF00", "#FFFFFF",
    "#FA8072", "#FFC1C1", "#836FFF", "#FF4500", "#698B22", "#7CCD7C",
    "#C6E2FF", "#FFA500", "#00FFFF",
]
