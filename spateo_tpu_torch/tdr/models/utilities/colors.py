"""Colors without matplotlib: the named colors and color strings that
`add_model_labels` resolves, as matplotlib 3.10.8 resolves them
(`matplotlib.colors.to_rgba` and `to_hex`), for machines without matplotlib
(the GPU machine has none).

Resolved here: RGB(A) sequences, "none", CSS4 names (any case), the
single-letter base colors, "tab:" colors, "#rgb", "#rgba", "#rrggbb",
"#rrggbbaa" and grayscale strings such as "0.5". `COLORMAP_NAMES` lists
matplotlib's own colormap names, which `add_model_labels` tells from color
names (names that other packages register, colorcet's say, are not
colormaps here, though they are in a process that imported them). matplotlib is imported only to sample a colormap, or for the color
forms not listed ("xkcd:" names, the "C0" color cycle).
"""

from __future__ import annotations

import re
from numbers import Real
from typing import Tuple

BASE_COLORS = {
    "b": (0.0, 0.0, 1.0), "g": (0.0, 0.5, 0.0), "r": (1.0, 0.0, 0.0), "c": (0.0, 0.75, 0.75),
    "m": (0.75, 0.0, 0.75), "y": (0.75, 0.75, 0.0), "k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0),
}
TABLEAU_COLORS = {
    "tab:blue": "#1f77b4", "tab:orange": "#ff7f0e", "tab:green": "#2ca02c", "tab:red": "#d62728",
    "tab:purple": "#9467bd", "tab:brown": "#8c564b", "tab:pink": "#e377c2", "tab:gray": "#7f7f7f",
    "tab:olive": "#bcbd22", "tab:cyan": "#17becf", "tab:grey": "#7f7f7f",
}
CSS4_COLORS = {
    "aliceblue": "#F0F8FF", "antiquewhite": "#FAEBD7", "aqua": "#00FFFF", "aquamarine": "#7FFFD4",
    "azure": "#F0FFFF", "beige": "#F5F5DC", "bisque": "#FFE4C4", "black": "#000000",
    "blanchedalmond": "#FFEBCD", "blue": "#0000FF", "blueviolet": "#8A2BE2", "brown": "#A52A2A",
    "burlywood": "#DEB887", "cadetblue": "#5F9EA0", "chartreuse": "#7FFF00", "chocolate": "#D2691E",
    "coral": "#FF7F50", "cornflowerblue": "#6495ED", "cornsilk": "#FFF8DC", "crimson": "#DC143C",
    "cyan": "#00FFFF", "darkblue": "#00008B", "darkcyan": "#008B8B", "darkgoldenrod": "#B8860B",
    "darkgray": "#A9A9A9", "darkgreen": "#006400", "darkgrey": "#A9A9A9", "darkkhaki": "#BDB76B",
    "darkmagenta": "#8B008B", "darkolivegreen": "#556B2F", "darkorange": "#FF8C00", "darkorchid": "#9932CC",
    "darkred": "#8B0000", "darksalmon": "#E9967A", "darkseagreen": "#8FBC8F", "darkslateblue": "#483D8B",
    "darkslategray": "#2F4F4F", "darkslategrey": "#2F4F4F", "darkturquoise": "#00CED1",
    "darkviolet": "#9400D3", "deeppink": "#FF1493", "deepskyblue": "#00BFFF", "dimgray": "#696969",
    "dimgrey": "#696969", "dodgerblue": "#1E90FF", "firebrick": "#B22222", "floralwhite": "#FFFAF0",
    "forestgreen": "#228B22", "fuchsia": "#FF00FF", "gainsboro": "#DCDCDC", "ghostwhite": "#F8F8FF",
    "gold": "#FFD700", "goldenrod": "#DAA520", "gray": "#808080", "green": "#008000",
    "greenyellow": "#ADFF2F", "grey": "#808080", "honeydew": "#F0FFF0", "hotpink": "#FF69B4",
    "indianred": "#CD5C5C", "indigo": "#4B0082", "ivory": "#FFFFF0", "khaki": "#F0E68C",
    "lavender": "#E6E6FA", "lavenderblush": "#FFF0F5", "lawngreen": "#7CFC00", "lemonchiffon": "#FFFACD",
    "lightblue": "#ADD8E6", "lightcoral": "#F08080", "lightcyan": "#E0FFFF",
    "lightgoldenrodyellow": "#FAFAD2", "lightgray": "#D3D3D3", "lightgreen": "#90EE90",
    "lightgrey": "#D3D3D3", "lightpink": "#FFB6C1", "lightsalmon": "#FFA07A", "lightseagreen": "#20B2AA",
    "lightskyblue": "#87CEFA", "lightslategray": "#778899", "lightslategrey": "#778899",
    "lightsteelblue": "#B0C4DE", "lightyellow": "#FFFFE0", "lime": "#00FF00", "limegreen": "#32CD32",
    "linen": "#FAF0E6", "magenta": "#FF00FF", "maroon": "#800000", "mediumaquamarine": "#66CDAA",
    "mediumblue": "#0000CD", "mediumorchid": "#BA55D3", "mediumpurple": "#9370DB",
    "mediumseagreen": "#3CB371", "mediumslateblue": "#7B68EE", "mediumspringgreen": "#00FA9A",
    "mediumturquoise": "#48D1CC", "mediumvioletred": "#C71585", "midnightblue": "#191970",
    "mintcream": "#F5FFFA", "mistyrose": "#FFE4E1", "moccasin": "#FFE4B5", "navajowhite": "#FFDEAD",
    "navy": "#000080", "oldlace": "#FDF5E6", "olive": "#808000", "olivedrab": "#6B8E23", "orange": "#FFA500",
    "orangered": "#FF4500", "orchid": "#DA70D6", "palegoldenrod": "#EEE8AA", "palegreen": "#98FB98",
    "paleturquoise": "#AFEEEE", "palevioletred": "#DB7093", "papayawhip": "#FFEFD5", "peachpuff": "#FFDAB9",
    "peru": "#CD853F", "pink": "#FFC0CB", "plum": "#DDA0DD", "powderblue": "#B0E0E6", "purple": "#800080",
    "rebeccapurple": "#663399", "red": "#FF0000", "rosybrown": "#BC8F8F", "royalblue": "#4169E1",
    "saddlebrown": "#8B4513", "salmon": "#FA8072", "sandybrown": "#F4A460", "seagreen": "#2E8B57",
    "seashell": "#FFF5EE", "sienna": "#A0522D", "silver": "#C0C0C0", "skyblue": "#87CEEB",
    "slateblue": "#6A5ACD", "slategray": "#708090", "slategrey": "#708090", "snow": "#FFFAFA",
    "springgreen": "#00FF7F", "steelblue": "#4682B4", "tan": "#D2B48C", "teal": "#008080",
    "thistle": "#D8BFD8", "tomato": "#FF6347", "turquoise": "#40E0D0", "violet": "#EE82EE",
    "wheat": "#F5DEB3", "white": "#FFFFFF", "whitesmoke": "#F5F5F5", "yellow": "#FFFF00",
    "yellowgreen": "#9ACD32",
}
COLORMAP_NAMES = frozenset(
    """
    Accent Accent_r Blues Blues_r BrBG BrBG_r BuGn BuGn_r BuPu BuPu_r CMRmap CMRmap_r Dark2 Dark2_r
    GnBu GnBu_r Grays Grays_r Greens Greens_r Greys Greys_r OrRd OrRd_r Oranges Oranges_r PRGn
    PRGn_r Paired Paired_r Pastel1 Pastel1_r Pastel2 Pastel2_r PiYG PiYG_r PuBu PuBuGn PuBuGn_r
    PuBu_r PuOr PuOr_r PuRd PuRd_r Purples Purples_r RdBu RdBu_r RdGy RdGy_r RdPu RdPu_r RdYlBu
    RdYlBu_r RdYlGn RdYlGn_r Reds Reds_r Set1 Set1_r Set2 Set2_r Set3 Set3_r Spectral Spectral_r
    Wistia Wistia_r YlGn YlGnBu YlGnBu_r YlGn_r YlOrBr YlOrBr_r YlOrRd YlOrRd_r afmhot afmhot_r
    autumn autumn_r berlin berlin_r binary binary_r bone bone_r brg brg_r bwr bwr_r cividis
    cividis_r cool cool_r coolwarm coolwarm_r copper copper_r cubehelix cubehelix_r flag flag_r
    gist_earth gist_earth_r gist_gray gist_gray_r gist_grey gist_grey_r gist_heat gist_heat_r
    gist_ncar gist_ncar_r gist_rainbow gist_rainbow_r gist_stern gist_stern_r gist_yarg gist_yarg_r
    gist_yerg gist_yerg_r gnuplot gnuplot2 gnuplot2_r gnuplot_r gray gray_r grey grey_r hot hot_r
    hsv hsv_r inferno inferno_r jet jet_r magma magma_r managua managua_r nipy_spectral
    nipy_spectral_r ocean ocean_r pink pink_r plasma plasma_r prism prism_r rainbow rainbow_r
    seismic seismic_r spring spring_r summer summer_r tab10 tab10_r tab20 tab20_r tab20b tab20b_r
    tab20c tab20c_r terrain terrain_r turbo turbo_r twilight twilight_r twilight_shifted
    twilight_shifted_r vanimo vanimo_r viridis viridis_r winter winter_r
    """.split()
)
_HEX = re.compile(r"\A#([a-fA-F0-9]{3,4}|[a-fA-F0-9]{6}|[a-fA-F0-9]{8})\Z")


def _named(c: str):
    for key in (c, c.lower()) if len(c) != 1 else (c,):
        for table in (CSS4_COLORS, TABLEAU_COLORS, BASE_COLORS):
            if key in table:
                return table[key]
    return None


def to_rgba(c, alpha=None) -> Tuple[float, float, float, float]:
    """`matplotlib.colors.to_rgba(c, alpha)` for the forms listed above."""
    if alpha is not None and not 0 <= alpha <= 1:
        raise ValueError("'alpha' must be between 0 and 1, inclusive")
    orig = c
    if isinstance(c, str):
        if c.lower() == "none":
            return (0.0, 0.0, 0.0, 0.0)
        c = _named(c) or c
    if isinstance(c, str):
        m = _HEX.match(c)
        if m:
            h = m.group(1)
            if len(h) in (3, 4):
                h = "".join(ch * 2 for ch in h)
            rgba = [int(h[i : i + 2], 16) / 255 for i in range(0, len(h), 2)]
            if len(rgba) == 3:
                rgba.append(1.0)
            if alpha is not None:
                rgba[-1] = alpha
            return tuple(rgba)
        if re.match(r"\A(xkcd:|C\d)", c):
            import matplotlib.colors as mcolors

            return mcolors.to_rgba(c, alpha)
        try:
            g = float(c)
        except ValueError:
            raise ValueError(f"Invalid RGBA argument: {orig!r}") from None
        if not 0 <= g <= 1:
            raise ValueError(f"Invalid string grayscale value {orig!r}. Value must be within 0-1 range")
        return g, g, g, alpha if alpha is not None else 1.0
    if hasattr(c, "ndim") and c.ndim == 2 and c.shape[0] == 1:
        c = c.reshape(-1)
    if not hasattr(c, "__len__") or len(c) not in (3, 4) or not all(isinstance(x, Real) for x in c):
        raise ValueError(f"Invalid RGBA argument: {orig!r}")
    c = tuple(map(float, c))
    if len(c) == 3 and alpha is None:
        alpha = 1
    if alpha is not None:
        c = c[:3] + (alpha,)
    if any(v < 0 or v > 1 for v in c):
        raise ValueError("RGBA values should be within 0-1 range")
    return c


def to_hex(c) -> str:
    """`matplotlib.colors.to_hex(c)`: "#rrggbb"."""
    return "#" + "".join(format(round(v * 255), "02x") for v in to_rgba(c)[:3])


def colormap_hex(name: str, n: int) -> list:
    """The hex colors of matplotlib's colormap `name` at n points evenly
    spread over [0, 1] (needs matplotlib)."""
    import matplotlib as mpl
    import numpy as np

    cmap = mpl.colormaps[name]
    return [to_hex(cmap(x)) for x in np.linspace(0, 1, n)]
