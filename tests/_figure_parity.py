"""Figure comparison for the plotting parity tests: two matplotlib figures
drawn by the JAX package and by the port from the same inputs are held
equal in two ways, their rendered RGBA buffers and their artists (axes,
collections' offsets, colours and arrays, lines' data, images' arrays,
texts, patches) within `RTOL`."""

import numpy as np

RTOL = 1e-6


def rgba(fig) -> np.ndarray:
    """The figure rendered on its Agg canvas, as an [H, W, 4] uint8 array."""
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def _arr(x):
    """An artist's values as a plain array (masked entries as NaN)."""
    if x is None or not np.ma.isMaskedArray(x):
        return None if x is None else np.asarray(x)
    return np.ma.filled(x.astype(float), np.nan)


def _collection(c):
    out = {
        "type": type(c).__name__,
        "offsets": _arr(c.get_offsets()),
        "facecolors": _arr(c.get_facecolor()),
        "edgecolors": _arr(c.get_edgecolor()),
        "linewidths": _arr(c.get_linewidths()),
        "array": _arr(c.get_array()),
        "visible": c.get_visible(),
        "zorder": c.get_zorder(),
    }
    if hasattr(c, "get_sizes"):
        out["sizes"] = _arr(c.get_sizes())
    if hasattr(c, "_offsets3d"):
        out["offsets3d"] = [_arr(v) for v in c._offsets3d]
    if hasattr(c, "U"):  # a quiver
        out["uv"] = (_arr(c.U), _arr(c.V))
    paths = c.get_paths()
    if len(paths) <= 2000:
        out["paths"] = [_arr(p.vertices) for p in paths]
    if hasattr(c, "_segments3d"):
        out["segments3d"] = [_arr(s) for s in c._segments3d]
    if hasattr(c, "_vec"):
        out["vec"] = _arr(c._vec)
    return out


def _axes(ax):
    out = {
        "type": type(ax).__name__,
        "title": (ax.get_title("left"), ax.get_title(), ax.get_title("right")),
        "labels": (ax.get_xlabel(), ax.get_ylabel()),
        "xlim": ax.get_xlim(),
        "ylim": ax.get_ylim(),
        "visible": ax.get_visible(),
        "axison": ax.axison,
        "xticks": [(t.get_text(), t.get_position()) for t in ax.get_xticklabels()],
        "yticks": [(t.get_text(), t.get_position()) for t in ax.get_yticklabels()],
        "collections": [_collection(c) for c in ax.collections],
        "lines": [_arr(ln.get_data_3d() if hasattr(ln, "get_data_3d") else ln.get_xydata()) for ln in ax.lines],
        "line_styles": [(ln.get_color(), ln.get_linestyle(), ln.get_linewidth(), ln.get_alpha()) for ln in ax.lines],
        "images": [(_arr(im.get_array()), im.get_extent()) for im in ax.get_images()],
        "texts": [(t.get_text(), t.get_position()) for t in ax.texts],
        "patches": [(type(p).__name__, _arr(p.get_path().vertices), _arr(p.get_facecolor())) for p in ax.patches],
    }
    if hasattr(ax, "get_zlim"):
        out["zlim"] = ax.get_zlim()
        out["view"] = (ax.elev, ax.azim)
    leg = ax.get_legend()
    out["legend"] = None if leg is None else [t.get_text() for t in leg.get_texts()]
    return out


def artists(fig) -> dict:
    """The figure's artists as nested dicts and lists of plain values."""
    return {
        "size": tuple(fig.get_size_inches()),
        "dpi": fig.dpi,
        "suptitle": fig._suptitle.get_text() if fig._suptitle is not None else None,
        "legends": [[t.get_text() for t in lg.get_texts()] for lg in fig.legends],
        "axes": [_axes(ax) for ax in fig.axes],
    }


def assert_close(a, b, rtol=RTOL, where="figure"):
    """Recursive equality of two `artists` trees: strings and flags equal,
    numbers and arrays within `rtol` of scale (NaN where NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            assert_close(a[k], b[k], rtol, f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not (a and all(isinstance(x, (int, float, np.number)) for x in a)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, len(a), len(b) if hasattr(b, "__len__") else b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, rtol, f"{where}[{i}]")
    elif a is None or isinstance(a, (str, bool, bytes)):
        assert a == b, (where, a, b)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, (where, x.shape, y.shape)
        if x.dtype.kind in "OUS" or y.dtype.kind in "OUS":
            assert x.tolist() == y.tolist(), where
            return
        x, y = x.astype(float), y.astype(float)
        assert np.array_equal(np.isnan(x), np.isnan(y)), where
        m = ~np.isnan(x)
        scale = max(float(np.abs(x[m]).max()) if m.any() else 0.0, 1e-300)
        err = float(np.abs(x[m] - y[m]).max() / scale) if m.any() else 0.0
        assert err <= rtol, (where, err)


def assert_same_figure(fa, fb, pixels=True, rtol=RTOL):
    """The JAX package's figure `fa` and the port's `fb`: the same artists
    within `rtol`, and (with `pixels`) equal rendered RGBA buffers."""
    if pixels:
        pa, pb = rgba(fa), rgba(fb)
        assert pa.shape == pb.shape and int((pa != pb).any(-1).sum()) == 0, "rendered pixels differ"
    else:
        fa.canvas.draw()
        fb.canvas.draw()
    assert_close(artists(fa), artists(fb), rtol)


def figure_of(out):
    """The figure of what a plot returned: a figure, an axes, a list of
    axes, or a tuple holding one of those first."""
    if isinstance(out, tuple):
        out = out[0]
    if isinstance(out, (list, np.ndarray)):
        out = np.ravel(out)[0]
    return out if hasattr(out, "savefig") else out.figure
