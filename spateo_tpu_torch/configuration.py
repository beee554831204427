"""Global configuration, the AnnData schema registry (SKM) and the figure
settings.

Counterpart of `spateo_tpu.configuration`:

- ``SpateoConfig`` / ``config``: the logging level; `n_threads`, whose
  setter sets OpenCV's threads as the JAX package's does (the constructor
  only stores it, so that importing the package loads no OpenCV);
  `precision`, whose `dtype` is a torch dtype; `mesh`, the
  `torch.distributed` device mesh that `mesh_shape` and `mesh_axis_names`
  describe over the default process group's ranks, on `mesh_device`
  ("cuda" by default, or "cpu"), built on first use and kept until one of
  the three or the process group changes (`parallel.create_mesh`; with no
  group, a one-rank mesh). `enable_x64=True` raises `ConfigurationError`: the port
  narrows host float64 to float32 where it enters the device, as the JAX
  package does with x64 off, and has no global x64 mode to switch on.
- ``SKM``: the same key vocabulary (``__type``, ``AGG``/``UMI``, layer
  suffixes), so layers written by either package carry the same names.
- The figure settings (`shiftedColorMap`, `config_spateo_rcParams`,
  `set_figure_params`, `reset_rcParams`, `spateo_theme`,
  `set_pub_style_mpltex`, `set_pub_style`) import matplotlib inside
  themselves, since the GPU machine has none; the named colormaps of
  `colormaps` are reachable here by the same names, built on first access.

The JAX package's XLA compilation cache has no counterpart: the kernels'
build cache is `ops/_build.py`'s. TF32 stays off on every card path; there
is no switch for it here.
"""

from __future__ import annotations

import functools
import inspect
import logging
import os
from typing import Optional, Tuple, Union

import numpy as np
from scipy import sparse

from .core.anndata import AnnData
from .errors import ConfigurationError
from .logging import logger_manager as lm

# Global tolerance values (parity: reference configuration.py:22-24)
EPS = np.finfo(float).eps
MAX = np.finfo(np.float32).max


class SpateoConfig:
    """Global framework configuration (counterpart of
    `spateo_tpu.configuration.SpateoConfig`)."""

    def __init__(
        self,
        logging_level: int = logging.INFO,
        n_threads: int = os.cpu_count() or 1,
        mesh_shape: Optional[Tuple[int, ...]] = None,
        mesh_axis_names: Tuple[str, ...] = ("data", "model"),
        precision: str = "float32",
        enable_x64: bool = False,
    ):
        self.logging_level = logging_level
        # stored, not applied: importing the package loads no OpenCV; setting
        # `n_threads` later sets OpenCV's threads, as the JAX package does
        self.__n_threads = n_threads
        self._mesh_shape = mesh_shape
        self._mesh_axis_names = mesh_axis_names
        self._mesh_device = "cuda"
        self._mesh = None
        self._mesh_key = None
        self.precision = precision
        self.enable_x64 = enable_x64

    # -- logging ------------------------------------------------------------
    @property
    def logging_level(self):
        return self.__logging_level

    @logging_level.setter
    def logging_level(self, level: Union[str, int]):
        if isinstance(level, str):
            level = getattr(logging, level.upper())
        lm.main_set_level(level)
        self.__logging_level = level

    # -- host threads (host-side IO/parse only) ------------------------------
    @property
    def n_threads(self):
        return self.__n_threads

    @n_threads.setter
    def n_threads(self, n: int):
        lm.main_debug(f"Setting n_threads to {n} (host-side IO/parsing only).")
        try:
            import cv2

            cv2.setNumThreads(n)
        except Exception:
            pass
        self.__n_threads = n

    # -- numeric policy -------------------------------------------------------
    @property
    def enable_x64(self) -> bool:
        return False

    @enable_x64.setter
    def enable_x64(self, on: bool):
        """Only False: float64 host data is narrowed to float32 where it
        enters the device, as in the JAX package with x64 off, and there is
        no global switch that would change that."""
        if on:
            raise ConfigurationError(
                "enable_x64=True has no counterpart in the PyTorch port: host float64 is narrowed to float32 "
                "where it enters the device, as the JAX package does with x64 off, and there is no global "
                "x64 mode to switch on."
            )

    @property
    def dtype(self):
        import torch

        return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}[self.precision]

    # -- device mesh ----------------------------------------------------------
    @property
    def mesh_shape(self) -> Optional[Tuple[int, ...]]:
        return self._mesh_shape

    @mesh_shape.setter
    def mesh_shape(self, shape: Optional[Tuple[int, ...]]):
        self._mesh_shape = tuple(shape) if shape is not None else None
        self._mesh = None

    @property
    def mesh_axis_names(self) -> Tuple[str, ...]:
        return self._mesh_axis_names

    @mesh_axis_names.setter
    def mesh_axis_names(self, names: Tuple[str, ...]):
        self._mesh_axis_names = tuple(names)
        self._mesh = None

    @property
    def mesh_device(self) -> str:
        """Where the ranks of `mesh` compute: "cuda" (one card a rank) or
        "cpu"."""
        return self._mesh_device

    @mesh_device.setter
    def mesh_device(self, device: str):
        self._mesh_device = str(device)
        self._mesh = None

    @property
    def mesh(self):
        """The global `DeviceMesh` the sharded paths use when given none.

        Defaults to every rank of the default process group on a single
        'data' axis; set `mesh_shape = (dp, mp)` for 2D meshes. Kept until
        the shape, the axis names, `mesh_device` or the process group
        change. A shape that does not cover the ranks raises `MeshError`."""
        import torch.distributed as dist

        key = lambda: dist.group.WORLD if dist.is_initialized() else None
        if self._mesh is None or self._mesh_key is not key():
            from .parallel.mesh import create_mesh

            self._mesh = create_mesh(self._mesh_shape, self._mesh_axis_names, device=self._mesh_device)
            self._mesh_key = key()
        return self._mesh

config = SpateoConfig()


class SpateoAdataKeyManager:
    """Every AnnData key the slice reads or writes."""

    ADATA_TYPE_KEY = "__type"
    ADATA_DEFAULT_TYPE = None
    ADATA_AGG_TYPE = "AGG"  # aggregated UMI counts on a pixel raster
    ADATA_UMI_TYPE = "UMI"  # obs x genes (canonical)

    UNS_PP_KEY = "pp"
    UNS_SPATIAL_KEY = "spatial"
    UNS_SPATIAL_BINSIZE_KEY = "binsize"
    UNS_SPATIAL_SCALE_KEY = "scale"
    UNS_SPATIAL_SCALE_UNIT_KEY = "scale_unit"
    UNS_SPATIAL_SEGMENTATION_KEY = "segmentation"
    UNS_SPATIAL_ALIGNMENT_KEY = "alignment"
    UNS_SPATIAL_QC_KEY = "qc"

    SPLICED_LAYER_KEY = "spliced"
    UNSPLICED_LAYER_KEY = "unspliced"
    STAIN_LAYER_KEY = "stain"
    LABELS_LAYER_KEY = "labels"
    MASK_SUFFIX = "mask"
    MARKERS_SUFFIX = "markers"
    DISTANCES_SUFFIX = "distances"
    BINS_SUFFIX = "bins"
    LABELS_SUFFIX = "labels"
    SCORES_SUFFIX = "scores"
    EXPANDED_SUFFIX = "expanded"
    AUGMENTED_SUFFIX = "augmented"
    SELECTION_SUFFIX = "selection"
    BOUNDARY_SUFFIX = "boundary"

    X_LAYER = "X"

    @staticmethod
    def gen_new_layer_key(layer_name: str, key: str, sep: str = "_") -> str:
        if layer_name == "":
            return key
        if layer_name[-1] == sep:
            return layer_name + key
        return sep.join([layer_name, key])

    @staticmethod
    def select_layer_data(
        adata: AnnData, layer: Optional[str], copy: bool = False, make_dense: bool = False
    ) -> Union[np.ndarray, sparse.spmatrix]:
        if layer is None:
            layer = SpateoAdataKeyManager.X_LAYER
        if layer == SpateoAdataKeyManager.X_LAYER:
            res_data = adata.X
        else:
            res_data = adata.layers[layer]
        if make_dense and sparse.issparse(res_data):
            return res_data.toarray()
        if copy:
            return res_data.copy()
        return res_data

    @staticmethod
    def set_layer_data(
        adata: AnnData,
        layer: str,
        vals: np.ndarray,
        var_indices: Optional[np.ndarray] = None,
        replace: bool = False,
    ):
        lm.main_info_insert_adata_layer(layer)
        vals = np.asarray(vals) if not sparse.issparse(vals) else vals
        if replace:
            adata.layers[layer] = vals
            return
        if var_indices is None:
            var_indices = slice(None)
        if layer == SpateoAdataKeyManager.X_LAYER:
            adata.X[:, var_indices] = vals
        elif layer in adata.layers:
            target = adata.layers[layer]
            if isinstance(target, np.ndarray) and not target.flags.writeable:
                target = target.copy()
                adata.layers[layer] = target
            target[:, var_indices] = vals
        else:
            adata.layers[layer] = vals

    @staticmethod
    def get_adata_type(adata: AnnData) -> str:
        return adata.uns[SpateoAdataKeyManager.ADATA_TYPE_KEY]

    @staticmethod
    def adata_is_type(adata: AnnData, t: str) -> bool:
        return SpateoAdataKeyManager.get_adata_type(adata) == t

    @staticmethod
    def check_adata_is_type(t: str, argname: str = "adata", optional: bool = False):
        def decorator(func):
            @functools.wraps(func)
            def wrapper(*args, **kwargs):
                unwrapped = inspect.unwrap(func)
                call_args = inspect.getcallargs(unwrapped, *args, **kwargs)
                adata = call_args[argname]
                if isinstance(adata, (list, tuple)):
                    passing = all(SpateoAdataKeyManager.adata_is_type(a, t) for a in adata)
                elif isinstance(adata, AnnData):
                    passing = SpateoAdataKeyManager.adata_is_type(adata, t)
                else:
                    passing = False
                if (not optional or adata is not None) and not passing:
                    if isinstance(adata, (list, tuple)):
                        raise ConfigurationError(
                            f"AnnDatas provided to `{argname}` must be of `{t}` type, but some are not."
                        )
                    elif isinstance(adata, AnnData):
                        raise ConfigurationError(
                            f"AnnData provided to `{argname}` must be of `{t}` type, but received "
                            f"`{SpateoAdataKeyManager.get_adata_type(adata)}` type."
                        )
                    raise ConfigurationError(f"`{argname}` is not an AnnData object, but {type(adata)}.")
                return func(*args, **kwargs)

            return wrapper

        return decorator

    @staticmethod
    def init_adata_type(adata: AnnData, t: Optional[str] = None):
        if t is None:
            t = SpateoAdataKeyManager.ADATA_DEFAULT_TYPE
        adata.uns[SpateoAdataKeyManager.ADATA_TYPE_KEY] = t

    @staticmethod
    def init_uns_pp_namespace(adata: AnnData):
        adata.uns.setdefault(SpateoAdataKeyManager.UNS_PP_KEY, {})

    @staticmethod
    def init_uns_spatial_namespace(adata: AnnData):
        adata.uns.setdefault(SpateoAdataKeyManager.UNS_SPATIAL_KEY, {})

    @staticmethod
    def set_uns_spatial_attribute(adata: AnnData, key: str, value: object):
        SpateoAdataKeyManager.init_uns_spatial_namespace(adata)
        adata.uns[SpateoAdataKeyManager.UNS_SPATIAL_KEY][key] = value

    @staticmethod
    def get_uns_spatial_attribute(adata: AnnData, key: str) -> object:
        return adata.uns[SpateoAdataKeyManager.UNS_SPATIAL_KEY][key]

    @staticmethod
    def has_uns_spatial_attribute(adata: AnnData, key: str) -> bool:
        return key in adata.uns.get(SpateoAdataKeyManager.UNS_SPATIAL_KEY, {})

    @staticmethod
    def get_agg_bounds(adata: AnnData) -> Tuple[int, int, int, int]:
        """(xmin, xmax, ymin, ymax) for AGG-type AnnDatas."""
        atype = SpateoAdataKeyManager.get_adata_type(adata)
        if atype != SpateoAdataKeyManager.ADATA_AGG_TYPE:
            raise ConfigurationError(f"AnnData has incorrect type: {atype}")
        return (
            int(adata.obs_names[0]),
            int(adata.obs_names[-1]),
            int(adata.var_names[0]),
            int(adata.var_names[-1]),
        )


SKM = SpateoAdataKeyManager


# ---------------------------------------------------------------------------
# matplotlib theming (parity: reference configuration.py:249-808 —
# shiftedColorMap, config_spateo_rcParams, set_figure_params, set_pub_style)
# ---------------------------------------------------------------------------


def shiftedColorMap(cmap, start: float = 0, midpoint: float = 0.5, stop: float = 1.0, name: str = "shiftedcmap"):
    """Re-center a colormap (parity: reference configuration.py:249). Useful
    for diverging data whose zero is not at the middle of [vmin, vmax]:
    set midpoint = 1 - vmax / (vmax + abs(vmin))."""
    import matplotlib as mpl
    import matplotlib.pyplot as plt
    import numpy as _np

    try:
        mpl.cm.ColormapRegistry.unregister(plt.colormaps, name=name)
    except Exception:
        pass
    cdict = {"red": [], "green": [], "blue": [], "alpha": []}
    reg_index = _np.linspace(start, stop, 257)
    shift_index = _np.hstack(
        [_np.linspace(0.0, midpoint, 128, endpoint=False), _np.linspace(midpoint, 1.0, 129, endpoint=True)]
    )
    for ri, si in zip(reg_index, shift_index):
        r, g, b, a = cmap(ri)
        cdict["red"].append((si, r, r))
        cdict["green"].append((si, g, g))
        cdict["blue"].append((si, b, b))
        cdict["alpha"].append((si, a, a))
    newcmap = mpl.colors.LinearSegmentedColormap(name, cdict)
    try:
        mpl.colormaps.register(cmap=newcmap)
    except ValueError:
        pass
    return newcmap


def config_spateo_rcParams(
    background: str = "white",
    prop_cycle=None,
    fontsize: int = 8,
    color_map=None,
    frameon=None,
) -> None:
    """Set matplotlib rcParams to the framework's ggplot/scanpy-style
    defaults (parity: reference configuration.py:505)."""
    import matplotlib as mpl
    from cycler import cycler
    from matplotlib import rcParams

    rcParams["patch.linewidth"] = 0.5
    rcParams["patch.facecolor"] = "348ABD"
    rcParams["patch.edgecolor"] = "EEEEEE"
    rcParams["patch.antialiased"] = True
    rcParams["font.size"] = 10.0
    rcParams["axes.facecolor"] = "E5E5E5" if background == "white" else background
    rcParams["axes.edgecolor"] = "white"
    rcParams["axes.linewidth"] = 1
    rcParams["axes.grid"] = True
    rcParams["axes.labelcolor"] = "555555"
    rcParams["axes.axisbelow"] = True
    rcParams["xtick.direction"] = "out"
    rcParams["ytick.direction"] = "out"
    rcParams["grid.color"] = "white"
    rcParams["grid.linestyle"] = "-"
    rcParams["figure.facecolor"] = background
    rcParams["figure.edgecolor"] = "0.5"
    rcParams["legend.fancybox"] = True
    rcParams["legend.fontsize"] = fontsize
    if prop_cycle is not None:
        rcParams["axes.prop_cycle"] = cycler(color=list(prop_cycle))
    if color_map is not None:
        rcParams["image.cmap"] = color_map if isinstance(color_map, str) else color_map.name
    if frameon is not None:
        rcParams["axes.spines.top"] = frameon
        rcParams["axes.spines.right"] = frameon


def set_figure_params(
    spateo: bool = True,
    background: str = "white",
    fontsize: int = 8,
    figsize: tuple = (6, 4),
    dpi: Optional[float] = None,
    dpi_save: Optional[int] = None,
    frameon: Optional[bool] = None,
    vector_friendly: bool = True,
    color_map: Optional[str] = None,
    format: str = "pdf",
    transparent: bool = False,
    ipython_format: str = "png2x",
    **kwargs,
) -> None:
    """Figure-level defaults (parity: reference configuration.py:637-700 —
    scanpy-style: None means LEAVE the current rcParam unchanged)."""
    from matplotlib import rcParams

    if spateo:
        config_spateo_rcParams(background=background, fontsize=fontsize, frameon=True if frameon is None else frameon)
    rcParams["figure.figsize"] = figsize
    if dpi is not None:
        rcParams["figure.dpi"] = dpi
    if dpi_save is not None:
        rcParams["savefig.dpi"] = dpi_save
    if frameon is not None:
        rcParams["axes.spines.top"] = frameon
        rcParams["axes.spines.right"] = frameon
    if color_map is not None:
        rcParams["image.cmap"] = color_map
    rcParams["savefig.format"] = format
    rcParams["savefig.transparent"] = transparent


def reset_rcParams() -> None:
    """Reset matplotlib rcParams to their defaults (parity: reference
    configuration.py:433)."""
    import matplotlib
    from matplotlib import rcParamsDefault

    matplotlib.rcParams.update(rcParamsDefault)


def spateo_theme(background: str = "white") -> None:
    """Light/dark figure theme (parity: reference configuration.py:462)."""
    import matplotlib

    if background == "black":
        matplotlib.rcParams.update(
            {
                "lines.color": "w",
                "patch.edgecolor": "w",
                "text.color": "w",
                "axes.facecolor": background,
                "axes.edgecolor": "white",
                "axes.labelcolor": "w",
                "xtick.color": "w",
                "ytick.color": "w",
                "figure.facecolor": background,
                "figure.edgecolor": background,
                "savefig.facecolor": background,
                "savefig.edgecolor": background,
            }
        )
    else:
        matplotlib.rcParams.update(
            {
                "lines.color": "k",
                "patch.edgecolor": "k",
                "text.color": "k",
                "axes.facecolor": background,
                "axes.edgecolor": "black",
                "axes.labelcolor": "k",
                "xtick.color": "k",
                "ytick.color": "k",
                "figure.facecolor": background,
                "figure.edgecolor": background,
                "savefig.facecolor": background,
                "savefig.edgecolor": background,
            }
        )


def set_pub_style_mpltex() -> None:
    """mpltex-style publication formatting (parity: reference
    configuration.py:748; the cairo-backend switch is dropped — Agg
    serializes identically in this environment)."""
    import matplotlib as mpl

    set_figure_params(background="white")
    mpl.rcParams.update(
        {
            "font.family": "sans-serif",
            "font.serif": ["Times", "Computer Modern Roman"],
            "font.sans-serif": ["Arial", "Helvetica", "sans-serif", "Computer Modern Sans serif"],
            "font.size": 9,
            "legend.fontsize": 9,
            "axes.labelsize": 9,
            "axes.titlesize": 9,
            "xtick.labelsize": 9,
            "ytick.labelsize": 9,
            "lines.linewidth": 1,
            "lines.markersize": 4,
            "xtick.direction": "in",
            "ytick.direction": "in",
        }
    )


def set_pub_style(scaler: float = 1) -> None:
    """Publication-figure styling (parity: reference configuration.py:720;
    the cairo-backend switch is dropped — Agg serializes identically)."""
    import matplotlib as mpl

    set_figure_params(background="white")
    mpl.rcParams.update(
        {
            "font.size": 6 * scaler,
            "legend.fontsize": 6 * scaler,
            "legend.handlelength": 0.5 * scaler,
            "axes.labelsize": 8 * scaler,
            "axes.titlesize": 8 * scaler,
            "xtick.labelsize": 8 * scaler,
            "ytick.labelsize": 8 * scaler,
            "axes.titlepad": 1 * scaler,
            "axes.labelpad": 1 * scaler,
        }
    )


# the named colormaps (parity: reference configuration.py:300-460), reachable
# here as in the JAX package; `colormaps` builds them on first access
_COLORMAP_NAMES = frozenset({
    "cyc_10", "cyc_20", "darkblue_cmap", "darkgreen_cmap", "darkpurple_cmap", "darkred_cmap",
    "div_blue_black_red_cmap", "div_blue_red_cmap", "fire_cmap", "glasbey_dark_cmap", "glasbey_white_cmap",
    "zebrafish_256", "zebrafish_colors",
})


def __getattr__(name):
    if name in _COLORMAP_NAMES:
        from . import colormaps

        return getattr(colormaps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
