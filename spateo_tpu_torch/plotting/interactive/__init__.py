"""Interactive plotting (counterpart of `spateo_tpu.plotting.interactive`;
reference spateo/plotting/interactive/__init__.py)."""

from .agg import cellbin_select, contours, select_polygon
