"""Reference-named module alias (reference spateo/io/tenx.py) — the 10x
Visium reader lives in the consolidated `platforms` module."""

from .platforms import (  # noqa: F401
    read_10x,
    read_10x_as_anndata,
    read_10x_positions_as_dataframe,
)
