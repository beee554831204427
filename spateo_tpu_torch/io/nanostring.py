"""Reference-named module alias (reference spateo/io/nanostring.py) — the
CosMx reader lives in the consolidated `platforms` module."""

from .platforms import (  # noqa: F401
    read_nanostring,
    read_nanostring_as_dataframe,
    stitch_images,
)
