"""Reference-named module alias (reference spateo/io/slideseq.py) — the
Slide-seq reader lives in the consolidated `platforms` module."""

from .platforms import (  # noqa: F401
    read_slideseq,
    read_slideseq_as_dataframe,
    read_slideseq_beads_as_dataframe,
)
