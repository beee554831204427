"""Top-level helpers (counterpart of `spateo_tpu.utils`; reference
spateo/utils.py:6 `copy_adata`, :38 `remove_kwargs`). Host code, copied."""

from __future__ import annotations

from .logging import logger_manager as lm


def copy_adata(adata, logger=None):
    """Deep-copy an AnnData and log the (memory-intensive) copy
    (parity: reference utils.py:6)."""
    logger = logger or lm.get_main_logger()
    logger.info("Deep copying AnnData object and working on the new copy. "
                "Original AnnData object will not be modified.")
    return adata.copy()


def remove_kwargs(my_dict: dict, keys):
    """Pop `keys` out of a kwargs dict, returning the removed (key, value)
    pairs (parity: reference utils.py:38, minus its stray print)."""
    removed = []
    for key in keys:
        if key in my_dict:
            removed.append((key, my_dict.pop(key)))
    return removed
