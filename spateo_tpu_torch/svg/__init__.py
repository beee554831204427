"""SVG layer (`stt.svg`): only the multiple-testing helper MuSIC's Moran's I
selection needs. The OT-distance SVG detection of `spateo_tpu.svg` is not
ported yet (ROADMAP Queue 1 item 10)."""

from .utils import multipletests_bh
