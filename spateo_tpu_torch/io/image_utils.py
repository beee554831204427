"""Reference-named module alias (reference spateo/io/image_utils.py) — the
stain-image layer machinery lives in `image`."""

from .image import add_image_layer, read_image  # noqa: F401
