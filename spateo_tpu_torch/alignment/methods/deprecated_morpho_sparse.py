"""Back-compat module path for the reference's sparse deprecated solver
(reference spateo/alignment/methods/deprecated_morpho_sparse.py:147
`BA_align_sparse`); see `deprecated_morpho` for the shim rationale."""

from .deprecated_morpho import BA_align_sparse

__all__ = ["BA_align_sparse"]
