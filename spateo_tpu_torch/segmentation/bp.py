"""Belief propagation (public module; compute in spateo_tpu_torch.ops.bp)."""

from ..ops.bp import cell_marginals, create_neighbor_offsets, run_bp

__all__ = ["cell_marginals", "create_neighbor_offsets", "run_bp"]
