"""Compute kernels of the port: plain PyTorch, and the hand-written CUDA
kernels (`csrc/`) with their wrappers (`bp_cuda`)."""
