"""Tensor ops: plain PyTorch functions and the CUDA kernel wrappers."""
