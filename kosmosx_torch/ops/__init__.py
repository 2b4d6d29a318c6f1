"""Kernels (CUDA, with their plain PyTorch versions) and tensor ops."""
