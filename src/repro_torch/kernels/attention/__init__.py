"""Paged attention: CUDA kernels, their plain PyTorch versions, dispatch."""
