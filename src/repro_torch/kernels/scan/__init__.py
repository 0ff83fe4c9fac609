"""Selective scan: the CUDA kernel, its plain PyTorch versions, dispatch."""
