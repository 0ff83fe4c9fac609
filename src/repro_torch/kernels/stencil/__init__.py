"""RK3 stencil: the CUDA kernel, its plain PyTorch version, dispatch."""
