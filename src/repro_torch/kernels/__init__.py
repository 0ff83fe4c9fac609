"""Hand-written CUDA kernels for Hopper and the build helper."""
