"""Serving on PyTorch: the paged KV cache and the chunked engine.

Import the engine from `repro_torch.serving.engine`; this package
file imports nothing, so the bookkeeping modules load without torch.
"""
