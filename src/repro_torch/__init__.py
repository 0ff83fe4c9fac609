"""PyTorch/CUDA port of the `repro` serving stack.

`repro_torch` mirrors `repro`'s module layout so each module's
counterpart is found at the same path.  It imports `torch`, never
`jax`, and nothing from `repro`: the JAX-free modules it needs
(configs, AGAS/LCO/parcels, tracing, radix index, worker roles) are
copies.  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; on the CPU the hand-written CUDA
kernels are replaced by their plain PyTorch versions in
`kernels/attention/ref.py`.
"""
