"""mixtral-8x7b: MoE 8 experts top-2, GQA, SWA.
[arXiv:2401.04088; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8e top-2.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,      # mixtral SWA (sub-quadratic path)
    rope_theta=1.0e6,
    microbatch_per_device=1,
)
