"""chatglm3-6b: dense, 2d partial RoPE, extreme GQA (kv=2).
[arXiv:2406.12793; hf]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,        # chatglm rotary on half the head dims
    rope_theta=1.0e4,
    microbatch_per_device=2,
)
