"""zamba2-7b: hybrid Mamba-2 backbone + one shared attention block
applied periodically over concat(hidden, embedding).
[arXiv:2411.15242; unverified]

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    mamba_version=2,
    ssm_head_dim=64,
    shared_attn_every=6,      # 13 shared-block applications + 3 tail
    microbatch_per_device=2,
)
