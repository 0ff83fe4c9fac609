"""falcon-mamba-7b: attention-free Mamba-1 SSM.
[arXiv:2410.05355; unverified]

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16, expand=2.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    mamba_version=1,
    tie_embeddings=True,
    microbatch_per_device=2,
    # §Perf F9: 7.3B params shard only 16-way without FSDP, leaving
    # 1.8 GiB f32 grad buffers x2 in the accumulation scan; FSDP +
    # bf16 accumulation bring the train cell under HBM.
    force_fsdp=True,
    grad_accum_dtype="bfloat16",
)
