"""command-r-plus-104b: dense 104B, GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=7.5e4,
    tie_embeddings=True,      # command-r ties input/output embeddings
    microbatch_per_device=1,
    # §Perf F5/F6: per-layer remat stacks + an f32 accumulation buffer
    # overflow 16 GiB at 104B; group remat 8x and accumulate in bf16.
    remat_group_size=8,
    grad_accum_dtype="bfloat16",
)
