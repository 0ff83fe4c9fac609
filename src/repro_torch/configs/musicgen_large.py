"""musicgen-large: decoder-only transformer over EnCodec audio tokens.
[arXiv:2306.05284; hf]

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.  The EnCodec
frontend is a STUB: input_specs() supplies precomputed frame embeddings
added to the token embeddings (conditioning), per the task statement.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=1.0e4,
    frontend="encodec_stub",
    microbatch_per_device=4,
)
