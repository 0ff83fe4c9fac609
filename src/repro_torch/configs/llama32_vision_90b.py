"""llama-3.2-vision-90b: dense decoder with gated cross-attention
image layers every 5th layer.  [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The vision
tower is a STUB: input_specs() supplies precomputed patch embeddings
(n=4096, d=1280) that the model projects and cross-attends to.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5.0e5,
    cross_attn_every=5,       # 20 cross-attention layers
    n_frontend_tokens=4096,
    frontend="vision_stub",
    microbatch_per_device=1,
)
