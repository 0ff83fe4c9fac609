"""h2o-danube-3-4b: dense llama+mistral mix with sliding-window
attention.  [arXiv:2401.16818; unverified]

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,      # mistral-style SWA (sub-quadratic path)
    rope_theta=1.0e4,
    microbatch_per_device=2,
)
