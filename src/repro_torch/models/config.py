"""Architecture + shape configuration system.

One `ArchConfig` per assigned architecture (src/repro/configs/<id>.py),
one `ShapeConfig` per assigned input shape.  Configs are frozen
dataclasses; `reduced()` derives the CPU smoke-test variant of the same
family (small widths/depths, same structural features).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention features
    rope_theta: float = 1.0e4
    rope_fraction: float = 1.0      # chatglm applies rotary to half dims
    sliding_window: int = 0         # 0 = full attention
    norm_eps: float = 1.0e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_group_size: int = 2048      # GShard dispatch group size (tokens)
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1
    ssm_head_dim: int = 64          # mamba2 head size
    # hybrid (zamba2): one shared attention block applied every k layers
    shared_attn_every: int = 0
    # VLM: every k-th layer is a cross-attention layer over patch embeds
    cross_attn_every: int = 0
    n_frontend_tokens: int = 0      # stub image/audio token count
    frontend: str = "none"          # none | vision_stub | encodec_stub
    dtype: str = "bfloat16"

    # training knobs (per-arch defaults; launcher may override)
    microbatch_per_device: int = 1
    remat: bool = True
    loss_chunk: int = 512           # chunked vocab projection (tokens)
    # remat granularity: checkpoint groups of k layers instead of every
    # layer — the saved-residual stack shrinks k-fold at the cost of
    # holding one group's recompute live (§Perf F5, command-r memory).
    remat_group_size: int = 1
    # gradient-accumulation buffer dtype (bf16 halves the buffer and
    # its traffic; set per arch where the f32 buffer breaks HBM)
    grad_accum_dtype: str = "float32"
    # force FSDP (params+grads+opt also sharded over "data") below the
    # default 20B auto-threshold (§Perf F9: falcon-mamba's 16-way-only
    # sharded f32 grad buffers)
    force_fsdp: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.n_heads and self.n_kv_heads and \
                self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid state or a sliding window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        n = 0
        embed = self.vocab_size * d
        n += embed if self.tie_embeddings else 2 * embed
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d + 2 * d
        mlp = 3 * d * ff + d
        if self.family == "ssm":
            di, st = self.d_inner, self.ssm_state
            dt_rank = max(d // 16, 1)
            blk = (d * 2 * di + di * self.ssm_conv +
                   di * (dt_rank + 2 * st) + dt_rank * di +
                   2 * di + di * d + d)
            n += L * blk
        elif self.family == "hybrid":
            di = self.d_inner
            nh = di // self.ssm_head_dim
            blk = (d * 2 * di + di * self.ssm_conv + 3 * nh +
                   di * d + d)
            n += L * blk
            n_shared = 1
            shared = (2 * d) * h * hd + 2 * (2 * d) * kv * hd + \
                h * hd * d + 3 * mlp // 3 + 2 * d
            n += n_shared * shared
        elif self.family == "moe":
            n += L * (attn + d * self.n_experts +
                      self.n_experts * 3 * d * ff + d)
        elif self.family == "vlm":
            n_cross = L // self.cross_attn_every if self.cross_attn_every \
                else 0
            n += (L - n_cross) * (attn + mlp) + \
                n_cross * (attn + mlp + 2 * d)
        else:
            n += L * (attn + mlp)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE top-k)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d + 2 * d
        n = (self.vocab_size * d) * (1 if self.tie_embeddings else 2)
        n += L * (attn + d * self.n_experts +
                  self.top_k * 3 * d * ff + d) + d
        return n

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant: same family/features, tiny sizes."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2))
            if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            sliding_window=32 if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4),
            moe_group_size=32,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16,
            shared_attn_every=2 if self.shared_attn_every else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            dtype="float32",
            loss_chunk=64,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shapes (system task statement).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k requires a sub-quadratic attention path (task statement)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "skip: pure full-attention arch at 512k context"
    return True, ""
