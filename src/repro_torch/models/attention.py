"""Attention helpers on torch tensors (counterpart of
`repro.models.attention`): RoPE, the GQA projections and KV head
repetition.  The whole-sequence attention paths (`flash_jnp`,
`attention`, `decode_attention`) come with the whole-prompt engines;
the paged paths live in `kernels/attention`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Params


def rope_angles(positions: torch.Tensor, rot_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions...) -> cos/sin of shape (..., rot_dim/2), in f32."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the first `fraction` of head dims.

    Rotates INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])`` — the
    reference's convention, not the rotate-half one.  x: (..., S, H, D);
    cos/sin: (S, rot/2) or anything broadcasting to (..., S, rot/2).
    """
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    xr = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([xr, xp], dim=-1) if rot < d else xr


def qkv(params: Params, x: torch.Tensor, cfg: ArchConfig
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*n_rep, D), head h reading KV head
    h // n_rep."""
    if n_rep == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, d) \
        .reshape(b, s, kv * n_rep, d)
