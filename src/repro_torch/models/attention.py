"""Attention on torch tensors (counterpart of `repro.models.attention`):
RoPE, the GQA projections, KV head repetition, the chunked
online-softmax attention of whole-sequence prefill (`flash_jnp`, the
plain twin of the CUDA flash kernel), `attention()` that dispatches
between the two, and one-token `decode_attention` over a dense cache.
The paged paths live in `kernels/attention`.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# Chunked flash attention (plain twin of the CUDA flash kernel)
# ---------------------------------------------------------------------------

def flash_jnp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              chunk_q: int = 512, chunk_k: int = 512) -> torch.Tensor:
    """Online-softmax attention, O(S * chunk) memory; the reference's
    `flash_jnp` step for step (its name kept so the two read side by
    side).

    q: (B, Sq, H, D); k/v: (B, Sk, H, D) (kv already head-repeated).
    window > 0 restricts to keys within `window` positions before the
    query; q_offset is the absolute position of q[0] relative to k[0].
    Scores, statistics and the accumulator are f32; the softmax
    weights are rounded to the value dtype before the PV product.
    A row with no visible key returns 0.  The chunks are the
    reference's (``S // max(S // chunk, 1)`` wide); where that width
    does not divide S, which the reference refuses, the last chunk is
    the shorter remainder.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    cq = sq // max(sq // chunk_q, 1)
    ck = sk // max(sk // chunk_k, 1)
    scale = d ** -0.5
    dev = q.device
    qs = q.permute(0, 2, 1, 3)                            # b,h,sq,d
    ks_ = k.permute(0, 2, 1, 3)
    vs = v.permute(0, 2, 1, 3)
    outs = []
    for q0 in range(0, sq, cq):
        qb = qs[:, :, q0:q0 + cq].float()
        nq = qb.shape[2]
        q_pos = q_offset + q0 + torch.arange(nq, device=dev)
        m = torch.full((b, h, nq), float("-inf"), device=dev)
        l = torch.zeros((b, h, nq), device=dev)
        acc = torch.zeros((b, h, nq, d), device=dev)
        for k0 in range(0, sk, ck):
            kb = ks_[:, :, k0:k0 + ck].float()
            vb = vs[:, :, k0:k0 + ck]
            k_pos = k0 + torch.arange(kb.shape[2], device=dev)
            s_ = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
            mask = torch.ones((nq, kb.shape[2]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s_ = s_.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, s_.amax(dim=-1))
            # guard fully-masked rows (all -inf)
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp(s_ - m_safe[..., None])
            p = p.masked_fill(~mask, 0.0)
            corr = torch.exp(torch.where(torch.isinf(m), 0.0, m) - m_safe)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None])
                    .to(q.dtype))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)     # b,sq,h,d


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: ArchConfig, causal: bool = True, q_offset: int = 0,
              use_kernel: Optional[bool] = None, chunk_q: int = 512,
              chunk_k: int = 512) -> torch.Tensor:
    """Whole-sequence prefill attention with GQA and the config's
    sliding window.  q: (B, Sq, H, D); k/v: (B, Sk, KV, D).

    The CUDA flash kernel (a CUDA tensor, or ``use_kernel=True``)
    takes K/V without head repetition and serves each KV head's query
    group in one block; the plain path repeats K/V and runs
    `flash_jnp`, as the reference's ``use_pallas=False`` path does.
    """
    from repro_torch.kernels.attention import ops
    if ops.use_kernel_for(q, use_kernel):
        return ops.flash_attention(q, k, v, causal=causal,
                                   window=cfg.sliding_window,
                                   q_offset=q_offset, use_kernel=True)
    n_rep = cfg.n_heads // max(cfg.n_kv_heads, 1)
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    return flash_jnp(q, k, v, causal=causal, window=cfg.sliding_window,
                     q_offset=q_offset, chunk_q=chunk_q, chunk_k=chunk_k)


# ---------------------------------------------------------------------------
# Decode (one new token against a dense cache)
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, S, KV, D); cache_len: () number of
    valid cache slots.  Masked full attention over the cache (plain
    torch: the reference has no kernel here either).  SWA caches are
    ring buffers of the window's size, so validity is a slot count."""
    n_rep = cfg.n_heads // max(cfg.n_kv_heads, 1)
    k = repeat_kv(k_cache, n_rep)
    v = repeat_kv(v_cache, n_rep)
    scale = cfg.head_dim ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(~(pos < cache_len)[None, None, None, :],
                      float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.to(q.dtype)
