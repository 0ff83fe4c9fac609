"""Plain PyTorch versions of the attention kernels (counterpart of
`repro.kernels.attention.ref`): flash attention as a chunked online
softmax (the function of `csrc/flash_attention.cu`), and the
gather-based decode and chunked prefill attention of
`csrc/paged_attention.cu`.  They are the CPU path of the port and the
oracle the kernels are held against on the card."""

from __future__ import annotations

import torch

from repro_torch.models.attention import flash_jnp, repeat_kv


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, *, causal: bool = True,
                        window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D).  Returns (B, Sq, H, D)."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    return flash_jnp(q, k, v, causal=causal, window=window,
                     q_offset=q_offset,
                     chunk_q=min(128, q.shape[1]),
                     chunk_k=min(128, k.shape[1]))


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                  b: int, kvh: int, d: int) -> torch.Tensor:
    """Resolve block-table rows to page contents: (B, P*ps, KV, D).

    Flat pool: pages (N, ps, KV, D), rows index axis 0 directly.
    Sharded pool: pages (S, R, ps, KV, D) — one AGAS locality per
    leading-axis shard — and each row encodes ``locality * R + slot``,
    so the gather decodes (locality, slot).
    """
    tables = block_tables.long()
    if pages.ndim == 5:
        rps = pages.shape[1]
        out = pages[tables // rps, tables % rps]
    else:
        out = pages[tables]
    return out.reshape(b, -1, kvh, d)


def _attend(q: torch.Tensor, k_pages: torch.Tensor,
            v_pages: torch.Tensor, block_tables: torch.Tensor,
            qpos: torch.Tensor, window: int) -> torch.Tensor:
    """Masked softmax attention of q (B, T, H, D) at absolute
    positions qpos (B, T) over the gathered pages."""
    b, t, h, d = q.shape
    kvh = k_pages.shape[-2]
    k = _gather_pages(k_pages, block_tables, b, kvh, d)
    v = _gather_pages(v_pages, block_tables, b, kvh, d)
    n_rep = h // kvh
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    j = torch.arange(k.shape[1], device=q.device)
    mask = j[None, None, :] <= qpos[:, :, None]            # (B, T, K)
    if window > 0:
        mask &= qpos[:, :, None] - j[None, None, :] < window
    s = s.masked_fill(~mask[:, None, :, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor,
                        block_tables: torch.Tensor,
                        positions: torch.Tensor, *,
                        window: int = 0) -> torch.Tensor:
    """Gather-based paged decode attention (one layer, one new token).

    q:            (B, 1, H, D) query for the token being decoded.
    k/v_pages:    (N, ps, KV, D) page pool rows (N includes the null
                  row idle slots point at), or (S, R, ps, KV, D) for a
                  locality-sharded pool (see _gather_pages).
    block_tables: (B, P) int32 physical page rows per slot.
    positions:    (B,) int32 absolute position of the new token per
                  slot; its K/V must already be written.
    window > 0 restricts each slot to its trailing `window` positions
    (an absolute-position mask: pages are never trimmed).
    """
    return _attend(q, k_pages, v_pages, block_tables,
                   positions.long()[:, None], window)


def paged_prefill_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                start: torch.Tensor, *,
                                window: int = 0) -> torch.Tensor:
    """Gather-based chunked-prefill attention (one layer, T chunk
    tokens at absolute positions start..start+T-1).

    q: (B, T, H, D); pages and tables as in `paged_attention_ref`;
    start: (B,) int32 absolute position of q[:, 0].  Query t attends
    key positions <= start + t (causal across earlier chunks and
    within this one), and within the window when set.
    """
    t = q.shape[1]
    qpos = start.long()[:, None] + torch.arange(t, device=q.device)[None]
    return _attend(q, k_pages, v_pages, block_tables, qpos, window)
