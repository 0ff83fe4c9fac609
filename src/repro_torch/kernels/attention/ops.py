"""Dispatch between the CUDA kernels and their plain versions
(counterpart of `repro.kernels.attention.ops`), in the reference's
(B, S, H, D) layout.

``use_kernel`` is the counterpart of the reference's ``use_pallas``
(`repro_torch.device.use_kernel_for`): ``None``, the default on every
model path, runs the kernel on a CUDA tensor and the plain version on
a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import use_kernel_for
from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention.flash import flash_attention_bshd
from repro_torch.kernels.attention.paged import (paged_attention_bhd,
                                                 paged_prefill_attention_btd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, window: int = 0,
                    q_offset: int = 0,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) (GQA without repetition);
    same contract as `ref.flash_attention_ref`."""
    if use_kernel_for(q, use_kernel):
        return flash_attention_bshd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window, q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    positions: torch.Tensor, *, window: int = 0,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q: (B, 1, H, D); same contract as `ref.paged_attention_ref`."""
    if use_kernel_for(q, use_kernel):
        return paged_attention_bhd(q[:, 0].contiguous(), k_pages, v_pages,
                                   block_tables, positions,
                                   window=window)[:, None]
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   positions, window=window)


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor,
                            block_tables: torch.Tensor,
                            start: torch.Tensor, *, window: int = 0,
                            use_kernel: Optional[bool] = None
                            ) -> torch.Tensor:
    """q: (B, T, H, D); same contract as
    `ref.paged_prefill_attention_ref`."""
    if use_kernel_for(q, use_kernel):
        return paged_prefill_attention_btd(q.contiguous(), k_pages,
                                           v_pages, block_tables, start,
                                           window=window)
    return ref.paged_prefill_attention_ref(q, k_pages, v_pages,
                                           block_tables, start,
                                           window=window)
