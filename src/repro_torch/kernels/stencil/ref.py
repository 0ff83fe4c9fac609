"""Plain PyTorch version of the RK3 stencil kernel (counterpart of
`repro.kernels.stencil.ref`): the batched `amr.wave.fused_rk3_block`.

It is the oracle `csrc/stencil_rk3.cu` is held against on the card and
what the kernel's wrapper computes for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.amr.wave import fused_rk3_block


def stencil_rk3_ref(u_ext: torch.Tensor, r_ext: torch.Tensor,
                    flags: torch.Tensor, *, dr: float, dt: float,
                    p: int) -> torch.Tensor:
    """u_ext (nb, 3, W), r_ext (nb, W), flags (nb, 2) int32 (left_phys,
    right_phys as 0/1) -> (nb, 3, W - 2H): one fused RK3 step per block."""
    return fused_rk3_block(u_ext, r_ext, dr, dt, p,
                           left_phys=flags[:, 0, None, None] > 0,
                           right_phys=flags[:, 1, None, None] > 0)
