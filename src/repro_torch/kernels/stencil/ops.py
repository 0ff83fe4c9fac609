"""Dispatch between the CUDA RK3 stencil kernel and its plain version
(counterpart of `repro.kernels.stencil.ops`).

`stencil_rk3_step` is what `amr/compiled.py` calls when the kernel
runs: it adapts the pool layout (slots, 3, g+2H) and the broadcast
masks to the kernel's (nb, ...) layout.  ``use_kernel`` is the
counterpart of the reference's ``use_pallas``
(`repro_torch.device.use_kernel_for`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import use_kernel_for
from repro_torch.kernels.stencil import ref, stencil


def stencil_rk3_step(pool_ext: torch.Tensor, r_ext: torch.Tensor,
                     left_phys: torch.Tensor, right_phys: torch.Tensor, *,
                     dr: float, dt: float, p: int,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """(slots, 3, g+2H) -> (slots, 3, g); masks broadcast (slots, 1, 1).
    `r_ext` may be a strided slice: the kernel gets a contiguous copy."""
    nb = pool_ext.shape[0]
    flags = torch.stack([left_phys.reshape(nb), right_phys.reshape(nb)],
                        dim=-1).to(torch.int32)
    if use_kernel_for(pool_ext, use_kernel):
        return stencil.stencil_rk3(pool_ext.contiguous(),
                                   r_ext.contiguous(), flags, dr=dr, dt=dt,
                                   p=p)
    return ref.stencil_rk3_ref(pool_ext, r_ext, flags, dr=dr, dt=dt, p=p)
