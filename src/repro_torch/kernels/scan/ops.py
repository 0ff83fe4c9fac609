"""Dispatch between the CUDA selective-scan kernel and its plain
version (counterpart of `repro.kernels.scan.ops`).

``use_kernel`` is the counterpart of the reference's ``use_pallas``
(`repro_torch.device.use_kernel_for`).  `models/ssm.py` makes that
choice itself, since its plain paths keep the reference's float order,
and calls the wrapper `scan.selective_scan_fused` directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import use_kernel_for
from repro_torch.kernels.scan import ref
from repro_torch.kernels.scan.scan import selective_scan_fused


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 scan from a state: (y (B, S, D), hT (B, D, N)) f32,
    the contract of `ref.selective_scan_fused_ref`."""
    if use_kernel_for(dt, use_kernel):
        def f32(t):
            return t.float().contiguous()
        return selective_scan_fused(
            f32(dt), f32(x), f32(b), f32(c), f32(a),
            None if h0 is None else f32(h0))
    return ref.selective_scan_fused_ref(dt, x, b, c, a, h0)
