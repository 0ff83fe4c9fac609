"""Plain PyTorch versions of the selective-scan kernel (counterpart of
`repro.kernels.scan.ref`).

* `selective_scan_ref` is the torch twin of the reference's oracle: the
  Mamba-1 recurrence over precomputed ``da``/``dbx`` from a zero state.
* `selective_scan_fused_ref` is what `csrc/selective_scan.cu` computes
  on the serving path: the discretisation formed per time step from
  ``dt``, ``x``, ``b`` and ``a`` (nothing of shape (B, S, D, N) is
  built), from a given initial state, returning the final state too.

Both walk time sequentially.  They are the oracle the kernel is held
against on the card; the model's CPU path runs `models/ssm.py`'s own
plain versions, which mirror the reference's float order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan_ref(da: torch.Tensor, dbx: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """da/dbx: (B, S, D, N); c: (B, S, N) -> y: (B, S, D) f32, with
    ``h_t = da_t * h_{t-1} + dbx_t``, ``y_t = <h_t, c_t>`` and h0 = 0."""
    b, s, d, n = da.shape
    h = torch.zeros((b, d, n), dtype=torch.float32, device=da.device)
    ys = []
    for t in range(s):
        h = da[:, t] * h + dbx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1)


def selective_scan_fused_ref(dt: torch.Tensor, x: torch.Tensor,
                             b: torch.Tensor, c: torch.Tensor,
                             a: torch.Tensor,
                             h0: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt/x: (B, S, D); b/c: (B, S, N); a: (D, N); h0: (B, D, N) or
    None (zeros).  All f32.  Per time step ``da = exp(dt * a)``,
    ``dbx = (dt * x) b``, ``h = da * h + dbx``, ``y = <h, c>``.
    Returns (y (B, S, D), hT (B, D, N))."""
    bsz, s, d = dt.shape
    n = a.shape[-1]
    h = torch.zeros((bsz, d, n), dtype=torch.float32, device=dt.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(s):
        dt_t = dt[:, t, :, None]
        h = torch.exp(dt_t * a) * h + \
            (dt_t * x[:, t, :, None]) * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros((bsz, 0, d))
    return y, h
