"""Wrapper of the hand-written CUDA RK3 stencil kernel (counterpart of
the Pallas kernel `repro.kernels.stencil.stencil.stencil_rk3`).

`stencil_rk3` takes a batch of AMR blocks with their H-cell halos and
returns one fused three-stage SSP-RK3 step of each.  On a CUDA tensor
it launches the kernel in `csrc/stencil_rk3.cu` on the current stream
or raises; there is no fallback.  On a CPU tensor it computes the
plain PyTorch version, `ref.stencil_rk3_ref`.  Each launch adds one to
``LAUNCHES["stencil_rk3"]`` (the TPU kernel's name), and nothing else
does.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.amr.wave import H, NFIELDS
from repro_torch.kernels.stencil import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "stencil_rk3.cu"

#: kernel launches since the last `reset_launches()`
LAUNCHES = {"stencil_rk3": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        lib.stencil_rk3.argtypes = [_P] * 4 + [_I, _I, _F, _F, _I, _P]
        lib.stencil_rk3.restype = _I
        lib._repro_bound = True
    return lib


def stencil_rk3(u_ext: torch.Tensor, r_ext: torch.Tensor,
                flags: torch.Tensor, *, dr: float, dt: float,
                p: int) -> torch.Tensor:
    """u_ext (nb, 3, W) and r_ext (nb, W) contiguous float32, flags
    (nb, 2) contiguous int32 (left_phys, right_phys as 0/1), W > 2H, p
    an integer.  Returns (nb, 3, W - 2H), the contract of
    `ref.stencil_rk3_ref`; ``dr`` and ``dt`` go to the kernel as
    float32, as the Pallas kernel casts them."""
    if u_ext.device.type == "cpu":
        return ref.stencil_rk3_ref(u_ext, r_ext, flags, dr=dr, dt=dt, p=p)
    dev = u_ext.device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrapper needs CUDA tensors, got {dev}")
    if u_ext.dim() != 3:
        raise ValueError(f"u_ext must be (nb, 3, W), got "
                         f"{tuple(u_ext.shape)}")
    nb, _, w = u_ext.shape
    want = {"u_ext": ((nb, NFIELDS, w), torch.float32),
            "r_ext": ((nb, w), torch.float32),
            "flags": ((nb, 2), torch.int32)}
    for name, t in (("u_ext", u_ext), ("r_ext", r_ext), ("flags", flags)):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.device != dev or \
                t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {dev}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    if nb < 1 or w <= 2 * H:
        raise ValueError(f"need at least one block wider than 2H = {2 * H},"
                         f" got nb {nb}, W {w}")
    if int(p) != p:
        raise ValueError(f"p must be an integer, got {p!r}")
    out = torch.empty((nb, NFIELDS, w - 2 * H), dtype=torch.float32,
                      device=dev)
    err = _lib().stencil_rk3(
        u_ext.data_ptr(), r_ext.data_ptr(), flags.data_ptr(), out.data_ptr(),
        nb, w, float(dr), float(dt), int(p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil_rk3: CUDA error {err} at launch")
    LAUNCHES["stencil_rk3"] += 1
    return out
