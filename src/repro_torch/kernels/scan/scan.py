"""Wrapper of the hand-written CUDA selective-scan kernel (counterpart
of the Pallas kernel `repro.kernels.scan.selective_scan.selective_scan`).

`selective_scan_fused` takes the discretisation's inputs (``dt``, ``x``,
``b``, ``c``, ``a``) and an optional initial state, and returns
``(y, hT)``; ``da``/``dbx`` are formed inside the kernel.  ``hT`` is
written into ``out_state`` when one is given, which may be ``h0``
itself (the decode step writes the new state over the cache's).  On a CUDA
tensor it launches the kernel in `csrc/selective_scan.cu` on the
current stream or raises; there is no fallback.  On a CPU tensor it
computes the plain PyTorch version, `ref.selective_scan_fused_ref`.
A prompt runs the chunked kernel (parallel over time within each
channel), a decode step the sequential one; `use_chunked` is the
choice.  Each call on the card adds one to
``LAUNCHES["selective_scan"]`` (the TPU kernel's name), and nothing
else does.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.scan import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"

#: kernel launches since the last `reset_launches()`
LAUNCHES = {"selective_scan": 0}
#: the largest state size the chunked kernel takes (its shared memory)
CHUNKED_MAX_STATE = 32

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        for fn in (lib.selective_scan_sequential,
                   lib.selective_scan_chunked):
            fn.argtypes = [_P] * 8 + [_I] * 4 + [_P]
            fn.restype = _I
        lib._repro_bound = True
    return lib


def use_chunked(s: int, d: int, n: int, *addresses: int) -> bool:
    """Whether a call of S steps, d_inner d and state n, with dt, x and
    y at `addresses`, runs the chunked kernel: a prompt (S > 1) whose
    rows copy as 16-byte units of 4 channels (d a multiple of 4, every
    address 16-byte aligned) and whose state fits its shared memory
    (n <= CHUNKED_MAX_STATE).  Anything else, a decode step first, runs
    the sequential kernel."""
    return s > 1 and d % 4 == 0 and n <= CHUNKED_MAX_STATE and \
        all(p % 16 == 0 for p in addresses)


def selective_scan_fused(dt: torch.Tensor, x: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
                         h0: Optional[torch.Tensor] = None, *,
                         out_state: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt/x: (B, S, D); b/c: (B, S, N); a: (D, N); h0: (B, D, N) or
    None (zero state); all contiguous f32, N a power of two from 2 to
    64.  Returns (y (B, S, D), hT (B, D, N)), the contract of
    `ref.selective_scan_fused_ref`; hT is `out_state` (B, D, N) when
    given, written in place."""
    if dt.device.type == "cpu":
        y, h_t = ref.selective_scan_fused_ref(dt, x, b, c, a, h0)
        if out_state is None:
            return y, h_t
        return y, out_state.copy_(h_t)
    dev = dt.device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrapper needs CUDA tensors, got {dev}")
    bsz, s, d = dt.shape
    n = a.shape[-1]
    want = {"dt": (bsz, s, d), "x": (bsz, s, d), "b": (bsz, s, n),
            "c": (bsz, s, n), "a": (d, n), "h0": (bsz, d, n),
            "out_state": (bsz, d, n)}
    for name, t in (("dt", dt), ("x", x), ("b", b), ("c", c), ("a", a),
                    ("h0", h0), ("out_state", out_state)):
        if t is None:
            continue
        if tuple(t.shape) != want[name] or t.device != dev or \
                t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 tensor of shape "
                f"{want[name]} on {dev}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if n & (n - 1) or not 2 <= n <= 64:
        raise ValueError(f"state size {n} is not a power of two in 2..64")
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dev)
    h_t = out_state if out_state is not None else \
        torch.empty((bsz, d, n), dtype=torch.float32, device=dev)
    lib = _lib()
    # a decode step skips the address reads
    chunked = s > 1 and use_chunked(s, d, n, dt.data_ptr(), x.data_ptr(),
                                    y.data_ptr())
    launch = lib.selective_scan_chunked if chunked \
        else lib.selective_scan_sequential
    err = launch(
        dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_t.data_ptr(), bsz, s, d, n,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan: CUDA error {err} at launch")
    LAUNCHES["selective_scan"] += 1
    return y, h_t
