"""Wrapper of the hand-written CUDA flash-attention kernel (counterpart
of the Pallas kernel `repro.kernels.attention.flash.flash_attention_bhsd`).

`flash_attention_bshd` takes the models' (B, S, H, D) / (B, S, KV, D)
layout and hands it to the kernel in place, with no transpose and no
head repetition (the Pallas entry's (BH, S, D) layout is the same
kernel under other strides).  On a CUDA tensor it launches the kernel
in `csrc/flash_attention.cu` on the current stream or raises; there is
no fallback.  On a CPU tensor it computes the plain PyTorch version,
`ref.flash_attention_ref`.  Each launch adds one to
``LAUNCHES["flash_attention_bhsd"]`` (the TPU kernel's name), and
nothing else does.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: kernel launches since the last `reset_launches()`
LAUNCHES = {"flash_attention_bhsd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        lib.flash_attention.argtypes = ([_P] * 4 + [_I] * 6 + [_L] * 6 +
                                        [_I] * 3 + [ctypes.c_float, _I, _P])
        lib.flash_attention.restype = _I
        lib._repro_bound = True
    return lib


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool = True,
                         window: int = 0, q_offset: int = 0
                         ) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D), GQA without repetition
    (query head h reads KV head h // (H / KV)).  Returns (B, Sq, H, D).
    Same contract as `ref.flash_attention_ref`."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, q_offset=q_offset)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrapper needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4 or t.device != dev or t.dtype != q.dtype or \
                not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 4-d {q.dtype} tensor on {dev}")
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[-1] != d or \
            h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    out = torch.empty_like(q)
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kvh, d, sq * h * d, h * d, d, sk * kvh * d, kvh * d,
        d, int(bool(causal)), int(window), int(q_offset), d ** -0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bhsd: CUDA error {err} at "
                           "launch")
    LAUNCHES["flash_attention_bhsd"] += 1
    return out
