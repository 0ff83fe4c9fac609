"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with
no CUDA device and no explicit ``device="cpu"`` they raise, never
dropping to the CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of an `ArchConfig.dtype` string."""
    try:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded generator on the (resolved) device."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def check_device(params, device: DeviceLike) -> torch.device:
    """Resolve `device` and check the parameters live there."""
    dev = resolve_device(device)
    have = params["embed"]["embedding"].device
    if have.type != dev.type:
        raise ValueError(
            f"parameters live on {have} but the engine was asked to run "
            f"on {dev}")
    return have


def use_kernel_for(t: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """Whether a call on `t` runs a CUDA kernel, from ``use_kernel`` (the
    counterpart of the reference's ``use_pallas``): ``None`` runs the
    kernel on a CUDA tensor and the plain version on a CPU tensor;
    ``True`` runs the kernel and raises on a CPU tensor; ``False`` runs
    the plain version (tests and `chip_smoke.py` only)."""
    if use_kernel is None:
        return t.device.type == "cuda"
    if use_kernel and t.device.type != "cuda":
        raise ValueError(
            f"use_kernel=True needs CUDA tensors, got {t.device}")
    return bool(use_kernel)
