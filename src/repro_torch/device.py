"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with
no CUDA device and no explicit ``device="cpu"`` they raise, never
dropping to the CPU on their own.
"""

from __future__ import annotations

from typing import Union

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
