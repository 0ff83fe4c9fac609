"""Assigned-architecture registry.

10 LM archs (task statement, public literature) + the paper's AMR
problem.  `get(name)` returns the full ArchConfig; `get_reduced(name)`
the CPU smoke variant; `ARCHS` lists all ids.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm
from repro_torch.configs.command_r_plus_104b import CONFIG as _commandr
from repro_torch.configs.yi_6b import CONFIG as _yi
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon
from repro_torch.configs.zamba2_7b import CONFIG as _zamba
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.phi35_moe_42b import CONFIG as _phi
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.llama32_vision_90b import CONFIG as _llamav

_REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in [
        _danube, _chatglm, _commandr, _yi, _falcon, _zamba, _mixtral,
        _phi, _musicgen, _llamav,
    ]
}

ARCHS = sorted(_REGISTRY)


def get(name: str) -> ArchConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {ARCHS}") from None


def get_reduced(name: str) -> ArchConfig:
    return get(name).reduced()


__all__ = ["ARCHS", "get", "get_reduced", "SHAPES", "ArchConfig",
           "ShapeConfig"]
