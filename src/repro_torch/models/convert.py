"""Carry the reference's parameters into the port.

`params_from_numpy` takes the pytree `repro.models.transformer.
init_params` returns, converted leaf by leaf to numpy by the caller
(this module imports no JAX), and returns the port's parameter dict:
the same nested names, the same stacked-layer layout
(`transformer.py:164-214` of the reference), as torch tensors on
`device`.  Leaves take the config's dtype, except the Mamba-1 leaves
the reference keeps in f32 whatever the config says (`F32_LEAVES`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import PORTED_FAMILIES

#: leaves that stay f32 whatever the config's dtype (`ssm.py:76-78` of
#: the reference keeps them so: the decay and skip terms)
F32_LEAVES = ("layers/ssm/dt_bias", "layers/ssm/a_log", "layers/ssm/d_skip")


def _expected_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    d, L, ff = cfg.d_model, cfg.n_layers, cfg.d_ff
    h, kv, hd, V = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.vocab_size
    shapes = {
        "embed/embedding": (V, d),
        "final_norm/scale": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["out_embed/embedding"] = (V, d)
    if cfg.family == "ssm":
        di, st = cfg.d_inner, cfg.ssm_state
        dt_rank = max(d // 16, 1)
        shapes.update({
            "layers/norm/scale": (L, d),
            "layers/ssm/in_proj": (L, d, 2 * di),
            "layers/ssm/conv_w": (L, di, cfg.ssm_conv),
            "layers/ssm/x_proj": (L, di, dt_rank + 2 * st),
            "layers/ssm/dt_proj": (L, dt_rank, di),
            "layers/ssm/dt_bias": (L, di),
            "layers/ssm/a_log": (L, di, st),
            "layers/ssm/d_skip": (L, di),
            "layers/ssm/out_proj": (L, di, d),
        })
        return shapes
    shapes.update({
        "layers/attn_norm/scale": (L, d),
        "layers/attn/wq": (L, d, h * hd),
        "layers/attn/wk": (L, d, kv * hd),
        "layers/attn/wv": (L, d, kv * hd),
        "layers/attn/wo": (L, h * hd, d),
        "layers/mlp_norm/scale": (L, d),
        "layers/mlp/wi": (L, d, ff),
        "layers/mlp/wg": (L, d, ff),
        "layers/mlp/wdown": (L, ff, d),
    })
    return shapes


def _to_tensor(arr: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Reference pytree of numpy leaves -> the port's parameters, in the
    config's dtype (`F32_LEAVES` in f32), checked leaf by leaf against
    the config's shapes."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.family!r} parameters are not ported yet")
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    want = _expected_shapes(cfg)

    seen = set()

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if path not in want:
            raise KeyError(f"unexpected parameter {path!r}")
        shape = tuple(np.shape(node))
        if shape != want[path]:
            raise ValueError(
                f"{path}: shape {shape}, config wants {want[path]}")
        seen.add(path)
        return _to_tensor(node, torch.float32 if path in F32_LEAVES
                          else dt, dev)

    out = walk(tree, "")
    missing = set(want) - seen
    if missing:
        raise KeyError(f"missing parameters {sorted(missing)}")
    return out
