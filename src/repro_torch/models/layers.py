"""Shared building blocks, on torch tensors (counterpart of
`repro.models.layers`).

Parameters are nested dicts of tensors with the reference's names and
layouts:

    wq,wk,wv : (d_model, heads*head_dim)
    wo       : (heads*head_dim, d_model)
    wi,wg    : (d_model, d_ff)
    wdown    : (d_ff, d_model)
    embed    : (vocab, d_model)

Computation dtype follows the input; norms and softmax accumulate in
f32.  The mesh-constraint helpers of the reference have no
counterpart: the port runs on one device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _init_dense(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Glorot-normal weight, drawn in f32 and cast (as the reference)."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def rmsnorm_init(d: int, dtype: torch.dtype,
                 device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm with f32 statistics over an input-dtype data path: the
    sum of squares accumulates in f32, the reciprocal is cast back to
    the input dtype before it scales `x` (reference
    `layers.rmsnorm`)."""
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> Params:
    emb = torch.randn((vocab, d), generator=gen, device=gen.device,
                      dtype=torch.float32) * 0.02
    return {"embedding": emb.to(dtype)}


def embed_lookup(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, params["embedding"])


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    return h @ params["wdown"]
