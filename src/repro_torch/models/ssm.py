"""State-space blocks on torch tensors: the Mamba-1 half of
`repro.models.ssm` (falcon-mamba).  Mamba-2/SSD (zamba2) is not ported
yet (ROADMAP Queue A item 10).

The reference's execution paths, with its names:

* `mamba1_scan_ref` — the sequential recurrence: the oracle, and the
  decode path (one step from the carried state).
* `mamba1_chunked` — the prefill path: sequential over chunks, an
  associative scan inside each chunk, the discretisation formed per
  chunk so nothing of shape (B, S, d_inner, state) is built.

On the card both run their scan as ONE launch of the hand-written
selective-scan kernel (`kernels/scan`), over the whole sequence from
the carried state: per layer one launch per prefill and one per decode
step.  On the CPU (and with ``use_kernel=False``) they run the plain
versions, in the reference's float order.  Projections, the causal
conv, SiLU, the ``d_skip`` term and the ``silu(z)`` gate stay plain
torch, as in the reference.

Layer parameters come STACKED on a leading layer axis from
`mamba1_init`; the model indexes one layer at a time.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype, use_kernel_for
from repro_torch.kernels.scan import scan
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Params, _init_dense


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, D), w: (D, K).

    Returns (y, new_state) where state is the trailing K-1 inputs.
    """
    b, s, d = x.shape
    k = w.shape[1]
    if state is None:
        state = torch.zeros((b, k - 1, d), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xp[:, i:i + s, :] * w[:, i]
    new_state = xp[:, s:, :] if k > 1 else state
    return y, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba-1 (diagonal per-channel decay; falcon-mamba-7b)
# ---------------------------------------------------------------------------

def mamba1_init(gen: torch.Generator, cfg: ArchConfig,
                n_layers: int) -> Params:
    """`n_layers` Mamba-1 blocks stacked on a leading axis, drawn from
    `gen` on its device one layer at a time.  ``dt_bias``, ``a_log``
    and ``d_skip`` are f32 whatever the config's dtype (as in the
    reference); the rest is in the config's dtype."""
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(d // 16, 1)
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    L = n_layers

    def stacked(d_in, d_out):
        out = torch.empty((L, d_in, d_out), dtype=dt, device=dev)
        for i in range(L):
            out[i] = _init_dense(gen, d_in, d_out, dt)
        return out

    conv = torch.empty((L, di, cfg.ssm_conv), dtype=dt, device=dev)
    for i in range(L):
        conv[i] = (torch.randn((di, cfg.ssm_conv), generator=gen,
                               device=dev, dtype=torch.float32) * 0.2
                   ).to(dt)
    a = torch.arange(1, st + 1, dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": stacked(d, 2 * di),
        "conv_w": conv,
        "x_proj": stacked(di, dt_rank + 2 * st),
        "dt_proj": stacked(dt_rank, di),
        "dt_bias": torch.zeros((L, di), **f32),
        "a_log": torch.log(a).expand(L, di, st).contiguous(),
        "d_skip": torch.ones((L, di), **f32),
        "out_proj": stacked(di, d),
    }


def _mamba1_pre(params: Params, x: torch.Tensor, cfg: ArchConfig,
                conv_state: Optional[torch.Tensor]):
    """Projections + conv + the discretisation's inputs: (xc, z, dt,
    b_in, c_in, a, new_conv) with dt (B,S,di), b_in/c_in (B,S,st) and
    a = -exp(a_log) (di, st), all f32 but xc/z."""
    st = cfg.ssm_state
    dt_rank = max(cfg.d_model // 16, 1)
    xz = x @ params["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)
    xc, new_conv = causal_conv1d(xin, params["conv_w"], conv_state)
    xc = F.silu(xc)
    proj = xc @ params["x_proj"]
    dt_in = proj[..., :dt_rank]
    b_in = proj[..., dt_rank:dt_rank + st].float()
    c_in = proj[..., dt_rank + st:].float()
    dt = _softplus((dt_in @ params["dt_proj"]).float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    return xc, z, dt, b_in, c_in, a, new_conv


def _mamba1_inputs(params: Params, x: torch.Tensor, cfg: ArchConfig,
                   conv_state: Optional[torch.Tensor]):
    """Shared pre-scan computation: projections + conv +
    discretisation, with da/dbx (B, S, di, st) built in full (the
    sequential oracle's inputs)."""
    xc, z, dt, b_in, c_in, a, new_conv = _mamba1_pre(params, x, cfg,
                                                     conv_state)
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * xc.float())[..., None] * b_in[..., None, :]
    return xc, z, da, dbx, c_in, new_conv


def _mamba1_out(params: Params, x: torch.Tensor, ys: torch.Tensor,
                xc: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = ys + params["d_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"]


def _zero_state(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return torch.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state),
                       dtype=torch.float32, device=x.device)


def _mamba1_kernel(params: Params, x: torch.Tensor, cfg: ArchConfig,
                   ssm_state: Optional[torch.Tensor],
                   conv_state: Optional[torch.Tensor],
                   out_state: Optional[torch.Tensor]):
    """The whole sequence's scan as one selective-scan launch from
    `ssm_state`, its final state written into `out_state` when given:
    (y, hT, new_conv)."""
    xc, z, dt, b_in, c_in, a, new_conv = _mamba1_pre(params, x, cfg,
                                                     conv_state)
    ys, hT = scan.selective_scan_fused(
        dt.contiguous(), xc.float().contiguous(), b_in.contiguous(),
        c_in.contiguous(), a.contiguous(),
        None if ssm_state is None else ssm_state.contiguous(),
        out_state=out_state)
    return _mamba1_out(params, x, ys, xc, z), hT, new_conv


def _keep(h: torch.Tensor, out_state: Optional[torch.Tensor]
          ) -> torch.Tensor:
    """The plain paths' final state, copied into `out_state` if given."""
    return h if out_state is None else out_state.copy_(h)


def mamba1_scan_ref(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    ssm_state: Optional[torch.Tensor] = None,
                    conv_state: Optional[torch.Tensor] = None, *,
                    out_state: Optional[torch.Tensor] = None,
                    use_kernel: Optional[bool] = None):
    """Sequential oracle / decode path.  x: (B, S, d_model).  Returns
    (y, hT, new_conv), hT written into `out_state` when given (it may
    be `ssm_state`).  The kernel path runs one selective-scan launch
    from `ssm_state`."""
    if use_kernel_for(x, use_kernel):
        return _mamba1_kernel(params, x, cfg, ssm_state, conv_state,
                              out_state)
    xc, z, da, dbx, c_in, new_conv = _mamba1_inputs(params, x, cfg,
                                                    conv_state)
    h = ssm_state if ssm_state is not None else _zero_state(x, cfg)
    ys = []
    for t in range(x.shape[1]):
        h = da[:, t] * h + dbx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c_in[:, t]))
    return _mamba1_out(params, x, torch.stack(ys, dim=1), xc, z), \
        _keep(h, out_state), new_conv


def _slice(t: torch.Tensor, axis: int, start: int, stop: Optional[int],
           step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * t.ndim
    idx[axis] = slice(start, stop, step)
    return t[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor,
                axis: int) -> torch.Tensor:
    """a at the even and b at the odd positions along `axis`."""
    shape = list(a.shape)
    shape[axis] = a.shape[axis] + b.shape[axis]
    out = a.new_empty(shape)
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[axis] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def _assoc(e1: Sequence[torch.Tensor], e2: Sequence[torch.Tensor]):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, b1 * a2 + b2


def _associative_scan(elems: Sequence[torch.Tensor],
                      axis: int) -> Sequence[torch.Tensor]:
    """Inclusive scan of the Mamba-1 combine along `axis`, by the
    odd/even recursion of `jax.lax.associative_scan` (the same pairs
    combined in the same order)."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = _assoc([_slice(e, axis, 0, -1, 2) for e in elems],
                     [_slice(e, axis, 1, None, 2) for e in elems])
    odd = _associative_scan(reduced, axis)
    if n % 2 == 0:
        even = _assoc([_slice(e, axis, 0, -1) for e in odd],
                      [_slice(e, axis, 2, None, 2) for e in elems])
    else:
        even = _assoc(odd, [_slice(e, axis, 2, None, 2) for e in elems])
    even = [torch.cat([_slice(e, axis, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def mamba1_chunked(params: Params, x: torch.Tensor, cfg: ArchConfig,
                   chunk: int = 256,
                   ssm_state: Optional[torch.Tensor] = None,
                   conv_state: Optional[torch.Tensor] = None, *,
                   out_state: Optional[torch.Tensor] = None,
                   use_kernel: Optional[bool] = None):
    """Chunked scan: associative scan inside chunks, carry across.

    The sequence splits into ``nch = max(S // chunk, 1)`` chunks of
    ``S // nch``; a length that does not divide evenly raises, as in
    the reference.  Peak intermediate (B, chunk, d_inner, state).  The
    kernel path scans the whole sequence in one launch instead (any S):
    the same function up to float order.  Returns (y, hT, new_conv),
    hT written into `out_state` when given.
    """
    if use_kernel_for(x, use_kernel):
        return _mamba1_kernel(params, x, cfg, ssm_state, conv_state,
                              out_state)
    xc, z, dt, b_in, c_in, a, new_conv = _mamba1_pre(params, x, cfg,
                                                     conv_state)
    b, s, _ = x.shape
    di, st = cfg.d_inner, cfg.ssm_state
    nch = max(s // chunk, 1)
    ch = s // nch

    def r(t, tail):
        return t.reshape((b, nch, ch) + tail).transpose(0, 1)

    dt_c = r(dt, (di,))
    xc_c = r(xc.float(), (di,))
    b_c = r(b_in, (st,))
    c_c = r(c_in, (st,))
    h = ssm_state if ssm_state is not None else _zero_state(x, cfg)
    ys = []
    for i in range(nch):
        dt_t, xc_t, b_t, c_t = dt_c[i], xc_c[i], b_c[i], c_c[i]
        da_t = torch.exp(dt_t[..., None] * a)            # (b,ch,di,st)
        dbx_t = (dt_t * xc_t)[..., None] * b_t[..., None, :]
        pa, pb = _associative_scan((da_t, dbx_t), axis=1)
        h_all = pa * h[:, None] + pb
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, c_t))
        h = h_all[:, -1]
    ys = torch.stack(ys).transpose(0, 1).reshape(b, s, di)
    return _mamba1_out(params, x, ys, xc, z), _keep(h, out_state), \
        new_conv


def ssm_block_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    mode: str = "chunked", chunk: int = 256,
                    state: Optional[Dict] = None, *,
                    out_state: Optional[torch.Tensor] = None,
                    use_kernel: Optional[bool] = None):
    """Uniform entry: returns (y, new_state dict ``{"ssm", "conv"}``).
    ``mode`` "ref" or "decode" runs `mamba1_scan_ref`, else
    `mamba1_chunked`.  `out_state` (B, d_inner, state) f32, which may
    be ``state["ssm"]``, receives the new scan state in place; the
    kernel writes it there directly."""
    if cfg.mamba_version != 1:
        raise NotImplementedError(
            "Mamba-2/SSD blocks are not ported to PyTorch yet (ROADMAP "
            "Queue A item 10: the remaining non-paged families)")
    ssm_s = state["ssm"] if state else None
    conv_s = state["conv"] if state else None
    if mode in ("ref", "decode"):
        y, h, c = mamba1_scan_ref(params, x, cfg, ssm_s, conv_s,
                                  out_state=out_state,
                                  use_kernel=use_kernel)
    else:
        y, h, c = mamba1_chunked(params, x, cfg, chunk, ssm_s, conv_s,
                                 out_state=out_state,
                                 use_kernel=use_kernel)
    return y, {"ssm": h, "conv": c}
