"""The serving subset of `repro.models.transformer`, on torch tensors.

Entry points (the reference's names and contracts):

  init_params(gen, cfg)                     -> params
  logits_fn(params, hidden)                 -> f32 logits
  prefill(params, batch, cfg)               -> (hidden, cache)
                                            (whole-prompt prefill that
                                            builds the dense decode
                                            cache; flash attention)
  init_cache(cfg, batch, cache_len)         -> dense cache (k/v, or the
                                            ssm family's (ssm, conv)
                                            state)
  decode_step(params, cache, batch, cfg)    -> (logits, cache)
  init_paged_cache(cfg, n_rows, page_size)  -> {"k","v"} page arrays
  decode_step_paged(params, pages, batch, cfg) -> (logits, pages)
  prefill_chunk(params, pages, batch, cfg)  -> (logits, pages)
  resume_prefill(params, hidden)            -> logits

Parameters keep the reference's nested-dict layout with the layers
STACKED on a leading axis (``params["layers"]["attn"]["wq"]`` is
(L, d_model, H*hd)), so `models/convert.py` carries a reference
pytree across leaf by leaf; the layer loop indexes the stack.

Page pools and dense caches are updated IN PLACE: the K/V scatter is
an index copy into ``pages["k"]``/``pages["v"]`` (or the dense
cache's ``k``/``v``; the ssm family's decode writes each layer's new
``ssm``/``conv`` state over its slice of the cache), and the returned
dict holds the tensors passed in.  The reference donates the pool to a
jitted step instead (`repro.serving.engine`), which XLA lowers to the
same in-place update on an accelerator.

Every kernel-running function takes ``use_kernel`` (the counterpart
of ``use_pallas``): None runs the CUDA kernels on CUDA tensors and
their plain versions on CPU tensors; True on a CPU tensor raises;
False runs the plain versions (tests and `chip_smoke.py`).  The
``dense`` and ``audio`` families and the ``ssm`` family (Mamba-1,
`models/ssm.py`, whose scans run the selective-scan kernel; whole
prompt only: it has no paged layout) are ported; ``moe`` (GShard
routing) is ROADMAP Queue A item 3, and the ``hybrid`` and ``vlm``
families item 10.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.kernels.attention import ops
from repro_torch.models import attention as att
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Params, _init_dense, embed_init,
                                       embed_lookup, rmsnorm, rmsnorm_init,
                                       swiglu)

PAGED_FAMILIES = ("dense", "audio", "moe")
PORTED_FAMILIES = ("dense", "audio", "ssm")


def _check_family(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"{what} supports {PAGED_FAMILIES}, not {cfg.family!r}")
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.family!r} layers are not ported yet (ROADMAP Queue A "
            f"item 3: MoE routing)")


def _check_ported(cfg: ArchConfig, what: str) -> None:
    """The whole-prompt functions serve every family in the reference;
    the port has the dense, audio and ssm stacks so far."""
    if cfg.family not in PORTED_FAMILIES:
        item = "3: MoE routing" if cfg.family == "moe" \
            else "10: the remaining non-paged families"
        raise NotImplementedError(
            f"{what} of the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue A item {item})")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _stacked(gen: torch.Generator, n: int, d_in: int, d_out: int,
             dtype: torch.dtype) -> torch.Tensor:
    """(n, d_in, d_out) filled one layer at a time, so the f32 draw
    never holds more than one layer."""
    out = torch.empty((n, d_in, d_out), dtype=dtype, device=gen.device)
    for i in range(n):
        out[i] = _init_dense(gen, d_in, d_out, dtype)
    return out


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters for the ``dense``/``audio``/``ssm`` families,
    drawn from `gen` on its device (a CUDA generator for the card, a CPU
    one for the tests), in the config's dtype (the ssm family's f32
    leaves stay f32) and the reference's stacked layout.  The draws
    differ from the reference's `jax.random` stream;
    `models/convert.params_from_numpy` carries the reference's own
    weights across where a test needs them."""
    _check_ported(cfg, "init_params")
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    d, L = cfg.d_model, cfg.n_layers
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, dt),
        "final_norm": rmsnorm_init(d, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["out_embed"] = embed_init(gen, cfg.vocab_size, d, dt)
    ones = torch.ones((L, d), dtype=dt, device=dev)
    if cfg.family == "ssm":
        params["layers"] = {"norm": {"scale": ones},
                            "ssm": ssm_mod.mamba1_init(gen, cfg, L)}
        return params
    params["layers"] = {
        "attn_norm": {"scale": ones.clone()},
        "attn": {
            "wq": _stacked(gen, L, d, h * hd, dt),
            "wk": _stacked(gen, L, d, kv * hd, dt),
            "wv": _stacked(gen, L, d, kv * hd, dt),
            "wo": _stacked(gen, L, h * hd, d, dt),
        },
        "mlp_norm": {"scale": ones},
        "mlp": {
            "wi": _stacked(gen, L, d, cfg.d_ff, dt),
            "wg": _stacked(gen, L, d, cfg.d_ff, dt),
            "wdown": _stacked(gen, L, cfg.d_ff, d, dt),
        },
    }
    return params


def _layer(stack: Any, i: int) -> Any:
    """Layer `i` of a stacked parameter tree (views, no copies)."""
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def logits_fn(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    out_w = params.get("out_embed", params["embed"])["embedding"]
    return (hidden @ out_w.t().to(hidden.dtype)).float()


def resume_prefill(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """First-token logits from a cached last-position activation
    checkpoint (prefix-cache compute skip, DESIGN.md §4e): a
    fully-covered prompt runs no transformer pass, only this vocab
    projection."""
    return logits_fn(params, hidden)


def _mlp_block(lp: Params, x: torch.Tensor, cfg: ArchConfig):
    return swiglu(lp["mlp"], rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))


def _rope(cfg: ArchConfig, positions: torch.Tensor):
    rot = int(cfg.head_dim * cfg.rope_fraction) if cfg.n_heads else 2
    return att.rope_angles(positions, max(rot, 2), cfg.rope_theta)


# ---------------------------------------------------------------------------
# Whole-prompt prefill and the dense decode cache
# ---------------------------------------------------------------------------

def _attn_block(lp: Params, x: torch.Tensor, cfg: ArchConfig,
                cos: torch.Tensor, sin: torch.Tensor, *,
                use_kernel: Optional[bool] = None):
    """Causal self-attention of one layer over the whole sequence:
    (output projection, (k, v)) with k/v (B, S, KV, D) after RoPE."""
    h = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    q, k, v = att.qkv(lp["attn"], h, cfg)
    q = att.apply_rope(q, cos, sin, cfg.rope_fraction)
    k = att.apply_rope(k, cos, sin, cfg.rope_fraction)
    o = att.attention(q, k, v, cfg, use_kernel=use_kernel)
    b, s, _, _ = o.shape
    return o.reshape(b, s, -1) @ lp["attn"]["wo"], (k, v)


def _counter(value: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=device)


def prefill(params: Params, batch: Dict[str, Any], cfg: ArchConfig,
            use_kernel: Optional[bool] = None, full_kv: bool = False,
            last_index: Optional[int] = None, all_hidden: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence forward that also builds the decode cache.

    batch: tokens (B, S); frame_embeds (B, S, D) for the audio family
    (optional).  Returns (last-position post-norm hidden (B, D),
    cache).  The cache holds k/v (L, B, S', KV, D) and the 0-d int32
    counters ``len`` (valid slots), ``cursor`` (next ring write slot)
    and ``abs`` (next absolute position).  Sliding-window configs keep
    only the trailing ``window`` keys, the ring reset so the cursor
    wraps onto the oldest slot, unless `full_kv` (the paged engines
    keep every position and mask the window by absolute position).
    `last_index` picks the position whose hidden is returned (a
    right-padded prompt ends before its buffer); `all_hidden` returns
    the whole post-norm hidden (B, S, D) instead.  Every layer's
    attention is one flash-attention call: the CUDA kernel on the
    card.  The ssm family's cache holds each layer's final scan state
    ``ssm`` (L, B, d_inner, state) f32 and ``conv`` (L, B, K-1,
    d_inner) instead of k/v; every layer's scan is one selective-scan
    launch on the card (`models/ssm.mamba1_chunked`).
    """
    _check_ported(cfg, "prefill")
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    if cfg.family == "audio" and "frame_embeds" in batch:
        x = x + batch["frame_embeds"].to(x.dtype)
    win = cfg.sliding_window
    eff = min(s, win) if win else s

    def trim(t):   # keep the trailing window for SWA ring buffers
        return t[:, -eff:] if (win and not full_kv) else t

    dev = tokens.device
    cache: Dict[str, Any] = {"len": _counter(eff, dev),
                             "cursor": _counter(0 if win else s, dev),
                             "abs": _counter(s, dev)}
    if cfg.family == "ssm":
        hs, cs = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            y, st = ssm_mod.ssm_block_apply(
                lp["ssm"], rmsnorm(lp["norm"], x, cfg.norm_eps), cfg,
                mode="chunked", use_kernel=use_kernel)
            x = x + y
            hs.append(st["ssm"])
            cs.append(st["conv"])
        cache["ssm"] = torch.stack(hs)
        cache["conv"] = torch.stack(cs)
    else:
        cos, sin = _rope(cfg, torch.arange(s, device=dev))
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            o, (k, v) = _attn_block(lp, x, cfg, cos, sin,
                                    use_kernel=use_kernel)
            x = x + o
            x = x + _mlp_block(lp, x, cfg)
            ks.append(trim(k))
            vs.append(trim(v))
        cache["k"] = torch.stack(ks)
        cache["v"] = torch.stack(vs)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if all_hidden:
        return x, cache
    if last_index is None:
        return x[:, -1], cache
    return x[:, int(last_index)], cache


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Allocate the dense decode cache (zeros) on `device` (default
    ``cuda``): k/v (L, B, S', KV, D) with S' = `cache_len`, capped at
    the window for sliding-window configs, and zero counters.  The ssm
    family keeps no k/v: ``ssm`` (L, B, d_inner, state) f32 and
    ``conv`` (L, B, K-1, d_inner) in `dtype`."""
    _check_ported(cfg, "init_cache")
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    cache = {"len": _counter(0, dev), "cursor": _counter(0, dev),
             "abs": _counter(0, dev)}
    L = cfg.n_layers
    if cfg.family == "ssm":
        cache["ssm"] = torch.zeros(
            (L, batch_size, cfg.d_inner, cfg.ssm_state),
            dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros(
            (L, batch_size, cfg.ssm_conv - 1, cfg.d_inner), dtype=dt,
            device=dev)
        return cache
    eff = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    shape = (L, batch_size, eff, cfg.n_kv_heads, cfg.head_dim)
    cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
    cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def _decode_attn(lp: Params, x: torch.Tensor, cfg: ArchConfig,
                 cos: torch.Tensor, sin: torch.Tensor, k_c: torch.Tensor,
                 v_c: torch.Tensor, cache_len: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """One-token attention against one layer's cache, writing the new
    K/V at slot `pos` (a 1-element int64 index) IN PLACE first."""
    h = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    q, k, v = att.qkv(lp["attn"], h, cfg)
    q = att.apply_rope(q, cos, sin, cfg.rope_fraction)
    k = att.apply_rope(k, cos, sin, cfg.rope_fraction)
    k_c.index_copy_(1, pos, k.to(k_c.dtype))
    v_c.index_copy_(1, pos, v.to(v_c.dtype))
    o = att.decode_attention(q, k_c, v_c, cache_len + 1, cfg)
    return o.reshape(x.shape[0], 1, -1) @ lp["attn"]["wo"]


def _decode_ssm(params: Params, x: torch.Tensor, cache: Dict[str, Any],
                cfg: ArchConfig, use_kernel: Optional[bool]
                ) -> torch.Tensor:
    """The ssm family's layers for one token: each layer's scan runs
    one step from its cached state (one selective-scan launch on the
    card, which writes the new state over that layer's slice of the
    cache), and the new ``conv`` state overwrites its slice too."""
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h_c, c_c = cache["ssm"][i], cache["conv"][i]
        y, st = ssm_mod.ssm_block_apply(
            lp["ssm"], rmsnorm(lp["norm"], x, cfg.norm_eps), cfg,
            mode="decode", state={"ssm": h_c, "conv": c_c}, out_state=h_c,
            use_kernel=use_kernel)
        x = x + y
        c_c.copy_(st["conv"])
    return x


def decode_step(params: Params, cache: Dict[str, Any],
                batch: Dict[str, Any], cfg: ArchConfig,
                use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for the whole batch on the shared clock.

    batch: tokens (B, 1).  Returns (logits (B, V) f32, cache): the
    cache's k/v (or the ssm family's ``ssm``/``conv`` state) are
    written in place and the counters advance by one.  Sliding-window
    caches are rings: the write slot wraps at ``cursor % window``.  A
    full cache writes its last slot again, as the reference's clamped
    `dynamic_update_slice` does.  The attention families' decode
    attention is plain torch (the reference has no kernel there);
    `use_kernel` reaches the ssm family's selective scan.
    """
    _check_ported(cfg, "decode_step")
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens)
    if cfg.family == "ssm":
        x = _decode_ssm(params, x, cache, cfg, use_kernel)
    else:
        cache_len = cache["len"]
        eff = cache["k"].shape[2]
        if cfg.sliding_window > 0:
            pos = cache["cursor"] % eff
        else:
            pos = torch.clamp(cache["cursor"], max=eff - 1)
        pos = pos.long().reshape(1)
        cos, sin = _rope(cfg, cache["abs"][None])
        aux_len = torch.clamp(cache_len, max=eff - 1)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            x = x + _decode_attn(lp, x, cfg, cos, sin, cache["k"][i],
                                 cache["v"][i], aux_len, pos)
            x = x + _mlp_block(lp, x, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_fn(params, x[:, 0])
    cache = dict(cache, len=cache["len"] + 1,
                 cursor=cache["cursor"] + 1, abs=cache["abs"] + 1)
    return logits, cache


# ---------------------------------------------------------------------------
# Paged KV cache (serving/kvcache.py block tables)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ArchConfig, n_rows: int, page_size: int,
                     dtype: Optional[torch.dtype] = None,
                     n_shards: int = 1,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Allocate the page-pool K/V arrays (zeros) on `device`
    (default ``cuda``).

    Single locality: (L, n_rows, ps, KV, D), `n_rows` counting the
    trailing null row idle slots write into.  Sharded
    (``n_shards > 1``): (L, n_shards, n_rows, ps, KV, D), one null row
    per shard, table rows encoded ``locality * n_rows + slot``.
    """
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"paged decode supports {PAGED_FAMILIES}, not {cfg.family!r}")
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    if n_shards > 1:
        shape = (cfg.n_layers, n_shards, n_rows, page_size,
                 cfg.n_kv_heads, cfg.head_dim)
    else:
        shape = (cfg.n_layers, n_rows, page_size, cfg.n_kv_heads,
                 cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def decode_step_paged(params: Params, pages: Dict[str, Any],
                      batch: Dict[str, Any], cfg: ArchConfig,
                      use_kernel: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step over block tables with per-slot position clocks.

    batch: tokens (B, 1); block_tables (B, P) int32 physical page rows;
    positions (B,) int32 per-slot absolute position of the new token;
    write_rows/write_offs (B,) page slot the new K/V lands in (idle
    slots point at the pool's null row, which no mask reads).  Sliding
    windows are absolute-position masks.  A 6-d (sharded) pool decodes
    each row into (locality, slot).  Returns (logits (B, V) f32,
    pages), the pages written in place.
    """
    _check_family(cfg, "paged decode")
    tokens = batch["tokens"]
    tables = batch["block_tables"]
    positions = batch["positions"]
    write_rows = batch["write_rows"].long()
    write_offs = batch["write_offs"].long()
    b = tokens.shape[0]
    x = embed_lookup(params["embed"], tokens)
    # per-slot RoPE phases: (B, 1, rot/2) broadcasting over heads
    cos, sin = _rope(cfg, positions[:, None])
    sharded = pages["k"].ndim == 6
    if sharded:
        rps = pages["k"].shape[2]
        wloc, wslot = write_rows // rps, write_rows % rps
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        kp, vp = pages["k"][i], pages["v"][i]
        h = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = att.qkv(lp["attn"], h, cfg)
        q = att.apply_rope(q, cos, sin, cfg.rope_fraction)
        k = att.apply_rope(k, cos, sin, cfg.rope_fraction)
        # scatter the new token's K/V into each slot's write page
        if sharded:
            kp[wloc, wslot, write_offs] = k[:, 0].to(kp.dtype)
            vp[wloc, wslot, write_offs] = v[:, 0].to(vp.dtype)
        else:
            kp[write_rows, write_offs] = k[:, 0].to(kp.dtype)
            vp[write_rows, write_offs] = v[:, 0].to(vp.dtype)
        o = ops.paged_attention(q, kp, vp, tables, positions,
                                window=cfg.sliding_window,
                                use_kernel=use_kernel)
        x = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"]
        x = x + _mlp_block(lp, x, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, x[:, 0]), pages


def prefill_chunk(params: Params, pages: Dict[str, Any],
                  batch: Dict[str, Any], cfg: ArchConfig,
                  use_kernel: Optional[bool] = None,
                  all_hidden: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Resumable chunked prefill: one page-aligned chunk of a prompt
    consumes and extends the paged KV cache (DESIGN.md §4b).

    batch: tokens (B, C) right-padded to the chunk width; block_tables
    (B, P) int32; start (B,) int32 page-aligned absolute position of
    tokens[:, 0]; chunk_rows (B, C/ps) physical rows the chunk's K/V
    pages are scattered into, with the null row standing in for
    prefix-shared pages and pages past a partial final chunk;
    last_index () chunk-local index whose hidden state feeds the
    logits.  The chunk's K/V is written before the attention, so one
    paged attention covers earlier chunks and the chunk itself; junk
    K/V of right-padding lands beyond the slot's clock and is never
    read.  Returns (logits (B, V) f32, pages); with ``all_hidden`` the
    post-norm hidden (B, C, D) replaces the logits.
    """
    _check_family(cfg, "paged prefill")
    tokens = batch["tokens"]
    tables = batch["block_tables"]
    start = batch["start"]
    chunk_rows = batch["chunk_rows"].long()
    b, c = tokens.shape
    sharded = pages["k"].ndim == 6       # (L, S, R, ps, KV, D)
    ps = pages["k"].shape[3 if sharded else 2]
    if c % ps:
        raise ValueError(f"chunk width {c} not page-aligned (ps={ps})")
    cp = c // ps
    x = embed_lookup(params["embed"], tokens)
    positions = start.long()[:, None] + torch.arange(
        c, device=tokens.device)[None, :]
    cos, sin = _rope(cfg, positions)
    if sharded:
        rps = pages["k"].shape[2]
        cloc, cslot = chunk_rows // rps, chunk_rows % rps
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        kp, vp = pages["k"][i], pages["v"][i]
        h = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = att.qkv(lp["attn"], h, cfg)
        q = att.apply_rope(q, cos, sin, cfg.rope_fraction)
        k = att.apply_rope(k, cos, sin, cfg.rope_fraction)
        # scatter the chunk's K/V as whole pages
        kw = k.reshape(b, cp, ps, *k.shape[2:]).to(kp.dtype)
        vw = v.reshape(b, cp, ps, *v.shape[2:]).to(vp.dtype)
        if sharded:
            kp[cloc, cslot] = kw
            vp[cloc, cslot] = vw
        else:
            kp[chunk_rows] = kw
            vp[chunk_rows] = vw
        o = ops.paged_prefill_attention(q, kp, vp, tables, start,
                                        window=cfg.sliding_window,
                                        use_kernel=use_kernel)
        x = x + o.reshape(b, c, -1) @ lp["attn"]["wo"]
        x = x + _mlp_block(lp, x, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if all_hidden:
        return x, pages
    return logits_fn(params, x[:, int(batch["last_index"])]), pages
