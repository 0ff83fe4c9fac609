"""Wrappers of the hand-written CUDA paged-attention kernels
(counterparts of the Pallas kernels in `repro.kernels.attention.paged`).

`paged_attention_bhd` (decode) and `paged_prefill_attention_btd`
(chunked prefill) take the Pallas entry points' layouts and contract.
On a CUDA tensor they launch the kernel in `csrc/paged_attention.cu`
on the current stream or raise; there is no fallback.  On a CPU
tensor they compute the plain PyTorch version in `ref.py` (a CPU
tensor has no kernel to run).  Each launch adds one to its entry in
`LAUNCHES`, and nothing else does.

Decode splits each (slot, KV head) over key ranges and combines the
partial results (flash-decoding): `decode_split_plan` picks the split
from the shapes and the SM count alone, so a call reads nothing back
from the card and can be captured in a CUDA graph, and
`split_key_range` is the range each split reads.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES = {"paged_attention_bhd": 0, "paged_prefill_attention_btd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


#: the fewest and the most keys a decode split takes (at least a page)
MIN_SPLIT_KEYS, MAX_SPLIT_KEYS = 32, 512
#: decode blocks a call aims to give each SM
BLOCKS_PER_SM = 4
#: query heads a bf16 decode block holds (more take several row groups;
#: an fp32 block holds 8)
DECODE_ROWS = 16


def decode_split_plan(b: int, h: int, kvh: int, n_pages: int,
                      page_size: int, n_sm: int) -> Tuple[int, int]:
    """(pages per split, splits) of a decode call over (b, n_pages)
    block tables with h query and kvh KV heads on a card of n_sm SMs:
    about BLOCKS_PER_SM blocks a SM over the grid (splits, KV x row
    groups, B), each split MIN_SPLIT_KEYS to MAX_SPLIT_KEYS keys (at
    least a page).  It never looks at the clocks."""
    row_groups = -(-(h // kvh) // DECODE_ROWS)
    pairs = b * kvh * row_groups
    lo = max(1, MIN_SPLIT_KEYS // page_size)
    hi = max(lo, MAX_SPLIT_KEYS // page_size)
    pps = -(-n_pages * pairs // (BLOCKS_PER_SM * n_sm))
    pps = min(max(pps, lo), hi)
    return pps, -(-n_pages // pps)


def split_key_range(split: int, pages_per_split: int, page_size: int,
                    n_pages: int, position: int,
                    window: int = 0) -> Tuple[int, int]:
    """The keys [first, last] that `split` of a slot at `position`
    reads: its pages, at or before the clock, inside the window; empty
    (first > last) when it lies wholly past the clock or behind the
    window (the kernel's `kb`/`ke`)."""
    span = pages_per_split * page_size
    first = split * span
    last = min(min(first + span, n_pages * page_size) - 1, position)
    if window > 0:
        first = max(first, position - window + 1)
    return first, last


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        common = [_I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
        lib.paged_attention_decode.argtypes = \
            [_P] * 7 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
        lib.paged_attention_decode.restype = _I
        lib.paged_prefill_attention.argtypes = [_P] * 6 + [_I] * 3 + common
        lib.paged_prefill_attention.restype = _I
        lib._repro_bound = True
    return lib


def _flat_pool(pages: torch.Tensor) -> torch.Tensor:
    """(S, R, ps, KV, D) -> (S*R, ps, KV, D): rows are the tables'
    ``locality * R + slot`` already."""
    if pages.ndim == 5:
        return pages.reshape(-1, *pages.shape[2:])
    return pages


def _check(q, k_pages, v_pages, tables, clocks, q_ndim: int):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrapper needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if q.ndim != q_ndim:
        raise ValueError(f"q must have {q_ndim} dims, got {tuple(q.shape)}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {dev}")
        if t.ndim not in (4, 5) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d or 5-d pool")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    for name, t in (("block_tables", tables), ("clocks", clocks)):
        if t.device != dev or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {dev}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    kvh = k_pages.shape[-2]
    if k_pages.shape[-1] != d or h % kvh:
        raise ValueError(f"heads {h}x{d} do not fit pages {k_pages.shape}")
    if tables.ndim != 2 or tables.shape[0] != b or clocks.shape != (b,):
        raise ValueError("block_tables (B, P) / clocks (B,) mismatch")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def paged_attention_bhd(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        positions: torch.Tensor, *,
                        window: int = 0) -> torch.Tensor:
    """Decode attention.  q: (B, H, D); k/v_pages: (N, ps, KV, D) or
    (S, R, ps, KV, D) with ``locality * R + slot`` table rows;
    block_tables: (B, P) int32; positions: (B,) int32 per-slot clocks.
    Returns (B, H, D)."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q[:, None], k_pages, v_pages,
                                       block_tables, positions,
                                       window=window)[:, 0]
    _check(q, k_pages, v_pages, block_tables, positions, 3)
    kp, vp = _flat_pool(k_pages), _flat_pool(v_pages)
    b, h, d = q.shape
    ps, kvh, n_pages = kp.shape[1], kp.shape[2], block_tables.shape[1]
    pps, splits = decode_split_plan(b, h, kvh, n_pages, ps,
                                    _sm_count(q.device.index))
    # the splits' (o, m, l), from the caching allocator: no host sync,
    # and a captured call keeps its own
    work = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    err = _lib().paged_attention_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        work.data_ptr(), b, h, kvh, d, ps, n_pages, int(window),
        d ** -0.5, pps, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_attention_bhd")
    LAUNCHES["paged_attention_bhd"] += 1
    return out


def paged_prefill_attention_btd(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                start: torch.Tensor, *,
                                window: int = 0) -> torch.Tensor:
    """Chunked-prefill attention.  q: (B, T, H, D); pages and tables as
    in `paged_attention_bhd`; start: (B,) int32 absolute position of
    q[:, 0].  The chunk's own K/V must already be in its pages; query
    t attends keys at positions <= start + t (and within the window).
    Returns (B, T, H, D)."""
    if q.device.type == "cpu":
        return ref.paged_prefill_attention_ref(
            q, k_pages, v_pages, block_tables, start, window=window)
    _check(q, k_pages, v_pages, block_tables, start, 4)
    kp, vp = _flat_pool(k_pages), _flat_pool(v_pages)
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    err = _lib().paged_prefill_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        block_tables.data_ptr(), start.data_ptr(), out.data_ptr(),
        b, t, h, kp.shape[2], d, kp.shape[1], block_tables.shape[1],
        int(window), d ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_prefill_attention_btd")
    LAUNCHES["paged_prefill_attention_btd"] += 1
    return out
