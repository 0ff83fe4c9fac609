"""GPU smoke run of the PyTorch port: builds the CUDA kernels, holds
each against its plain PyTorch version, times them, and serves
full-width yi-6b through the chunked, the whole-prompt paged and the
dense engines.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero before the
last line):

1. the card: ``nvidia-smi --query-gpu=name,power.limit`` as printed;
2. build: the paged-attention and flash-attention kernels compiled by
   nvcc from ``src/repro_torch/kernels/attention/csrc/`` into
   ``build/repro_torch_kernels/``, one nvcc each, started together;
3. kernel against plain version on random inputs.  Paged kernels at
   the serve configuration's shapes: yi-6b's attention (H 32, KV 4,
   D 128), page 16, block tables of max_len / page = 128 pages, decode
   over the engine's 8 slots with clocks up to 2047 and two idle slots
   parked on the null row at position 0 (as a released slot is left),
   prefill of the engine's B 1 x T 256 chunk at starts up to 1792, and
   B 8 prefill besides; fp32 and bf16, flat and sharded pools, window
   0 and 512.  Flash kernel at yi-6b's heads, B 1: S over the
   whole-prompt engines' buckets (256-1536) and S 1000 (not a multiple
   of 128), each as the whole sequence and as its second half
   continuing the first (``q_offset`` S/2); fp32 and bf16, causal and
   not, window 0 and S/3.  Tolerances: fp32 atol 1e-5 (paged; the
   reference's `test_serving_paged.py` tolerance) and 2e-5 (flash;
   `test_kernels.py`'s); bf16, per element, 2^-7 * (sum_j p_j |v_j| +
   |o|): one bf16 ulp of each softmax weight times its value plus one
   ulp of the output, which is what the two versions, rounding p and o
   to bf16 from fp32 values that differ in their last bits, can move an
   element by (sum_j p_j |v_j| is the plain version run on |V|);
4. end to end: random full-width yi-6b bf16 weights from a seed; one
   full-width chunk's logits (`prefill_chunk`) and one 1536-token
   prompt's logits (`prefill`) through the kernels held against the
   plain versions'.  Then ``make_engine(engine="chunked", slots=8,
   max_len=2048, page_size=16, chunk_size=256, step_tokens=512,
   prefix_cache_compute=True)`` serves 8 requests of 200-1500 prompt
   tokens (two sharing a 512-token head, the second arriving once the
   first is resident, so compute skip resumes it past the head), 32
   new tokens each, in three waves on fresh engines (the first
   counted, the others give the spread within one run);
   ``engine="paged"`` (whole-prompt prefill at the buckets 256, 512,
   768, 1024, 1280 and 1536, the same pool, compute skip on) and
   ``engine="dense"`` (8 slots of 2048, the same buckets, left-padded
   prompts on one shared clock, as in the reference) serve the same 8
   requests, one wave each.  Each counted wave
   zeroes every kernel's launch count just before it, reads the counts
   just after, and keeps a copy of what its kernel calls were given
   (block tables and clocks of each decode batch and prefill chunk;
   the bucket of each whole-prompt prefill);
5. replay: every paged-kernel call of the counted chunked wave, at its
   own block tables and clocks, and every flash call of the counted
   whole-prompt paged wave, at its own bucket, run again on random
   inputs (fp32 and bf16) and held against the plain version, then
   timed in bf16 as the
   whole recorded sequence: kernel, plain version, one PyTorch call
   computing the same function (`scaled_dot_product_attention`, on
   pre-gathered K/V for the paged kernels; a yardstick the port never
   calls) and the bound, each per launch.  The bound of a call is the
   larger of the bytes it must move over 3.35 TB/s (paged: each
   distinct live K/V page once, q and o once; flash: q, k, v and o
   once) and its flops (4 * head_dim per visible query, head and key:
   the live causal area) over 989 TFLOP/s (H100 SXM data-sheet peaks);
6. the kernels line: route, source, the TPU kernel replaced, launches
   on its path's counted wave, error, times and bound (step 5's);
7. ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16, data sheet
FP32_ATOL = 1e-5                   # paged kernels
FLASH_FP32_ATOL = 2e-5             # flash kernel
BF16_ULP = 2.0 ** -7               # a bf16 ulp, relative, at its largest
TOL = {"float32": "atol 1e-5",
       "bfloat16": "2^-7 * (sum_j p_j |v_j| + |o|) per element"}
FLASH_TOL = dict(TOL, float32="atol 2e-5")
# full-width chunk logits, kernel vs plain, after 32 bf16 layers: the
# two attention versions round differently and the residual stream
# carries it; held to 2.5% of the largest logit, and the argmax must
# agree
LOGIT_REL_TOL = 2.5e-2

# the serve configuration; the kernel checks take their shapes from it
PS, MAX_LEN, SLOTS, CHUNK = 16, 2048, 8, 256
P = MAX_LEN // PS                  # the engine's block-table width
SERVE = dict(engine="chunked", slots=SLOTS, max_len=MAX_LEN, page_size=PS,
             chunk_size=CHUNK, step_tokens=512, prefix_cache_compute=True)
H, KV, D = 32, 4, 128              # yi-6b's attention
IDLE = (1, 6)                      # idle slots of the synthetic decode batch
DECODE, PREFILL = "paged_attention_bhd", "paged_prefill_attention_btd"
FLASH = "flash_attention_bhsd"
# the whole-prompt engines' prefill buckets: every prompt of the wave
# (200-1500 tokens) lands on one of them
BUCKETS = (256, 512, 768, 1024, 1280, 1536)
# flash kernel checks at B 1: each bucket, and a length that is not a
# multiple of 128, as (Sq, Sk, q_offset): the whole prompt, and its
# second half continuing the first (q_offset set)
FLASH_LENGTHS = BUCKETS + (1000,)
FLASH_SHAPES = [shape for s in FLASH_LENGTHS
                for shape in ((s, s, 0), (s - s // 2, s, s // 2))]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fns, iters: int) -> float:
    """Mean ms per call over `iters` passes through the list `fns`,
    after three warm-up passes; CUDA events around the timed passes."""
    import torch
    for _ in range(3):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        for fn in fns:
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * len(fns))


# -- inputs and bounds ---------------------------------------------------

def make_inputs(gen, b, t, dtype, sharded, decode):
    """Random pool whose last row is the null row; block tables of
    width P over random rows up to each slot's last live page and the
    null row past it.  Decode: clocks in [0, MAX_LEN), the IDLE slots
    on the null row at position 0.  Prefill: page-aligned starts in
    [0, MAX_LEN - t]."""
    import torch
    n = b * P + 2
    null = n - 1
    kp = torch.randn(n, PS, KV, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(n, PS, KV, D, generator=gen, device="cuda").to(dtype)
    if decode:
        clocks = torch.randint(0, MAX_LEN, (b,), generator=gen,
                               device="cuda", dtype=torch.int32)
        q = torch.randn(b, H, D, generator=gen, device="cuda").to(dtype)
        last = clocks // PS
    else:
        clocks = torch.randint(0, (MAX_LEN - t) // PS + 1, (b,),
                               generator=gen, device="cuda",
                               dtype=torch.int32) * PS
        q = torch.randn(b, t, H, D, generator=gen, device="cuda").to(dtype)
        last = (clocks + t - 1) // PS
    tables = torch.randint(0, null, (b, P), generator=gen, device="cuda",
                           dtype=torch.int32)
    live = torch.arange(P, device="cuda")[None] <= last[:, None]
    tables = torch.where(live, tables, null).to(torch.int32)
    if decode:
        for s in IDLE:
            tables[s] = null
            clocks[s] = 0
    if sharded:
        kp = kp.reshape(2, n // 2, PS, KV, D)
        vp = vp.reshape(2, n // 2, PS, KV, D)
    return q, kp, vp, tables.contiguous(), clocks


def live_pages(pos_lo: int, pos_hi: int, window: int):
    """The page range a block of queries at [pos_lo, pos_hi] reads."""
    hi = min(P - 1, pos_hi // PS)
    lo = 0
    if window > 0:
        x = pos_lo - window - PS + 1
        lo = x // PS + 1 if x >= 0 else 0
    return lo, hi


def bound_times(q, tables, clocks, window, decode):
    """(bytes_ms, ops_ms) of one call from its own inputs: each
    distinct live K/V page row read once, q read and o written once;
    4 * D flops per visible (query, head, key)."""
    esize = q.element_size()
    t = 1 if decode else q.shape[1]
    rows = set()
    flops = 0
    for tab, c in zip(tables.tolist(), clocks.tolist()):
        lo, hi = live_pages(c, c + t - 1, window)
        rows.update(tab[lo:hi + 1])
        for pos in range(c, c + t):
            vis = pos + 1 if window <= 0 else min(pos + 1, window)
            flops += 4 * D * H * vis
    nbytes = 2 * q.numel() * esize + len(rows) * PS * KV * D * esize * 2
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def sdpa_call(q, kp, vp, tables, clocks, window, decode):
    """One scaled_dot_product_attention call on pre-gathered K/V with
    the absolute-position mask (the yardstick; gather excluded)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention.ref import _gather_pages
    b = q.shape[0]
    k = _gather_pages(kp, tables, b, KV, D).transpose(1, 2).contiguous()
    v = _gather_pages(vp, tables, b, KV, D).transpose(1, 2).contiguous()
    qq = (q[:, None] if decode else q).transpose(1, 2).contiguous()
    t = qq.shape[2]
    qpos = clocks.long()[:, None] + torch.arange(t, device="cuda")[None]
    j = torch.arange(k.shape[2], device="cuda")
    mask = j[None, None, :] <= qpos[:, :, None]
    if window > 0:
        mask &= qpos[:, :, None] - j[None, None, :] < window
    mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def kernel_and_plain(name, q, kp, vp, tables, clocks, window=0):
    """(kernel thunk, plain-version thunk) of one call."""
    from repro_torch.kernels.attention import paged, ref
    if name == DECODE:
        return (lambda: paged.paged_attention_bhd(q, kp, vp, tables, clocks,
                                                  window=window),
                lambda: ref.paged_attention_ref(q[:, None], kp, vp, tables,
                                                clocks, window=window)[:, 0])
    return (lambda: paged.paged_prefill_attention_btd(q, kp, vp, tables,
                                                      clocks, window=window),
            lambda: ref.paged_prefill_attention_ref(q, kp, vp, tables,
                                                    clocks, window=window))


def error_ratio(got, want, plain_abs, fp32_atol: float):
    """(max abs error, max error over its tolerance) of a kernel output
    against its plain version; the check passes when the second is at
    most 1 and the output is finite.  `plain_abs` computes the plain
    version on |V| (the bf16 bound's sum_j p_j |v_j|)."""
    import torch
    got, want = got.float(), want.float()
    if plain_abs is None:
        tol = torch.full_like(want, fp32_atol)
    else:
        tol = BF16_ULP * (plain_abs().float() + want.abs())
    diff = (got - want).abs()
    ratio = (diff / tol).max().item()
    if not bool(torch.isfinite(got).all()):
        ratio = float("inf")
    return diff.max().item(), ratio


def compare(name, q, kp, vp, tables, clocks, window=0):
    """`error_ratio` of one paged-kernel call."""
    import torch
    kern, plain = kernel_and_plain(name, q, kp, vp, tables, clocks, window)
    plain_abs = None
    if q.dtype != torch.float32:
        plain_abs = kernel_and_plain(name, q, kp, vp.abs(), tables, clocks,
                                     window)[1]
    return error_ratio(kern(), plain(), plain_abs, FP32_ATOL)


def time_sequence(name, kern, plain, lib, bounds, gpu, **line):
    """Time lists of thunks in bf16 — kernel, plain version, library
    call — and average the bounds ((bytes_ms, ops_ms) per call), each
    per launch.  Kernel and plain run plain, kernel, kernel, plain, the
    lower of each pair kept."""
    iters = max(2, 40 // len(kern))
    p1 = time_ms(plain, iters)
    k1 = time_ms(kern, iters)
    k2 = time_ms(kern, iters)
    p2 = time_ms(plain, iters)
    lib_ms = time_ms(lib, iters)
    tb = sum(b for b, _ in bounds)
    to = sum(o for _, o in bounds)
    tmax = sum(max(b, o) for b, o in bounds)
    out = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
           "library_ms": lib_ms, "bound_ms": tmax / len(bounds),
           "bound_by": "bytes" if tb >= to else "operations"}
    emit({"timing": name, "gpu": gpu, "dtype": "bfloat16",
          "calls": len(kern), **line, "kernel_ms": [k1, k2],
          "plain_ms": [p1, p2], "library_ms": lib_ms,
          "bound_ms": out["bound_ms"], "bound_by": out["bound_by"]})
    return out


def time_calls(name, calls, gpu, **line):
    """Time a list of (q, kp, vp, tables, clocks) calls of one paged
    kernel in bf16 (`time_sequence`); the library call is SDPA on
    pre-gathered K/V with the absolute-position mask."""
    decode = name == DECODE
    thunks = [kernel_and_plain(name, *c) for c in calls]
    lib = [sdpa_call(*c, 0, decode) for c in calls]
    bounds = [bound_times(q, tables, clocks, 0, decode)
              for q, _, _, tables, clocks in calls]
    return time_sequence(name, [k for k, _ in thunks],
                         [p for _, p in thunks], lib, bounds, gpu, **line)


# -- flash attention -------------------------------------------------------

def flash_inputs(gen, b, sq, sk, dtype):
    import torch
    return (torch.randn(b, sq, H, D, generator=gen, device="cuda").to(dtype),
            torch.randn(b, sk, KV, D, generator=gen, device="cuda").to(dtype),
            torch.randn(b, sk, KV, D, generator=gen, device="cuda").to(dtype))


def flash_thunks(q, k, v, **kw):
    """(kernel thunk, plain-version thunk) of one flash call."""
    from repro_torch.kernels.attention import flash, ref
    return (lambda: flash.flash_attention_bshd(q, k, v, **kw),
            lambda: ref.flash_attention_ref(q, k, v, **kw))


def compare_flash(q, k, v, **kw):
    """`error_ratio` of one flash-kernel call."""
    import torch
    kern, plain = flash_thunks(q, k, v, **kw)
    plain_abs = None
    if q.dtype != torch.float32:
        plain_abs = flash_thunks(q, k, v.abs(), **kw)[1]
    return error_ratio(kern(), plain(), plain_abs, FLASH_FP32_ATOL)


def flash_bound(q, k, causal=True, window=0, q_offset=0):
    """(bytes_ms, ops_ms) of one flash call: q, k, v read and o written
    once; 4 * D flops per visible (query, head, key), the live area
    the masks leave."""
    import numpy as np
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(sk - 1, qpos) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(sq)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    flops = 4 * d * h * b * pairs
    nbytes = (2 * b * sq * h * d + 2 * b * sk * kvh * d) * q.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def flash_sdpa(q, k, v):
    """One causal GQA `scaled_dot_product_attention` call on the same
    inputs (the yardstick; head-major copies made outside the timing)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)


def time_flash(calls, gpu, **line):
    """Time a list of causal (q, k, v) flash calls in bf16."""
    thunks = [flash_thunks(q, k, v) for q, k, v in calls]
    return time_sequence(FLASH, [k for k, _ in thunks],
                         [p for _, p in thunks],
                         [flash_sdpa(*c) for c in calls],
                         [flash_bound(q, k) for q, k, _ in calls], gpu,
                         **line)


# -- phases ----------------------------------------------------------------

def phase_kernels(gpu: str):
    """Random inputs at the serve configuration's shapes, every dtype,
    pool layout and window; B 8 timings as extra lines."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {DECODE: 0.0, PREFILL: 0.0}
    shapes = [(DECODE, SLOTS, 1), (PREFILL, 1, CHUNK), (PREFILL, 8, CHUNK)]
    for dtype in (torch.float32, torch.bfloat16):
        for sharded in (False, True):
            for window in (0, 512):
                for name, b, t in shapes:
                    q, kp, vp, tables, clocks = make_inputs(
                        gen, b, t, dtype, sharded, name == DECODE)
                    err, ratio = compare(name, q, kp, vp, tables,
                                         clocks, window)
                    emit({"check": name, "inputs": "random",
                          "dtype": str(dtype).split(".")[-1],
                          "pool": "sharded" if sharded else "flat",
                          "window": window, "batch": b, "tokens": t,
                          "table_pages": P, "clocks": clocks.tolist(),
                          "max_abs_err": err, "err_over_tol": ratio,
                          "tol": TOL[str(dtype).split(".")[-1]],
                          "ok": ratio <= 1.0})
                    if ratio > 1.0:
                        fail(f"{name} disagrees with its plain version "
                             f"({dtype}, sharded={sharded}, "
                             f"window={window}, B={b}): max abs err {err}, "
                             f"{ratio} times its tolerance")
                    if dtype == torch.bfloat16:
                        worst[name] = max(worst[name], err)
    for name, b, t in ((DECODE, SLOTS, 1), (PREFILL, 8, CHUNK)):
        call = make_inputs(gen, b, t, torch.bfloat16, False, name == DECODE)
        time_calls(name, [call], gpu, inputs="random", batch=b, tokens=t,
                   table_pages=P)
    return worst


def phase_flash_kernel(gpu: str):
    """The flash kernel on random inputs at yi-6b's heads, B 1: every
    (Sq, Sk, q_offset) of FLASH_SHAPES, fp32 and bf16, causal and not,
    window 0 and a window of a third of Sk (shorter than the sequence,
    not a multiple of the key tile); the longest bucket's causal call
    timed as an extra line."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    b = 1
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for sq, sk, off in FLASH_SHAPES:
            for causal in (True, False):
                for window in (0, sk // 3):
                    q, k, v = flash_inputs(gen, b, sq, sk, dtype)
                    err, ratio = compare_flash(q, k, v, causal=causal,
                                               window=window, q_offset=off)
                    emit({"check": FLASH, "inputs": "random",
                          "dtype": dname, "batch": b, "sq": sq, "sk": sk,
                          "q_offset": off, "causal": causal,
                          "window": window, "max_abs_err": err,
                          "err_over_tol": ratio, "tol": FLASH_TOL[dname],
                          "ok": ratio <= 1.0})
                    if ratio > 1.0:
                        fail(f"{FLASH} disagrees with its plain version "
                             f"({dtype}, B={b}, Sq={sq}, Sk={sk}, "
                             f"q_offset={off}, causal={causal}, "
                             f"window={window}): max abs err {err}, "
                             f"{ratio} times its tolerance")
                    if dtype == torch.bfloat16:
                        worst = max(worst, err)
    s = BUCKETS[-1]
    time_flash([flash_inputs(gen, b, s, s, torch.bfloat16)], gpu,
               inputs="random", batch=b, sq=s, sk=s)
    return worst


def make_requests(vocab: int, seed: int = 0):
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, size=512)
    lens = [200, 1500, 700, 900, 350, 1200, 640, 1024]
    reqs = []
    for rid, n in enumerate(lens):
        if rid in (1, 5):       # two prompts sharing a 512-token head
            p = np.concatenate([head, rng.integers(0, vocab, size=n - 512)])
        else:
            p = rng.integers(0, vocab, size=n)
        reqs.append(Request(rid, p.astype(np.int32), max_new_tokens=32))
    return reqs


def record_kernel_inputs(eng):
    """Keep a copy of the block tables and clocks of every decode batch
    and prefill chunk `eng` runs, and the shape of every whole-prompt
    prefill: what its kernel calls are given."""
    rec = {DECODE: [], PREFILL: [], FLASH: []}
    if hasattr(eng, "kvc"):
        batch_inputs = eng.kvc.batch_inputs

        def batch_inputs_rec():
            b = batch_inputs()
            rec[DECODE].append((b["block_tables"].clone(),
                                b["positions"].clone()))
            return b
        eng.kvc.batch_inputs = batch_inputs_rec
    if hasattr(eng, "_chunk_step"):
        chunk_step = eng._chunk_step

        def chunk_step_rec(toks, tables, start, rows, last):
            rec[PREFILL].append((tables.clone(), start.clone()))
            return chunk_step(toks, tables, start, rows, last)
        eng._chunk_step = chunk_step_rec
    prefill_fn = eng._prefill_fn

    def prefill_fn_rec(bucket):
        fn = prefill_fn(bucket)

        def run(params, tokens, last_index):
            rec[FLASH].append(tuple(tokens.shape))
            return fn(params, tokens, last_index)
        return run
    eng._prefill_fn = prefill_fn_rec
    return rec


def drive_wave(eng, reqs, late_rid=None, first_rid=None):
    """Serve `reqs` to completion.  With `late_rid`, that request
    arrives once request `first_rid` is decoding (its pages resident),
    so a shared head can be reused.  Returns (futures, wall seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = {r.rid: eng.submit(r) for r in reqs if r.rid != late_rid}
    if late_rid is not None:
        for _ in range(500):
            if any(st["req"].rid == first_rid and
                   st.get("phase", "decode") == "decode"
                   for st in eng.active.values()):
                break
            eng.step()
        else:
            fail(f"request {first_rid} never finished its prefill")
        futs[late_rid] = eng.submit(
            next(r for r in reqs if r.rid == late_rid))
    eng.run_to_completion()
    torch.cuda.synchronize()
    return futs, time.perf_counter() - t0


def check_wave(eng, reqs, futs, vocab: int, skipped=None):
    comps = []
    for r in reqs:
        f = futs[r.rid]
        if not f.done():
            fail(f"request {r.rid} never resolved")
        c = f.get()                       # raises if the LCO holds an error
        if len(c.tokens) != r.max_new_tokens or \
                not all(0 <= x < vocab for x in c.tokens):
            fail(f"request {r.rid}: bad tokens {c.tokens}")
        comps.append(c)
    if skipped is not None:
        s = eng.stats()
        if s["prefill_tokens_skipped"] != skipped:
            fail(f"compute skip skipped {s['prefill_tokens_skipped']} "
                 f"prompt tokens, not {skipped}")
    return comps


def wave_line(eng, cfg, gpu, engine, reqs, comps, wall, **extra):
    """The end-to-end figures of one wave, from the engine's streaming
    histograms."""
    m = eng.metrics
    ttft, itl = m.histogram("engine.ttft_ms"), m.histogram("engine.itl_ms")
    new_tokens = sum(len(c.tokens) for c in comps)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    line = {"serve": cfg.name, "engine": engine, "gpu": gpu,
            "requests": len(comps), "prompt_tokens": prompt_tokens,
            "new_tokens": new_tokens, "wall_s": wall,
            "new_tokens_per_s": new_tokens / wall,
            "total_tokens_per_s": (new_tokens + prompt_tokens) / wall,
            "ttft_ms": {"p50": ttft.quantile(50.0), "mean": ttft.mean},
            "itl_ms": {"p50": itl.quantile(50.0), "p95": itl.quantile(95.0),
                       "mean": itl.mean}}
    if hasattr(eng, "stats"):
        s = eng.stats()
        line.update(steps=s["steps"],
                    prefix_partial_hits=s["prefix_partial_hits"],
                    prefill_tokens_skipped=s["prefill_tokens_skipped"],
                    preemptions=s["preemptions"])
    line.update(extra)
    emit(line)


def reset_launches():
    from repro_torch.kernels.attention import flash, paged
    paged.reset_launches()
    flash.reset_launches()


def read_launches():
    from repro_torch.kernels.attention import flash, paged
    return {**paged.LAUNCHES, **flash.LAUNCHES}


def check_launches(cfg, engine, launches, rec, ran):
    """Every kernel the wave's path runs launched n_layers times per
    recorded call, and the others not at all."""
    for name, n in launches.items():
        want = cfg.n_layers * len(rec[name]) if name in ran else 0
        if n != want or (name in ran and n < cfg.n_layers):
            fail(f"{engine} wave: {name} launched {n} times, but "
                 f"{len(rec[name])} recorded calls of {cfg.n_layers} "
                 f"layers make {want}")


def logits_check(name, outs, **line):
    """Kernel vs plain logits: within LOGIT_REL_TOL of the largest
    plain logit, same argmax, finite."""
    import torch
    diff = (outs[True] - outs[False]).abs().max().item()
    scale = outs[False].abs().max().item()
    finite = bool(torch.isfinite(outs[True]).all())
    top2 = outs[False].topk(2, dim=-1).values
    argmax_equal = bool((outs[True].argmax(-1) ==
                         outs[False].argmax(-1)).all())
    ok = finite and diff <= LOGIT_REL_TOL * scale and argmax_equal
    emit({"check": name, "shape": list(outs[True].shape), **line,
          "max_abs_diff": diff, "max_abs_logit": scale,
          "rel_tol": LOGIT_REL_TOL, "finite": finite,
          "argmax_equal": argmax_equal,
          "plain_top2_margin": (top2[..., 0] - top2[..., 1]).min().item(),
          "ok": ok})
    if not ok:
        fail(f"{name}: kernel vs plain differ by {diff} (largest logit "
             f"{scale}), argmax equal: {argmax_equal}")


def phase_logits(params, cfg):
    """One full-width 256-token chunk at a (1, P) table, and one
    1536-token whole prompt (tokens from a seed), each through the
    kernels and through the plain versions."""
    import torch
    from repro_torch.models import transformer as T_
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = CHUNK // PS
    tables = torch.full((1, P), n, dtype=torch.int32, device="cuda")
    tables[0, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, CHUNK),
                                     generator=gen, device="cuda"),
             "block_tables": tables,
             "start": torch.zeros(1, dtype=torch.int32, device="cuda"),
             "chunk_rows": tables[:, :n].contiguous(),
             "last_index": CHUNK - 1}
    outs = {}
    for use_kernel in (True, False):
        pages = T_.init_paged_cache(cfg, n + 1, PS, device="cuda")
        logits, _ = T_.prefill_chunk(params, pages, batch, cfg,
                                     use_kernel=use_kernel)
        outs[use_kernel] = logits.float()
        del pages
    logits_check("prefill_chunk_logits", outs, table_pages=P)
    s = BUCKETS[-1]
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (1, s),
                                    generator=gen, device="cuda")}
    outs = {}
    for use_kernel in (True, False):
        hidden, cache = T_.prefill(params, toks, cfg, use_kernel=use_kernel)
        outs[use_kernel] = T_.logits_fn(params, hidden).float()
        del cache
    logits_check("prefill_logits", outs, tokens=s)


def phase_serve(gpu: str):
    import numpy as np
    import torch
    import repro_torch.configs as configs
    from repro_torch.device import make_generator
    from repro_torch.models import transformer as T_
    from repro_torch.serving.engine import Request, make_engine

    cfg = configs.get("yi-6b")
    if (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) != (H, KV, D):
        fail(f"yi-6b attention is not {H}/{KV} heads of {D}")
    t0 = time.perf_counter()
    params = T_.init_params(make_generator(0, "cuda"), cfg)
    torch.cuda.synchronize()
    emit({"weights": cfg.name,
          "params": sum(int(x.numel()) for x in _leaves(params)),
          "bytes": sum(int(x.numel() * x.element_size())
                       for x in _leaves(params)),
          "init_s": time.perf_counter() - t0})
    phase_logits(params, cfg)

    paged_kw = dict(SERVE, engine="paged", prefill_buckets=BUCKETS)
    dense_kw = dict(engine="dense", slots=SLOTS, max_len=MAX_LEN,
                    prefill_buckets=BUCKETS)
    # warm-up (cuBLAS handles, first launches) on engines of their own
    for kw in (SERVE, paged_kw, dense_kw):
        warm = make_engine(params, cfg, **kw)
        warm.submit(Request(99, np.arange(300, dtype=np.int32)
                            % cfg.vocab_size, max_new_tokens=2))
        warm.run_to_completion()
        del warm

    counted = {}
    recs = {}
    for wave in range(3):
        eng = make_engine(params, cfg, **SERVE)
        reqs = make_requests(cfg.vocab_size)
        if wave == 0:
            recs["chunked"] = record_kernel_inputs(eng)
            n_rows = eng.kvc.pool.null_row + 1
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
        futs, wall = drive_wave(eng, reqs, late_rid=5, first_rid=1)
        extra = {"wave": wave, "counted": wave == 0}
        if wave == 0:
            counted["chunked"] = read_launches()
            extra.update(launches=counted["chunked"],
                         peak_memory_gb=torch.cuda.max_memory_allocated()
                         / 1e9)
        comps = check_wave(eng, reqs, futs, cfg.vocab_size, skipped=512)
        wave_line(eng, cfg, gpu, "chunked", reqs, comps, wall, **extra)
        del eng
    check_launches(cfg, "chunked", counted["chunked"], recs["chunked"],
                   (DECODE, PREFILL))

    # the whole-prompt engines take the chunked wave's 8 requests; the
    # paged one keeps compute skip on, but skips only full covers
    for engine, kw, skipped, ran in (
            ("paged", paged_kw, 0, (DECODE, FLASH)),
            ("dense", dense_kw, None, (FLASH,))):
        reqs = make_requests(cfg.vocab_size)
        eng = make_engine(params, cfg, **kw)
        recs[engine] = record_kernel_inputs(eng)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        late = (5, 1) if engine == "paged" else (None, None)
        futs, wall = drive_wave(eng, reqs, *late)
        counted[engine] = read_launches()
        comps = check_wave(eng, reqs, futs, cfg.vocab_size, skipped=skipped)
        wave_line(eng, cfg, gpu, engine, reqs, comps, wall, wave=0,
                  counted=True, launches=counted[engine],
                  prefills=len(recs[engine][FLASH]),
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        del eng
        check_launches(cfg, engine, counted[engine], recs[engine], ran)
    return counted, recs, n_rows


def phase_replay(gpu: str, rec, n_rows: int):
    """Every recorded main-path call of the paged kernels again, on
    random q and pools, against the plain version (fp32, bf16); then
    timed in bf16."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, times = {}, {}
    for name in (DECODE, PREFILL):
        recorded = rec[name]
        decode = name == DECODE
        calls = {}
        for dtype in (torch.float32, torch.bfloat16):
            kp = torch.randn(n_rows, PS, KV, D, generator=gen,
                             device="cuda").to(dtype)
            vp = torch.randn(n_rows, PS, KV, D, generator=gen,
                             device="cuda").to(dtype)
            calls[dtype] = []
            err_max = ratio_max = 0.0
            for tables, clocks in recorded:
                b = tables.shape[0]
                shape = (b, H, D) if decode else (b, CHUNK, H, D)
                q = torch.randn(*shape, generator=gen,
                                device="cuda").to(dtype)
                err, ratio = compare(name, q, kp, vp, tables, clocks)
                if ratio > 1.0:
                    fail(f"{name} disagrees with its plain version on a "
                         f"main-path call ({dtype}, clocks "
                         f"{clocks.tolist()}): max abs err {err}, "
                         f"{ratio} times its tolerance")
                err_max = max(err_max, err)
                ratio_max = max(ratio_max, ratio)
                calls[dtype].append((q, kp, vp, tables, clocks))
            clk = torch.cat([c for _, c in recorded])
            emit({"check": name, "inputs": "main path",
                  "dtype": str(dtype).split(".")[-1], "calls": len(recorded),
                  "table": list(recorded[0][0].shape),
                  "clock_min": int(clk.min()), "clock_max": int(clk.max()),
                  "max_abs_err": err_max, "err_over_tol": ratio_max,
                  "tol": TOL[str(dtype).split(".")[-1]], "ok": True})
            if dtype == torch.bfloat16:
                worst[name] = err_max
        del calls[torch.float32]
        times[name] = time_calls(name, calls[torch.bfloat16], gpu,
                                 inputs="main path",
                                 table=list(recorded[0][0].shape))
    return worst, times


def phase_replay_flash(gpu: str, shapes):
    """Every whole-prompt prefill of the counted paged wave: its flash
    call (causal, at the prompt's bucket) again on random inputs,
    against the plain version (fp32, bf16); then timed in bf16."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        calls = []
        err_max = ratio_max = 0.0
        for b, s in shapes:
            q, k, v = flash_inputs(gen, b, s, s, dtype)
            err, ratio = compare_flash(q, k, v)
            if ratio > 1.0:
                fail(f"{FLASH} disagrees with its plain version on a "
                     f"main-path call ({dtype}, B={b}, S={s}): max abs "
                     f"err {err}, {ratio} times its tolerance")
            err_max = max(err_max, err)
            ratio_max = max(ratio_max, ratio)
            calls.append((q, k, v))
        emit({"check": FLASH, "inputs": "main path", "dtype": dname,
              "calls": len(shapes), "buckets": [s for _, s in shapes],
              "max_abs_err": err_max, "err_over_tol": ratio_max,
              "tol": FLASH_TOL[dname], "ok": True})
        if dtype == torch.bfloat16:
            worst = err_max
            times = time_flash(calls, gpu, inputs="main path",
                               buckets=[s for _, s in shapes])
        del calls
    return worst, times


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the card")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             f"from a checkout of the repository")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash, paged

    # the fp32 plain versions must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"gpu": gpu})

    t0 = time.perf_counter()
    libs = build.build_all([paged.SOURCE, flash.SOURCE])
    emit({"build": [str(p.relative_to(ROOT)) for p in libs],
          "build_s": time.perf_counter() - t0})

    worst = phase_kernels(gpu)
    worst[FLASH] = phase_flash_kernel(gpu)
    counted, recs, n_rows = phase_serve(gpu)
    worst_main, times = phase_replay(gpu, recs["chunked"], n_rows)
    flash_shapes = [(b, s) for b, s in recs["paged"][FLASH]]
    worst_main[FLASH], times[FLASH] = phase_replay_flash(gpu, flash_shapes)

    # each kernel's launches come from its own path's counted wave: the
    # paged kernels from the chunked engine's, flash from the
    # whole-prompt paged engine's
    launches = {DECODE: counted["chunked"][DECODE],
                PREFILL: counted["chunked"][PREFILL],
                FLASH: counted["paged"][FLASH]}
    sources = {DECODE: paged.SOURCE, PREFILL: paged.SOURCE,
               FLASH: flash.SOURCE}
    replaces = {DECODE: "src/repro/kernels/attention/paged.py:96",
                PREFILL: "src/repro/kernels/attention/paged.py:207",
                FLASH: "src/repro/kernels/attention/flash.py:88"}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": str(sources[name].relative_to(ROOT)),
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": max(worst[name], worst_main[name]), **times[name]}
        for name in (DECODE, PREFILL, FLASH)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
