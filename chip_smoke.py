"""GPU smoke run of the PyTorch port: builds the CUDA kernels, holds
each against its plain PyTorch version, times them, and serves
full-width yi-6b through the chunked paged engine.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero before the
last line):

1. the card: ``nvidia-smi --query-gpu=name,power.limit`` as printed;
2. build: both paged-attention kernels compiled by nvcc from
   ``src/repro_torch/kernels/attention/csrc/`` into
   ``build/repro_torch_kernels/``;
3. kernel against plain version on random inputs at the serve
   configuration's shapes: yi-6b's attention (H 32, KV 4, D 128),
   page 16, block tables of max_len / page = 128 pages, decode over
   the engine's 8 slots with clocks up to 2047 and two idle slots
   parked on the null row at position 0 (as a released slot is
   left), prefill of the engine's B 1 x T 256 chunk at starts up to
   1792, and B 8 prefill besides; fp32 and bf16, flat and sharded
   pools, window 0 and 512.  Tolerances: fp32 atol 1e-5; bf16, per
   element, 2^-7 * (sum_j p_j |v_j| + |o|): one bf16 ulp of each
   softmax weight times its value plus one ulp of the output, which is
   what the two versions, rounding p and o to bf16 from fp32 values
   that differ in their last bits, can move an element by
   (sum_j p_j |v_j| is the plain version run on |V|);
4. end to end: random full-width yi-6b bf16 weights from a seed;
   one full-width chunk's logits through the kernels held against the
   plain versions'; then ``make_engine(engine="chunked", slots=8,
   max_len=2048, page_size=16, chunk_size=256, step_tokens=512,
   prefix_cache_compute=True)`` serves 8 requests of 200-1500 prompt
   tokens (two sharing a 512-token head, the second arriving once the
   first is resident, so compute skip resumes it past the head), 32
   new tokens each.  The kernels' launch counts are zeroed just before
   the first wave and read just after it, and that wave keeps a copy
   of the block tables and clocks of every kernel call it makes.  Two
   more waves on fresh engines give the spread of the end-to-end
   figures within one run;
5. replay: every kernel call of the counted wave, at its own block
   tables and clocks, run again on random q and pools (fp32 and bf16)
   and held against the plain version, then timed in bf16 as the whole
   recorded sequence: kernel, plain version, one
   `scaled_dot_product_attention` call per recorded call on
   pre-gathered K/V (a yardstick the port never calls) and the bound,
   each per launch.  The bound of a call is the larger of the bytes it
   must move (each distinct live K/V page once, q and o once) over
   3.35 TB/s and its flops (4 * head_dim per visible query, head and
   key) over 989 TFLOP/s (H100 SXM data-sheet peaks);
6. the kernels line: route, source, the TPU kernel replaced, launches
   on the main path, error, times and bound (step 5's);
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
FP32_ATOL = 1e-5
BF16_ULP = 2.0 ** -7               # a bf16 ulp, relative, at its largest
TOL = {"float32": "atol 1e-5",
       "bfloat16": "2^-7 * (sum_j p_j |v_j| + |o|) per element"}
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


def compare(name, q, kp, vp, tables, clocks, window=0):
    """(max abs error, max error over its tolerance) of the kernel
    against its plain version; the check passes when the second is at
    most 1 and the output is finite."""
    import torch
    kern, plain = kernel_and_plain(name, q, kp, vp, tables, clocks, window)
    got, want = kern().float(), plain().float()
    if q.dtype == torch.float32:
        tol = torch.full_like(want, FP32_ATOL)
    else:
        _, plain_abs = kernel_and_plain(name, q, kp, vp.abs(), tables,
                                        clocks, window)
        tol = BF16_ULP * (plain_abs().float() + want.abs())
    diff = (got - want).abs()
    ratio = (diff / tol).max().item()
    if not bool(torch.isfinite(got).all()):
        ratio = float("inf")
    return diff.max().item(), ratio


def time_calls(name, calls, gpu, **line):
    """Time a list of (q, kp, vp, tables, clocks) calls of one kernel in
    bf16: kernel, plain version, SDPA and bound, each per launch.
    Kernel and plain run plain, kernel, kernel, plain, the lower of
    each pair kept."""
    decode = name == DECODE
    thunks = [kernel_and_plain(name, *c) for c in calls]
    kern = [k for k, _ in thunks]
    plain = [p for _, p in thunks]
    lib = [sdpa_call(*c, 0, decode) for c in calls]
    iters = max(2, 40 // len(calls))
    p1 = time_ms(plain, iters)
    k1 = time_ms(kern, iters)
    k2 = time_ms(kern, iters)
    p2 = time_ms(plain, iters)
    lib_ms = time_ms(lib, iters)
    del lib
    tb = to = tmax = 0.0
    for q, _, _, tables, clocks in calls:
        b_ms, o_ms = bound_times(q, tables, clocks, 0, decode)
        tb, to, tmax = tb + b_ms, to + o_ms, tmax + max(b_ms, o_ms)
    out = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
           "library_ms": lib_ms, "bound_ms": tmax / len(calls),
           "bound_by": "bytes" if tb >= to else "operations"}
    emit({"timing": name, "gpu": gpu, "dtype": "bfloat16",
          "calls": len(calls), **line, "kernel_ms": [k1, k2],
          "plain_ms": [p1, p2], "library_ms": lib_ms,
          "bound_ms": out["bound_ms"], "bound_by": out["bound_by"]})
    return out


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
    and prefill chunk `eng` runs: what its kernel calls are given."""
    rec = {DECODE: [], PREFILL: []}
    batch_inputs, chunk_step = eng.kvc.batch_inputs, eng._chunk_step

    def batch_inputs_rec():
        b = batch_inputs()
        rec[DECODE].append((b["block_tables"].clone(),
                            b["positions"].clone()))
        return b

    def chunk_step_rec(toks, tables, start, rows, last):
        rec[PREFILL].append((tables.clone(), start.clone()))
        return chunk_step(toks, tables, start, rows, last)

    eng.kvc.batch_inputs = batch_inputs_rec
    eng._chunk_step = chunk_step_rec
    return rec


def drive_wave(eng, reqs):
    """Serve `reqs` to completion; the second prompt with the shared
    head arrives once the first one's pages are resident, so it
    resumes past the cached head.  Returns (futures, wall seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, late = reqs[1], reqs[5]
    futs = {r.rid: eng.submit(r) for r in reqs if r is not late}
    for _ in range(500):
        if any(st["req"].rid == first.rid and st["phase"] == "decode"
               for st in eng.active.values()):
            break
        eng.step()
    else:
        fail(f"request {first.rid} never finished its prefill")
    futs[late.rid] = eng.submit(late)
    eng.run_to_completion()
    torch.cuda.synchronize()
    return futs, time.perf_counter() - t0


def check_wave(eng, reqs, futs, vocab: int):
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
    s = eng.stats()
    if s["prefill_tokens_skipped"] != 512:
        fail(f"compute skip resumed past {s['prefill_tokens_skipped']} "
             f"tokens of the shared 512-token head")
    return comps, s


def phase_logits(params, cfg):
    """One full-width 256-token chunk at a (1, P) table, through the
    kernels and through the plain versions."""
    import torch
    from repro_torch.models import transformer as T_
    n = CHUNK // PS
    tables = torch.full((1, P), n, dtype=torch.int32, device="cuda")
    tables[0, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, CHUNK),
                                     device="cuda"),
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
    diff = (outs[True] - outs[False]).abs().max().item()
    scale = outs[False].abs().max().item()
    finite = bool(torch.isfinite(outs[True]).all())
    top2 = outs[False].topk(2, dim=-1).values
    argmax_equal = bool((outs[True].argmax(-1) ==
                         outs[False].argmax(-1)).all())
    ok = finite and diff <= LOGIT_REL_TOL * scale and argmax_equal
    emit({"check": "prefill_chunk_logits", "shape": list(outs[True].shape),
          "table_pages": P, "max_abs_diff": diff, "max_abs_logit": scale,
          "rel_tol": LOGIT_REL_TOL, "finite": finite,
          "argmax_equal": argmax_equal,
          "plain_top2_margin": (top2[..., 0] - top2[..., 1]).min().item(),
          "ok": ok})
    if not ok:
        fail(f"full-width chunk logits: kernel vs plain differ by {diff} "
             f"(largest logit {scale}), argmax equal: {argmax_equal}")


def phase_serve(gpu: str):
    import numpy as np
    import torch
    import repro_torch.configs as configs
    from repro_torch.device import make_generator
    from repro_torch.kernels.attention import paged
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

    # warm-up (cuBLAS handles, first launches) on its own engine
    warm = make_engine(params, cfg, **SERVE)
    warm.submit(Request(99, np.arange(300, dtype=np.int32) % cfg.vocab_size,
                        max_new_tokens=2))
    warm.run_to_completion()
    del warm

    rec = n_rows = launches = None
    for wave in range(3):
        eng = make_engine(params, cfg, **SERVE)
        reqs = make_requests(cfg.vocab_size)
        if wave == 0:
            rec = record_kernel_inputs(eng)
            n_rows = eng.kvc.pool.null_row + 1
            torch.cuda.reset_peak_memory_stats()
            paged.reset_launches()
        futs, wall = drive_wave(eng, reqs)
        if wave == 0:
            launches = dict(paged.LAUNCHES)
        comps, s = check_wave(eng, reqs, futs, cfg.vocab_size)
        new_tokens = sum(len(c.tokens) for c in comps)
        prompt_tokens = sum(len(r.prompt) for r in reqs)
        emit({"serve": cfg.name, "gpu": gpu, "wave": wave,
              "counted": wave == 0, "requests": len(comps),
              "prompt_tokens": prompt_tokens, "new_tokens": new_tokens,
              "wall_s": wall, "new_tokens_per_s": new_tokens / wall,
              "total_tokens_per_s": (new_tokens + prompt_tokens) / wall,
              "steps": s["steps"],
              "ttft_ms": {"p50": s["ttft_p50_ms"], "mean": s["mean_ttft_ms"]},
              "itl_ms": {"p50": s["itl_p50_ms"], "p95": s["itl_p95_ms"],
                         "mean": s["mean_itl_ms"]},
              "prefix_partial_hits": s["prefix_partial_hits"],
              "prefill_tokens_skipped": s["prefill_tokens_skipped"],
              "preemptions": s["preemptions"],
              **({"peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "launches": launches} if wave == 0 else {})})
        del eng
    for name, n in launches.items():
        if n < cfg.n_layers:
            fail(f"{name} launched {n} times on the main path "
                 f"(< {cfg.n_layers}, one per layer)")
        if n != cfg.n_layers * len(rec[name]):
            fail(f"{name}: {n} launches, but {len(rec[name])} recorded "
                 f"calls of {cfg.n_layers} layers")
    return launches, rec, n_rows


def phase_replay(gpu: str, rec, n_rows: int):
    """Every recorded main-path call again, on random q and pools,
    against the plain version (fp32, bf16); then timed in bf16."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, times = {}, {}
    for name, recorded in rec.items():
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
    from repro_torch.kernels.attention import paged

    # the fp32 plain versions must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"gpu": gpu})

    t0 = time.perf_counter()
    libs = build.build_all([paged.SOURCE])
    emit({"build": [str(p.relative_to(ROOT)) for p in libs],
          "build_s": time.perf_counter() - t0})

    worst = phase_kernels(gpu)
    launches, rec, n_rows = phase_serve(gpu)
    worst_main, times = phase_replay(gpu, rec, n_rows)

    source = str(paged.SOURCE.relative_to(ROOT))
    replaces = {DECODE: "src/repro/kernels/attention/paged.py:96",
                PREFILL: "src/repro/kernels/attention/paged.py:207"}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": max(worst[name], worst_main[name]), **times[name]}
        for name in (DECODE, PREFILL)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
