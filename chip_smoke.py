"""GPU smoke run of the PyTorch port: builds the CUDA kernels, holds
each against its plain PyTorch version, times them, and serves
full-width yi-6b through the chunked, the whole-prompt paged and the
dense engines, then full-width falcon-mamba-7b (Mamba-1) through the
dense engine, then runs the compiled AMR engine at the production
cell (8,388,608 points).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero before the
last line):

1. the card: ``nvidia-smi --query-gpu=name,power.limit`` as printed;
2. build: the paged-attention, flash-attention, selective-scan and
   RK3-stencil kernels compiled by nvcc from
   ``src/repro_torch/kernels/*/csrc/``
   into ``build/repro_torch_kernels/``, one nvcc each, started
   together; then the ``-Xptxas -v`` lines (registers, stack, spills)
   of every instantiation of the tensor-core attention core that the
   two attention sources share (`attention_core.cuh`), of the split
   decode kernel and its combine, with their dynamic shared memory, and
   of the two selective-scan kernels (sequential and chunked);
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
   not, window 0 and S/3.  The same checks, fewer shapes, at the
   other served head layouts: h2o-danube-3-4b's (H 32, KV 8, D 120,
   window 512) and musicgen-large's (H 32, KV 32, D 64): decode and
   the B 1 x T 256 prefill, and flash at S 1000 and at 768 queries
   continuing at 768.  Decode also at clocks on and beside page and
   split edges (EDGE_CLOCKS: 0, 15, 16, 127, 128, 2047), one slot at a
   time and all eight together with a slot at 0 beside one at 2047,
   window 0 and 512 (whose leading splits lie wholly behind it), flat
   and sharded pools, each line with the split plan and the splits
   that read a key.  Tolerances: fp32 atol 1e-5 (paged; the
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
   calls) and the bound, each per launch; the kernel and SDPA sequences
   also as CUDA graphs (``kernel_graph_ms``, ``library_graph_ms``: the
   device's time without the host's launch overhead, which the short
   calls are bound by); the decode lines also carry its split plan
   (pages per split, splits) and its workspace bytes.  The bound of a
   call is the larger of the bytes it must move over 3.35 TB/s (paged: each
   distinct live K/V page once, q and o once; flash: q, k, v and o
   once) and its flops (4 * head_dim per visible query, head and key:
   the live causal area) over 989 TFLOP/s (H100 SXM data-sheet peaks);
6. selective scan (the yi-6b weights freed first): the kernel against
   its plain version (`ref.selective_scan_fused_ref`) on random inputs
   at falcon-mamba-7b's d_inner 8192 and state 16, at the reference
   test's input scale: prefill B 1 from a zero state at S over the
   dense buckets (256-1536) and S 1000, decode B 8 x S 1 from a random
   state; y and the final state at fp32 atol 1e-5 + rtol 1e-5 (the
   reference's scan tolerance, `test_kernels.py`), and once more with
   the final state written in place over the initial one (as the
   decode step does);
7. falcon-mamba-7b end to end: random bf16 weights from seed 0 (64
   layers, d_model 4096); a 1536-token prompt's logits through
   `T.prefill`, then three `T.decode_step`s from its state, through the
   kernel and through the plain path (the chunked associative scan and
   the sequential decode step), held like yi-6b's (2.5% of the largest
   logit, or twice a control's distance (see CONTROL_FACTOR), same
   argmax).  Every layer's scan inputs, in the prefill and in each
   decode step on the kernel path, are held as they pass: the kernel
   against its plain version on them, at a bound derived from the
   rounding (``scan_serve_bounds``).  Then ``make_engine(params,
   cfg)`` (which falls back to the dense engine: 8 slots of 2048, the
   buckets 256-1536) serves the 8 requests of step 4 (vocab 65024, 32
   new tokens each), one counted wave: the scan's launches must equal
   n_layers x (prefills + decode steps) and the attention kernels'
   stay 0;
8. replay: each recorded scan call of that wave (prefill (1, bucket)
   from a zero state, decode (8, 1) from a state) again on random
   inputs against the plain version, then timed as the whole sequence,
   and its prefill and decode calls apart as extra lines, each also as
   a CUDA graph (``kernel_graph_ms``: decode's device time without the
   host's launch cost) (no single PyTorch call computes a selective
   scan: library time null).  Bound: the largest of the bytes (dt, x,
   y (B, S, D), B, C (B, S, N), a, h0 when given, hT, all f32) over
   3.35 TB/s, the flops (six per (t, d, n), one per (t, d)) over the
   67 TFLOP/s float32 peak, and the exps (one per (t, d, n)) over the
   special-function units' rate (SFU_PER_S); each timing line names
   the term that bounds it (``bound_by``: ``sfu`` for the exps, which
   the kernels line reports as ``operations``);
9. RK3 stencil (falcon-mamba's weights freed first): the kernel
   against its plain version (`ref.stencil_rk3_ref`) on random inputs
   at atol 1e-6 (the reference's stencil tolerance): the reference
   test's shapes (grain 8/32/128, 1 or 4 blocks, dr 0.05, dt 0.01) and
   the production cell's (4096 blocks of grain 2048, at widths g + 2H
   and g + 4H, its dr and dt), p 1/3/7, input scales 0.01 and 0.1;
   the first block's left side and the last block's right side
   physical, and random blocks with both sides physical;
10. the compiled AMR engine at the production cell of
   `launch/dryrun.py` (WaveProblem(rmax=100, amplitude=0.004),
   256 localities x 16 slots x grain 2048, 16 steps per `step_fn`
   call), with one and two steps per halo exchange: through the
   kernel (one counted call: launch counts zeroed just before it and
   read just after, the stencil's must be 16 and the others' 0; with
   one step per exchange its kernel calls recorded), through the plain
   path and through the global oracle `reference_uniform`, held
   together at atol 1e-6, energy and max |u| before and after; the
   step timed with CUDA events beside its halo assembly, and the host
   clock of one call (cell updates per second);
11. replay: the recorded kernel calls on their own inputs against the
   plain version, then timed as the whole sequence (no single PyTorch
   call computes the step: library time null); bound the larger of
   the bytes (u_ext, r_ext, flags read once, the output written once)
   over 3.35 TB/s and 60 float32 operations per point (the count
   `launch/dryrun.py` uses) over 67 TFLOP/s; the step split into the
   kernel, the halo assembly and the rest;
12. the kernels line: route, source, the TPU kernel replaced, launches
   on its path's counted run, error, times and bound (steps 5, 8 and
   11);
13. ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16, data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM float32 (no tensor cores)
# exps a second: 16 special-function results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) x 132 SMs x 1.98 GHz, the clock behind the 67 TFLOP/s
# figure (132 x 128 x 2 x 1.98e9)
SFU_PER_S = 132 * 16 * 1.98e9
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
# falcon-mamba-7b's 64 bf16 layers amplify float-order differences of
# the f32 scan past that: two plain versions of the scan (the chunked
# associative scan and the sequential recurrence), both exact up to
# rounding, give prefill logits 2.9% of the largest apart on an H100.
# So its kernel-path logits are held to the larger of LOGIT_REL_TOL and
# CONTROL_FACTOR times that control difference, measured in the same
# run; the kernel itself is held to the rounding on the layers' own
# scan inputs (`scan_serve_bounds`)
CONTROL_FACTOR = 2.0

# the serve configuration; the kernel checks take their shapes from it
PS, MAX_LEN, SLOTS, CHUNK = 16, 2048, 8, 256
P = MAX_LEN // PS                  # the engine's block-table width
SERVE = dict(engine="chunked", slots=SLOTS, max_len=MAX_LEN, page_size=PS,
             chunk_size=CHUNK, step_tokens=512, prefix_cache_compute=True)
H, KV, D = 32, 4, 128              # yi-6b's attention
IDLE = (1, 6)                      # idle slots of the synthetic decode batch
DECODE, PREFILL = "paged_attention_bhd", "paged_prefill_attention_btd"
FLASH = "flash_attention_bhsd"
SCAN = "selective_scan"
SCAN_D, SCAN_N = 8192, 16          # falcon-mamba-7b's d_inner and state
SCAN_LENGTHS = (256, 512, 768, 1024, 1280, 1536, 1000)
SCAN_ATOL = SCAN_RTOL = 1e-5       # the reference's scan tolerance
STENCIL = "stencil_rk3"
STENCIL_H = 3                      # the stencil's halo (amr/wave.py H)
STENCIL_ATOL = 1e-6                # the reference's stencil tolerance
# the production AMR cell (`launch/dryrun.py` run_amr_cell): 256
# localities of 16 blocks of 2048 points, 16 steps per call
AMR_PROB = dict(rmax=100.0, amplitude=0.004)
AMR_CFG = dict(grain=2048, slots=16, n_steps=16)
AMR_N_LOC = 256
AMR_FLOPS_PER_POINT = 60           # per point and step (dryrun.py)
UNIT_ROUNDOFF = 2.0 ** -24         # float32
SCAN_ULPS = 15                     # per step, kernel vs plain
# the whole-prompt engines' prefill buckets: every prompt of the wave
# (200-1500 tokens) lands on one of them
BUCKETS = (256, 512, 768, 1024, 1280, 1536)
# flash kernel checks at B 1: each bucket, and a length that is not a
# multiple of 128, as (Sq, Sk, q_offset): the whole prompt, and its
# second half continuing the first (q_offset set)
FLASH_LENGTHS = BUCKETS + (1000,)
FLASH_SHAPES = [shape for s in FLASH_LENGTHS
                for shape in ((s, s, 0), (s - s // 2, s, s // 2))]
# the other served head layouts, checked on random inputs beside
# yi-6b's: h2o-danube-3-4b (32/8 heads of 120, a 512-token window) and
# musicgen-large (32/32 heads of 64), as (name, (H, KV, D), window)
OTHER_HEADS = (("h2o-danube-3-4b", (32, 8, 120), 512),
               ("musicgen-large", (32, 32, 64), 0))
OTHER_FLASH_SHAPES = ((1000, 1000, 0), (768, 1536, 768))
# the attention kernels rebuilt on the tensor cores, and the split
# decode kernel with its combine: their ptxas lines are printed after
# the build
TC_KERNEL = "tc_kernel"
DECODE_KERNEL = "decode_"
SCAN_KERNEL = "selective_scan"
# the CUDA-core decode kernel's dynamic shared memory: 4 warps x a ring
# of 4 bf16 (2 fp32) stages x K and V tiles of 1024 elements
# (paged_attention.cu)
DECODE_SMEM_BYTES = 65536
# decode clocks on and beside page (16) and split (128 at the serve
# path) edges, and the table's last key; checked one slot at a time and
# all together beside a slot at 0 and one at 2047
EDGE_CLOCKS = (0, 15, 16, 127, 128, 2047)


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


def ptxas_report(log: str, match: str):
    """The ``-Xptxas -v`` lines (registers, shared memory, stack and
    spills) of every entry function of a build log whose mangled name
    contains `match`, as {"function": name, "report": [lines]}."""
    out = []
    keep = False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            keep = match in m.group(1)
            if keep:
                out.append({"function": m.group(1), "report": []})
        elif keep and re.search(r"spill|Used \d+ registers", line):
            out[-1]["report"].append(line.split(":", 1)[-1].strip())
    return out


def tc_shape(function: str):
    """The template arguments of a tensor-core attention instantiation
    (`attention_core.cuh`: KD = padded head dim / 16, MR row groups, NG
    key groups) read from its mangled name, and the dynamic shared
    memory that the header's `smem_bytes` gives it: 64 MR + 2 NS NG KN
    rows of 16 KD bf16, NS = 2 stages, KN the keys per warp-group tile
    (`tile_keys`: 32 above KD 8, else 64 at NG 2 and 128 at NG 1)."""
    m = re.search(r"(FlashTC|PrefillTC)ELi(\d+)ELi(\d+)ELi(\d+)E", function)
    if not m:
        return {}
    kd, mr, ng = (int(x) for x in m.groups()[1:])
    kn = 32 if kd > 8 else (64 if ng == 2 else 128)
    return {"kernel": m.group(1), "kd": kd, "mr": mr, "ng": ng,
            "dynamic_smem_bytes": 2 * (64 * mr + 4 * ng * kn) * 16 * kd}


def decode_shape(function: str):
    """The template arguments of a decode instantiation read from its
    mangled name, with its dynamic shared memory: the tensor-core kernel
    (KD = padded head dim / 16; HI, more than 8 query heads a KV head;
    VEC, 16-byte copies) takes 4 warps x 3 stages x K and V tiles of 16
    keys x (16 KD + 8) bf16; the CUDA-core kernel (dtype, ROWS query
    heads a block, VEC) takes DECODE_SMEM_BYTES; the combine none."""
    m = re.search(r"decode_mma_kernelILi(\d+)ELb([01])ELb([01])E", function)
    if m:
        kd = int(m.group(1))
        return {"kernel": "decode_mma", "dtype": "bfloat16", "kd": kd,
                "hi": m.group(2) == "1", "vec": m.group(3) == "1",
                "dynamic_smem_bytes": 4 * 3 * 2 * 16 * (16 * kd + 8) * 2}
    m = re.search(r"decode_(fma|combine)_kernelI(13__nv_bfloat16|f)"
                  r"(?:Li(\d+)ELb([01])E)?", function)
    if not m:
        return {}
    out = {"kernel": f"decode_{m.group(1)}",
           "dtype": "float32" if m.group(2) == "f" else "bfloat16"}
    if m.group(3):
        out.update(rows=int(m.group(3)), vec=m.group(4) == "1",
                   dynamic_smem_bytes=DECODE_SMEM_BYTES)
    return out


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

def make_inputs(gen, b, t, dtype, sharded, decode, heads=(H, KV, D),
                clocks=None):
    """Random pool whose last row is the null row; block tables of
    width P over random rows up to each slot's last live page and the
    null row past it.  Decode: clocks in [0, MAX_LEN), the IDLE slots
    on the null row at position 0, or the given `clocks` (b of them).
    Prefill: page-aligned starts in [0, MAX_LEN - t].  `heads` is (H,
    KV, D)."""
    import torch
    H, KV, D = heads
    n = b * P + 2
    null = n - 1
    kp = torch.randn(n, PS, KV, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(n, PS, KV, D, generator=gen, device="cuda").to(dtype)
    given = clocks is not None
    if decode:
        clocks = torch.tensor(clocks, dtype=torch.int32, device="cuda") \
            if given else torch.randint(0, MAX_LEN, (b,), generator=gen,
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
    if decode and not given:
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


def graph_ms(fns, iters: int) -> float:
    """Mean ms per call of the list `fns` captured once in a CUDA graph
    and replayed `iters` times (after a warm-up pass on a side stream
    and one replay): the device's time for the sequence without the
    host's launch overhead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * len(fns))
    del graph
    return ms


def time_sequence(name, kern, plain, lib, bounds, gpu, dtype="bfloat16",
                  graph=False, **line):
    """Time lists of thunks — kernel, plain version, library call (None
    where no PyTorch call computes the function) — and average the
    bounds ((bytes_ms, ops_ms) or (bytes_ms, ops_ms, sfu_ms) per call),
    each per launch; ``bound_by`` names the term with the largest sum
    (the kernels line reports ``sfu`` as ``operations``).  Kernel and
    plain run plain, kernel, kernel, plain, the lower of each pair
    kept.  With `graph`, the kernel and library sequences are also
    timed as CUDA graphs (`graph_ms`, an extra line field): calls short
    enough to be bound by the host's launch rate show their device time
    there."""
    iters = max(2, 40 // len(kern))
    p1 = time_ms(plain, iters)
    k1 = time_ms(kern, iters)
    k2 = time_ms(kern, iters)
    p2 = time_ms(plain, iters)
    lib_ms = None if lib is None else time_ms(lib, iters)
    if graph:
        line.update(kernel_graph_ms=graph_ms(kern, iters),
                    library_graph_ms=None if lib is None
                    else graph_ms(lib, iters))
    terms = [sum(b[i] for b in bounds) for i in range(len(bounds[0]))]
    by = ("bytes", "operations", "sfu")[terms.index(max(terms))]
    out = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
           "library_ms": lib_ms,
           "bound_ms": sum(max(b) for b in bounds) / len(bounds),
           "bound_by": "operations" if by == "sfu" else by}
    emit({"timing": name, "gpu": gpu, "dtype": dtype,
          "calls": len(kern), **line, "kernel_ms": [k1, k2],
          "plain_ms": [p1, p2], "library_ms": lib_ms,
          "bound_ms": out["bound_ms"], "bound_by": by,
          "bound_terms_ms": [t / len(bounds) for t in terms]})
    return out


def decode_split(q, kp, tables):
    """The split plan of a decode call (`paged.decode_split_plan` on
    this card) and the bytes of its f32 workspace."""
    import torch
    from repro_torch.kernels.attention import paged
    b, h, d = q.shape
    pps, splits = paged.decode_split_plan(
        b, h, kp.shape[-2], tables.shape[1], PS,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    return {"pages_per_split": pps, "splits": splits,
            "workspace_bytes": b * h * splits * (d + 2) * 4}


def live_splits(plan, clock, window):
    """How many splits of a slot at `clock` read any key
    (`paged.split_key_range`); the others write an empty partial."""
    from repro_torch.kernels.attention import paged
    n = 0
    for s in range(plan["splits"]):
        first, last = paged.split_key_range(s, plan["pages_per_split"], PS,
                                            P, clock, window)
        n += first <= last
    return n


def time_calls(name, calls, gpu, **line):
    """Time a list of (q, kp, vp, tables, clocks) calls of one paged
    kernel in bf16 (`time_sequence`); the library call is SDPA on
    pre-gathered K/V with the absolute-position mask."""
    decode = name == DECODE
    thunks = [kernel_and_plain(name, *c) for c in calls]
    lib = [sdpa_call(*c, 0, decode) for c in calls]
    bounds = [bound_times(q, tables, clocks, 0, decode)
              for q, _, _, tables, clocks in calls]
    if decode:
        line.update(decode_split(calls[0][0], calls[0][1], calls[0][3]))
    return time_sequence(name, [k for k, _ in thunks],
                         [p for _, p in thunks], lib, bounds, gpu,
                         graph=True, **line)


# -- flash attention -------------------------------------------------------

def flash_inputs(gen, b, sq, sk, dtype, heads=(H, KV, D)):
    import torch
    H, KV, D = heads
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
                         graph=True, **line)


# -- phases ----------------------------------------------------------------

def phase_kernels(gpu: str):
    """Random inputs at the serve configuration's shapes, every dtype,
    pool layout and window; decode at the EDGE_CLOCKS; B 8 timings as
    extra lines."""
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
    # the other served head layouts, flat pools, at their windows
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for model, heads, window in OTHER_HEADS:
            for name, b, t in shapes[:2]:
                q, kp, vp, tables, clocks = make_inputs(
                    gen, b, t, dtype, False, name == DECODE, heads)
                err, ratio = compare(name, q, kp, vp, tables, clocks,
                                     window)
                emit({"check": name, "inputs": "random", "heads": model,
                      "h_kv_d": list(heads), "dtype": dname,
                      "window": window, "batch": b, "tokens": t,
                      "clocks": clocks.tolist(), "max_abs_err": err,
                      "err_over_tol": ratio, "tol": TOL[dname],
                      "ok": ratio <= 1.0})
                if ratio > 1.0:
                    fail(f"{name} disagrees with its plain version at "
                         f"{model}'s heads ({dtype}, window={window}, "
                         f"B={b}): max abs err {err}, {ratio} times its "
                         f"tolerance")
                if dtype == torch.bfloat16:
                    worst[name] = max(worst[name], err)
    # decode at clocks on and beside page and split edges, with and
    # without a window that leaves the leading splits behind it
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for clocks in [(c,) for c in EDGE_CLOCKS] + \
                [EDGE_CLOCKS + (0, MAX_LEN - 1)]:
            for window in (0, 512):
                for sharded in (False, True)[:1 + (len(clocks) > 1)]:
                    q, kp, vp, tables, clk = make_inputs(
                        gen, len(clocks), 1, dtype, sharded, True,
                        clocks=clocks)
                    err, ratio = compare(DECODE, q, kp, vp, tables, clk,
                                         window)
                    plan = decode_split(q, kp, tables)
                    live = [live_splits(plan, c, window) for c in clocks]
                    emit({"check": DECODE, "inputs": "split edges",
                          "dtype": dname,
                          "pool": "sharded" if sharded else "flat",
                          "window": window, "batch": len(clocks),
                          "clocks": list(clocks), **plan,
                          "live_splits": live, "max_abs_err": err,
                          "err_over_tol": ratio, "tol": TOL[dname],
                          "ok": ratio <= 1.0})
                    if ratio > 1.0:
                        fail(f"{DECODE} disagrees with its plain version "
                             f"at clocks {list(clocks)} ({dtype}, "
                             f"sharded={sharded}, window={window}): max "
                             f"abs err {err}, {ratio} times its tolerance")
                    if dtype == torch.bfloat16:
                        worst[DECODE] = max(worst[DECODE], err)
    for name, b, t in ((DECODE, SLOTS, 1), (PREFILL, 8, CHUNK)):
        call = make_inputs(gen, b, t, torch.bfloat16, False, name == DECODE)
        time_calls(name, [call], gpu, inputs="random", batch=b, tokens=t,
                   table_pages=P)
    return worst


def phase_flash_kernel(gpu: str):
    """The flash kernel on random inputs at yi-6b's heads, B 1: every
    (Sq, Sk, q_offset) of FLASH_SHAPES, fp32 and bf16, causal and not,
    window 0 and a window of a third of Sk (shorter than the sequence,
    not a multiple of the key tile); at the OTHER_HEADS layouts, every
    shape of OTHER_FLASH_SHAPES, causal and not, at their windows; the
    longest bucket's causal call timed as an extra line."""
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
        for model, heads, window in OTHER_HEADS:
            for sq, sk, off in OTHER_FLASH_SHAPES:
                for causal in (True, False):
                    q, k, v = flash_inputs(gen, b, sq, sk, dtype, heads)
                    err, ratio = compare_flash(q, k, v, causal=causal,
                                               window=window, q_offset=off)
                    emit({"check": FLASH, "inputs": "random",
                          "heads": model, "h_kv_d": list(heads),
                          "dtype": dname, "batch": b, "sq": sq, "sk": sk,
                          "q_offset": off, "causal": causal,
                          "window": window, "max_abs_err": err,
                          "err_over_tol": ratio, "tol": FLASH_TOL[dname],
                          "ok": ratio <= 1.0})
                    if ratio > 1.0:
                        fail(f"{FLASH} disagrees with its plain version "
                             f"at {model}'s heads ({dtype}, Sq={sq}, "
                             f"Sk={sk}, q_offset={off}, causal={causal}, "
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
    from repro_torch.kernels.scan import scan
    from repro_torch.kernels.stencil import stencil
    paged.reset_launches()
    flash.reset_launches()
    scan.reset_launches()
    stencil.reset_launches()


def read_launches():
    from repro_torch.kernels.attention import flash, paged
    from repro_torch.kernels.scan import scan
    from repro_torch.kernels.stencil import stencil
    return {**paged.LAUNCHES, **flash.LAUNCHES, **scan.LAUNCHES,
            **stencil.LAUNCHES}


def check_launches(cfg, engine, launches, rec, ran):
    """Every kernel the wave's path runs launched n_layers times per
    recorded call, and the others not at all."""
    for name, n in launches.items():
        want = cfg.n_layers * len(rec[name]) if name in ran else 0
        if n != want or (name in ran and n < cfg.n_layers):
            fail(f"{engine} wave: {name} launched {n} times, but "
                 f"{len(rec.get(name, ()))} recorded calls of "
                 f"{cfg.n_layers} layers make {want}")


def logits_check(name, outs, control=None, **line):
    """Kernel vs plain logits: within LOGIT_REL_TOL of the largest
    plain logit, same argmax, finite.  With `control` (logits of a
    second plain float order), within the larger of that and
    CONTROL_FACTOR times the control's own distance from plain."""
    import torch
    diff = (outs[True] - outs[False]).abs().max().item()
    scale = outs[False].abs().max().item()
    limit = LOGIT_REL_TOL * scale
    if control is not None:
        control_diff = (control - outs[False]).abs().max().item()
        limit = max(limit, CONTROL_FACTOR * control_diff)
        line.update(control_max_abs_diff=control_diff,
                    control_factor=CONTROL_FACTOR)
    finite = bool(torch.isfinite(outs[True]).all())
    top2 = outs[False].topk(2, dim=-1).values
    argmax_equal = bool((outs[True].argmax(-1) ==
                         outs[False].argmax(-1)).all())
    ok = finite and diff <= limit and argmax_equal
    emit({"check": name, "shape": list(outs[True].shape), **line,
          "max_abs_diff": diff, "max_abs_logit": scale,
          "rel_tol": LOGIT_REL_TOL, "limit": limit, "finite": finite,
          "argmax_equal": argmax_equal,
          "plain_top2_margin": (top2[..., 0] - top2[..., 1]).min().item(),
          "ok": ok})
    if not ok:
        fail(f"{name}: kernel vs plain differ by {diff} (largest logit "
             f"{scale}, limit {limit}), argmax equal: {argmax_equal}")


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


# -- selective scan (falcon-mamba-7b) ---------------------------------------

def scan_inputs(gen, b, s, with_state):
    """Random inputs of the fused scan at the reference test's scale
    (`test_kernels.py` draws da = exp(-|N(0,1)|), dbx = 0.1 N(0,1),
    c = N(0,1)): dt = |N(0,1)| and a = -U(0.5, 1.5), so da = exp(dt a)
    spans the same range; x, b = 0.3 N(0,1), so dbx = dt x b is of
    dbx's size; c = N(0,1); h0 = 0.3 N(0,1), or None (zero state)."""
    import torch
    kw = dict(generator=gen, device="cuda")
    dt = torch.randn(b, s, SCAN_D, **kw).abs()
    x = torch.randn(b, s, SCAN_D, **kw) * 0.3
    bm = torch.randn(b, s, SCAN_N, **kw) * 0.3
    cm = torch.randn(b, s, SCAN_N, **kw)
    a = -(torch.rand(SCAN_D, SCAN_N, **kw) + 0.5)
    h0 = torch.randn(b, SCAN_D, SCAN_N, **kw) * 0.3 if with_state else None
    return dt, x, bm, cm, a, h0


def scan_serve_bounds(dt, x, bm, cm, a, h0):
    """Per-element bounds on |kernel - plain| for inputs of any scale
    (the model's own, at serve scale), from the rounding.  Per step,
    each version rounds exp(dt a) within 2 float32 ulps (u = 2^-24),
    the products and the sum within 1 each; so a version walking the
    steps in order is off by at most 6 u m_t a step plus its decayed
    error carried in, where m_t = da_t m_{t-1} + |dbx_t| (m_{-1} =
    |h0|) bounds every term of h_t.  The plain version walks them in
    order.  The kernel does too, within each group of steps of its
    chunked order (`selective_scan.cu`), and multiplies a group's
    incoming state by the product of the same rounded da_t, one
    rounding a factor as the sequential order has one a step; it
    composes the groups by a scan of at most three fused multiply-adds
    per group end, each within u m_t of a partial state bounded by m_t.
    So the two differ by at most (6 + 6 + 3) u m_t a step (the 3
    charged at every step, though only a group's last has it):
    |h_T - h'_T| <= 15 u E_T with E_t = da_t E_{t-1} + m_t.  y_t adds
    its N-term dot summed in another order: |y_t - y'_t| <= u (15
    sum_n E_t |c_t| + 2 N sum_n m_t |c_t|).  Returns the bounds on y
    and on the final state, and the largest E/m ratio (the steps a
    rounding survives)."""
    import torch
    n = a.shape[-1]
    m = torch.zeros_like(dt[:, 0, :, None] * a) if h0 is None \
        else h0.abs().clone()
    e = torch.zeros_like(m)
    ty = torch.empty_like(dt)
    for t in range(dt.shape[1]):
        da = torch.exp(dt[:, t, :, None] * a)
        m = da * m + (dt[:, t] * x[:, t]).abs()[..., None] * \
            bm[:, t, None, :].abs()
        e = da * e + m
        c = cm[:, t, None, :].abs()
        ty[:, t] = UNIT_ROUNDOFF * (SCAN_ULPS * (e * c).sum(-1) +
                                    2 * n * (m * c).sum(-1))
    memory = (e / m.clamp_min(1e-30)).max().item()
    return ty, SCAN_ULPS * UNIT_ROUNDOFF * e, {
        "bound": "rounding", "ulps": SCAN_ULPS, "max_E_over_m": memory}


def scan_error(dt, x, bm, cm, a, h0, serve=False, kernel=None):
    """(max abs error, max error over its tolerance, tolerance note) of
    the kernel's y and final state (`kernel`: the wrapper, by default
    the module's current one) against the plain version's."""
    import torch
    from repro_torch.kernels.scan import ref, scan
    kernel = kernel or scan.selective_scan_fused
    y, h_t = kernel(dt, x, bm, cm, a, h0)
    yp, hp = ref.selective_scan_fused_ref(dt, x, bm, cm, a, h0)
    if serve:
        ty, th, note = scan_serve_bounds(dt, x, bm, cm, a, h0)
    else:
        ty = SCAN_ATOL + SCAN_RTOL * yp.abs()
        th = SCAN_ATOL + SCAN_RTOL * hp.abs()
        note = {"atol": SCAN_ATOL, "rtol": SCAN_RTOL}
    err, ratio = 0.0, 0.0
    for got, want, tol in ((y, yp, ty), (h_t, hp, th)):
        diff = (got - want).abs()
        err = max(err, diff.max().item())
        ratio = max(ratio, (diff / tol.clamp_min(1e-30)).max().item())
        if not bool(torch.isfinite(got).all()):
            ratio = float("inf")
    return err, ratio, note


def check_scan(what, call):
    err, ratio, note = scan_error(*call)
    dt, h0 = call[0], call[5]
    emit({"check": SCAN, "inputs": what, "batch": dt.shape[0],
          "steps": dt.shape[1], "d_inner": dt.shape[2],
          "state": call[4].shape[-1], "h0": h0 is not None,
          "max_abs_err": err, "err_over_tol": ratio, "tol": note,
          "ok": ratio <= 1.0})
    if ratio > 1.0:
        fail(f"{SCAN} disagrees with its plain version ({what}, B="
             f"{dt.shape[0]}, S={dt.shape[1]}, h0 {h0 is not None}): max "
             f"abs err {err}, {ratio} times its tolerance")
    return err


def scan_bound(dt, a, h0):
    """(bytes_ms, flops_ms, sfu_ms) of one scan call: dt, x, y
    (B, S, D), B, C (B, S, N), a, h0 when given and hT, f32, each once;
    six flops per (t, d, n) and one per (t, d) on the float32 units; one
    exp per (t, d, n) on the special-function units."""
    b, s, d = dt.shape
    n = a.shape[-1]
    floats = 3 * b * s * d + 2 * b * s * n + d * n + \
        (2 if h0 is not None else 1) * b * d * n
    flops = b * s * d * (6 * n + 1)
    return (floats * 4 / HBM_BYTES_PER_S * 1e3,
            flops / FP32_FLOPS_PER_S * 1e3,
            b * s * d * n / SFU_PER_S * 1e3)


def time_scan(calls, gpu, **line):
    """Time a list of scan calls (`time_sequence`, float32): kernel
    (also as a CUDA graph), plain version, no library call."""
    from repro_torch.kernels.scan import ref, scan

    def kern(c):
        return lambda: scan.selective_scan_fused(*c)

    def plain(c):
        return lambda: ref.selective_scan_fused_ref(*c)
    return time_sequence(SCAN, [kern(c) for c in calls],
                         [plain(c) for c in calls], None,
                         [scan_bound(c[0], c[4], c[5]) for c in calls],
                         gpu, dtype="float32", graph=True, **line)


def phase_scan_kernel():
    """The scan kernel on random inputs at falcon-mamba-7b's width:
    prefill B 1 from a zero state at each S of SCAN_LENGTHS, decode
    B 8 x S 1 from a random state, and that decode again with the final
    state written over the initial one (``out_state=h0``)."""
    import torch
    from repro_torch.kernels.scan import ref, scan
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for s in SCAN_LENGTHS:
        worst = max(worst, check_scan("random", scan_inputs(gen, 1, s,
                                                            False)))
    decode = scan_inputs(gen, SLOTS, 1, True)
    worst = max(worst, check_scan("random", decode))
    _, want = ref.selective_scan_fused_ref(*decode)
    state = decode[5].clone()
    scan.selective_scan_fused(*decode[:5], state, out_state=state)
    err = (state - want).abs().max().item()
    ok = bool(((state - want).abs() <=
               SCAN_ATOL + SCAN_RTOL * want.abs()).all())
    emit({"check": SCAN, "inputs": "random, final state in place",
          "batch": SLOTS, "steps": 1, "max_abs_err": err,
          "tol": {"atol": SCAN_ATOL, "rtol": SCAN_RTOL}, "ok": ok})
    if not ok:
        fail(f"{SCAN} with out_state=h0 disagrees with its plain version: "
             f"max abs err {err}")
    return max(worst, err)


def record_scan_calls(eng, T_):
    """Keep the shape of every prefill `eng` runs and the batch of every
    decode step, and return the list and a function that undoes the
    `T.decode_step` wrapper."""
    calls = []
    prefill_fn = eng._prefill_fn

    def prefill_fn_rec(bucket):
        fn = prefill_fn(bucket)

        def run(params, tokens, last_index):
            calls.append(("prefill", tokens.shape[0], tokens.shape[1]))
            return fn(params, tokens, last_index)
        return run
    eng._prefill_fn = prefill_fn_rec
    decode_step = T_.decode_step

    def decode_step_rec(params, cache, batch, cfg, **kw):
        calls.append(("decode", batch["tokens"].shape[0], 1))
        return decode_step(params, cache, batch, cfg, **kw)
    T_.decode_step = decode_step_rec

    def undo():
        T_.decode_step = decode_step
    return calls, undo


def hold_scan_calls(substitute=None):
    """Wrap the models' call of the scan kernel's wrapper.  Without
    `substitute`, hold each call's kernel result against the plain
    version on a copy of its inputs (`scan_error` at the rounding
    bound), before the call itself runs, and keep (max abs err, err
    over bound, the bound's largest E/m) per call in the returned
    list; with it, run `substitute` (a function of
    `ref.selective_scan_fused_ref`'s contract) in the kernel's place.
    Returns (list, undo)."""
    from repro_torch.kernels.scan import scan
    held = []
    orig = scan.selective_scan_fused

    def rec(dt, x, b, c, a, h0=None, *, out_state=None):
        if substitute is not None:
            y, h_t = substitute(dt, x, b, c, a, h0)
            return y, (h_t if out_state is None else out_state.copy_(h_t))
        copy = tuple(None if t is None else t.detach().clone()
                     for t in (dt, x, b, c, a, h0))
        err, ratio, note = scan_error(*copy, serve=True, kernel=orig)
        held.append((err, ratio, note["max_E_over_m"]))
        del copy
        return orig(dt, x, b, c, a, h0, out_state=out_state)
    scan.selective_scan_fused = rec

    def undo():
        scan.selective_scan_fused = orig
    return held, undo


def phase_ssm_logits(params, cfg):
    """A 1536-token prompt through `T.prefill`, then three decode steps
    from its state (tokens from a seed), three ways: through the kernel
    (holding every layer's scan, in the prefill and in each decode
    step, against the plain version on its own inputs at the rounding
    bound), through the plain path, and as the control: the kernel
    path with the scan's sequential plain version
    (`ref.selective_scan_fused_ref`) in the kernel's place, a second
    float order of the same function."""
    import torch
    from repro_torch.kernels.scan import ref
    from repro_torch.models import transformer as T_
    gen = torch.Generator(device="cuda").manual_seed(8)
    s = BUCKETS[-1]
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                         device="cuda")
    nxt = torch.randint(0, cfg.vocab_size, (3, 1, 1), generator=gen,
                        device="cuda")
    outs = {}
    held = []
    for mode in ("kernel", "plain", "control"):
        if mode == "kernel":
            held, undo = hold_scan_calls()
        elif mode == "control":
            _, undo = hold_scan_calls(ref.selective_scan_fused_ref)
        else:
            undo = None
        try:
            use_kernel = mode != "plain"
            hidden, cache = T_.prefill(params, {"tokens": toks}, cfg,
                                       use_kernel=use_kernel)
            logits = [T_.logits_fn(params, hidden).float()]
            for i in range(nxt.shape[0]):
                lg, cache = T_.decode_step(params, cache,
                                           {"tokens": nxt[i]}, cfg,
                                           use_kernel=use_kernel)
                logits.append(lg.float())
        finally:
            if undo is not None:
                undo()
        outs[mode] = logits
        del cache
    L = cfg.n_layers
    if len(held) != L * (1 + nxt.shape[0]):
        fail(f"{len(held)} scan calls in one prefill and {nxt.shape[0]} "
             f"decode steps of {L} layers")
    worst = 0.0
    for step in range(1 + nxt.shape[0]):
        part = held[step * L:(step + 1) * L]
        ratios = [r for _, r, _ in part]
        at = max(range(L), key=ratios.__getitem__)
        err = max(e for e, _, _ in part)
        ok = ratios[at] <= 1.0
        emit({"check": SCAN, "inputs": "serve, every layer",
              "call": "prefill" if step == 0 else f"decode step {step}",
              "batch": 1, "steps": s if step == 0 else 1, "layers": L,
              "max_abs_err": err, "err_over_tol": ratios[at],
              "worst_layer": at,
              "tol": {"bound": "rounding", "ulps": SCAN_ULPS},
              "max_E_over_m": max(m for _, _, m in part), "ok": ok})
        if not ok:
            fail(f"{SCAN} disagrees with its plain version on layer {at}'s "
                 f"own inputs ({'prefill' if step == 0 else 'decode'}): "
                 f"{ratios[at]} times its rounding bound")
        worst = max(worst, err)
    for i in range(len(outs["kernel"])):
        logits_check("ssm_prefill_logits" if i == 0 else "ssm_decode_logits",
                     {True: outs["kernel"][i], False: outs["plain"][i]},
                     control=outs["control"][i],
                     **({"tokens": s} if i == 0 else {"step": i}))
    return worst


def phase_ssm_serve(gpu: str):
    """falcon-mamba-7b: random weights, the logits checks, one counted
    wave through `make_engine`'s dense fallback."""
    import numpy as np
    import torch
    import repro_torch.configs as configs
    from repro_torch.device import make_generator
    from repro_torch.models import transformer as T_
    from repro_torch.serving.engine import (DenseServingEngine, Request,
                                            make_engine)

    cfg = configs.get("falcon-mamba-7b")
    if (cfg.family, cfg.mamba_version, cfg.d_inner, cfg.ssm_state) != \
            ("ssm", 1, SCAN_D, SCAN_N):
        fail(f"falcon-mamba-7b is not Mamba-1 at d_inner {SCAN_D}, "
             f"state {SCAN_N}")
    gc.collect()                   # engines of the yi-6b phases sit in
    torch.cuda.empty_cache()       # reference cycles with their weights
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = T_.init_params(make_generator(0, "cuda"), cfg)
    torch.cuda.synchronize()
    emit({"weights": cfg.name,
          "params": sum(int(x.numel()) for x in _leaves(params)),
          "param_count": cfg.param_count(),
          "bytes": sum(int(x.numel() * x.element_size())
                       for x in _leaves(params)),
          "allocated_before_gb": before / 1e9,
          "init_s": time.perf_counter() - t0})
    worst = phase_ssm_logits(params, cfg)

    kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_buckets=BUCKETS)
    warm = make_engine(params, cfg, **kw)
    warm.submit(Request(99, np.arange(300, dtype=np.int32) % cfg.vocab_size,
                        max_new_tokens=2))
    warm.run_to_completion()
    del warm

    eng = make_engine(params, cfg, **kw)
    if type(eng) is not DenseServingEngine:
        fail(f"make_engine served {cfg.name} through {type(eng).__name__}")
    reqs = make_requests(cfg.vocab_size)
    calls, undo = record_scan_calls(eng, T_)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        futs, wall = drive_wave(eng, reqs)
        launches = read_launches()
    finally:
        undo()
    comps = check_wave(eng, reqs, futs, cfg.vocab_size)
    n_prefill = sum(1 for c in calls if c[0] == "prefill")
    wave_line(eng, cfg, gpu, "dense (ssm fallback)", reqs, comps, wall,
              wave=0, counted=True, launches=launches, prefills=n_prefill,
              decode_steps=len(calls) - n_prefill,
              peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check_launches(cfg, "ssm dense", launches,
                   {DECODE: [], PREFILL: [], FLASH: [], SCAN: calls},
                   (SCAN,))
    return launches[SCAN], calls, worst


def phase_replay_scan(gpu: str, calls):
    """Each recorded scan call of the counted ssm wave, once (every
    layer runs the same shapes) on random inputs, against the plain
    version; then timed as the whole sequence, and its prefill and
    decode calls apart as extra lines."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(9)
    built = {"prefill": [], "decode": []}
    worst = 0.0
    for kind, b, s in calls:
        call = scan_inputs(gen, b, s, kind == "decode")
        err, ratio, _ = scan_error(*call)
        if ratio > 1.0:
            fail(f"{SCAN} disagrees with its plain version on a main-path "
                 f"call ({kind}, B={b}, S={s}): max abs err {err}, "
                 f"{ratio} times its tolerance")
        worst = max(worst, err)
        built[kind].append(call)
    emit({"check": SCAN, "inputs": "main path", "dtype": "float32",
          "calls": len(calls), "prefill_steps": [s for k, _, s in calls
                                                 if k == "prefill"],
          "decode_calls": len(built["decode"]), "max_abs_err": worst,
          "tol": {"atol": SCAN_ATOL, "rtol": SCAN_RTOL}, "ok": True})
    for kind in ("prefill", "decode"):
        time_scan(built[kind], gpu, inputs="main path", calls_of=kind)
    times = time_scan(built["prefill"] + built["decode"], gpu,
                      inputs="main path", calls_of="all")
    return worst, times


# -- RK3 stencil (the compiled AMR engine) -----------------------------------

def stencil_inputs(gen, nb, g, h, dr, scale):
    """Random fields at `scale` on nb blocks of grain g with h halo cells
    per side; radii formed as the compiled engine forms them (block start
    as an integer, plus float32 offsets, times dr); flags: the first
    block's left side and the last block's right side physical, and about
    one block in eight (block 0 when nb is 1) with both sides physical."""
    import torch
    u = torch.randn(nb, 3, g + 2 * h, generator=gen, device="cuda") * scale
    blk0 = torch.arange(nb, device="cuda") * g
    r = (blk0[:, None] + torch.arange(-h, g + h, dtype=torch.float32,
                                      device="cuda")[None, :]) * dr
    flags = torch.zeros(nb, 2, dtype=torch.int32, device="cuda")
    flags[0, 0] = 1
    flags[-1, 1] = 1
    both = torch.rand(nb, generator=gen, device="cuda") < 0.125
    both[0] = both[0] | (nb == 1)
    flags[both] = 1
    return u, r.contiguous(), flags


def stencil_error(u, r, flags, dr, dt, p):
    """(max abs error, max |plain|) of the kernel against its plain
    version on one call; the error is inf where the kernel's output is
    not finite."""
    import torch
    from repro_torch.kernels.stencil import ref, stencil
    got = stencil.stencil_rk3(u, r, flags, dr=dr, dt=dt, p=p)
    want = ref.stencil_rk3_ref(u, r, flags, dr=dr, dt=dt, p=p)
    err = (got - want).abs().max().item()
    if not bool(torch.isfinite(got).all()):
        err = float("inf")
    return err, want.abs().max().item()


def check_stencil(what, cases, **line):
    """Hold every (u, r, flags, dr, dt, p, scale) case at STENCIL_ATOL;
    one line for the group."""
    worst, errs = 0.0, []
    for u, r, flags, dr, dt, p, scale in cases:
        err, plain_max = stencil_error(u, r, flags, dr, dt, p)
        errs.append({"p": p, "scale": scale, "max_abs_err": err,
                     "max_abs_plain": plain_max})
        if not err <= STENCIL_ATOL:
            fail(f"{STENCIL} disagrees with its plain version ({what}, "
                 f"nb={u.shape[0]}, W={u.shape[2]}, p={p}, scale={scale}): "
                 f"max abs err {err} against atol {STENCIL_ATOL}")
        worst = max(worst, err)
    emit({"check": STENCIL, "inputs": what, **line, "cases": errs,
          "max_abs_err": worst, "tol": f"atol {STENCIL_ATOL}", "ok": True})
    return worst


def phase_stencil_kernel():
    """The stencil kernel on random inputs: the reference test's shapes
    (grain 8/32/128, nb 1/4, dr 0.05, dt 0.01) and the production cell's
    (nb 4096, grain 2048, its dr and dt) at width g + 2H (each call of
    one step per exchange, and the second of two) and g + 4H (the first
    of two); p 1/3/7, input scales 0.01 and 0.1."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = 0.0
    for g in (8, 32, 128):
        for nb in (1, 4):
            cases = [(*stencil_inputs(gen, nb, g, STENCIL_H, 0.05, scale),
                      0.05, 0.01, p, scale)
                     for p in (1, 3, 7) for scale in (0.01, 0.1)]
            worst = max(worst, check_stencil("random", cases, nb=nb,
                                             width=g + 2 * STENCIL_H))
    nb = AMR_N_LOC * AMR_CFG["slots"]
    g = AMR_CFG["grain"]
    dr, dt = amr_dr_dt()
    for h in (STENCIL_H, 2 * STENCIL_H):
        for p in (1, 3, 7):
            cases = [(*stencil_inputs(gen, nb, g, h, dr, scale), dr, dt, p,
                      scale) for scale in (0.01, 0.1)]
            worst = max(worst, check_stencil(
                "random, production shape", cases, nb=nb, width=g + 2 * h,
                dr=dr, dt=dt))
            del cases
    return worst


def amr_dr_dt():
    """dr and dt of the production cell, as `make_uniform_step` forms
    them."""
    from repro_torch.amr import wave
    prob = wave.WaveProblem(**AMR_PROB)
    n_pts = AMR_N_LOC * AMR_CFG["slots"] * AMR_CFG["grain"]
    dr = prob.rmax / (n_pts - 1)
    return dr, prob.cfl * dr


def record_stencil_calls():
    """Keep a copy of the inputs of every stencil kernel call the models
    make (`stencil.stencil_rk3` is what `ops.stencil_rk3_step` calls).
    Returns (list, undo)."""
    from repro_torch.kernels.stencil import stencil
    calls = []
    orig = stencil.stencil_rk3

    def rec(u_ext, r_ext, flags, **kw):
        calls.append((u_ext.clone(), r_ext.clone(), flags.clone(), kw))
        return orig(u_ext, r_ext, flags, **kw)
    stencil.stencil_rk3 = rec

    def undo():
        stencil.stencil_rk3 = orig
    return calls, undo


def amr_diagnostics(u, dr):
    import torch
    from repro_torch.amr import wave
    r = torch.arange(u.shape[1], dtype=u.dtype, device=u.device) * dr
    return {"energy": wave.energy(u, r, dr).item(),
            "linf": wave.linf(u).item()}


def phase_amr(gpu: str):
    """The compiled AMR engine at the production cell (256 localities x
    16 slots x grain 2048 = 8,388,608 points, 16 steps) with one and two
    steps per exchange: through the kernel (the counted call: launches
    zeroed just before it and read just after; with one step per
    exchange its 16 kernel calls recorded), through the plain path and
    through the global oracle `reference_uniform`, all three held
    together at STENCIL_ATOL; then the step timed with CUDA events,
    split into the halo assembly and the rest."""
    import torch
    from repro_torch.amr import compiled, wave
    gc.collect()                   # falcon-mamba's engines and weights
    torch.cuda.empty_cache()
    prob = wave.WaveProblem(**AMR_PROB)
    recorded = launches = step_line = None
    for k in (1, 2):
        outs = {}
        for mode in ("kernel", "plain"):
            cfg = compiled.CompiledAMRConfig(**AMR_CFG, steps_per_exchange=k,
                                             use_kernel=mode == "kernel")
            step, mk, init, to_g, dev, info = compiled.make_uniform_step(
                prob, cfg, AMR_N_LOC, device="cuda")
            pool = init()
            if mode == "kernel":
                before = amr_diagnostics(to_g(pool), info["dr"])
                torch.cuda.reset_peak_memory_stats()
                calls, undo = record_stencil_calls() if k == 1 else \
                    ([], lambda: None)
                try:
                    reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = step(pool)
                    torch.cuda.synchronize()
                    first_s = time.perf_counter() - t0
                    counts = read_launches()
                finally:
                    undo()
                peak = torch.cuda.max_memory_allocated() / 1e9
                want = {name: 0 for name in counts}
                want[STENCIL] = cfg.n_steps
                if counts != want:
                    fail(f"AMR step (K={k}): launches {counts}, not {want}")
                timing = time_amr_step(step, pool, k, info)
                if k == 1:
                    recorded, launches = calls, counts[STENCIL]
                    step_line = timing
            else:
                out = step(pool)
            outs[mode] = to_g(out)
            del out
        outs["reference"] = compiled.reference_uniform(
            prob, info["n_points"], cfg.n_steps, info["dr"], info["dt"],
            device="cuda")
        diffs = {f"{a}_vs_{b}": (outs[a] - outs[b]).abs().max().item()
                 for a, b in (("kernel", "plain"), ("kernel", "reference"),
                              ("plain", "reference"))}
        finite = all(bool(torch.isfinite(v).all()) for v in outs.values())
        ok = finite and max(diffs.values()) <= STENCIL_ATOL and \
            tuple(outs["kernel"].shape) == (3, info["n_points"])
        emit({"amr": "compiled uniform", "gpu": gpu, **AMR_PROB, **AMR_CFG,
              "steps_per_exchange": k, "n_loc": AMR_N_LOC,
              "n_points": info["n_points"], "dr": info["dr"],
              "dt": info["dt"], "launches": counts, "before": before,
              "after": amr_diagnostics(outs["kernel"], info["dr"]),
              "max_abs_diff": diffs, "tol": f"atol {STENCIL_ATOL}",
              "finite": finite, "first_call_s": first_s,
              "peak_memory_gb": peak, **timing, "ok": ok})
        if not ok:
            fail(f"AMR step (K={k}): kernel, plain and reference differ by "
                 f"{diffs} (atol {STENCIL_ATOL}), finite {finite}")
        del outs, pool
    return launches, recorded, step_line


def time_amr_step(step, pool, k, info):
    """Per step: the whole `step_fn` (CUDA events over calls of n_steps
    steps), the halo assembly of one exchange (per step: over K), and
    the host wall clock of one call; cell updates per second from each."""
    import torch
    from repro_torch.amr import compiled
    n_steps = AMR_CFG["n_steps"]
    step_ms = time_ms([lambda: step(pool)], 3) / n_steps
    assemble_ms = time_ms([lambda: compiled.assemble_halos(
        pool, STENCIL_H * k)], 20) / k
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(pool)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    return {"step_ms": step_ms, "assemble_ms_per_step": assemble_ms,
            "wall_s": wall,
            "cell_updates_per_s": info["n_points"] * n_steps / wall,
            "cell_updates_per_s_device": info["n_points"] / step_ms * 1e3}


def stencil_bound(u, g):
    """(bytes_ms, ops_ms) of one stencil call: u_ext, r_ext and the int32
    flags read once, the (nb, 3, g) output written once; about
    AMR_FLOPS_PER_POINT float32 operations per output point and step
    (the count `launch/dryrun.py` uses for the compiled AMR cell)."""
    nb, _, w = u.shape
    nbytes = 4 * (nb * 3 * w + nb * w + 2 * nb + nb * 3 * g)
    ops = AMR_FLOPS_PER_POINT * nb * g
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3


def phase_replay_stencil(gpu: str, calls, step_line):
    """The recorded kernel calls of the K = 1 production step (16, on
    their own inputs) against the plain version, then timed as the whole
    sequence (no single PyTorch call computes the step: library time
    null); the kernel's share of the measured step."""
    from repro_torch.kernels.stencil import ref, stencil
    worst = plain_max_all = 0.0
    for u, r, flags, kw in calls:
        err, plain_max = stencil_error(u, r, flags, kw["dr"], kw["dt"],
                                       kw["p"])
        plain_max_all = max(plain_max_all, plain_max)
        if not err <= STENCIL_ATOL:
            fail(f"{STENCIL} disagrees with its plain version on a "
                 f"main-path call: max abs err {err}")
        worst = max(worst, err)
    u0 = calls[0][0]
    emit({"check": STENCIL, "inputs": "main path", "dtype": "float32",
          "calls": len(calls), "nb": u0.shape[0], "width": u0.shape[2],
          "max_abs_err": worst, "max_abs_plain": plain_max_all,
          "tol": f"atol {STENCIL_ATOL}", "ok": True})

    def kern(c):
        return lambda: stencil.stencil_rk3(c[0], c[1], c[2], **c[3])

    def plain(c):
        return lambda: ref.stencil_rk3_ref(c[0], c[1], c[2], **c[3])
    g = u0.shape[2] - 2 * STENCIL_H
    times = time_sequence(STENCIL, [kern(c) for c in calls],
                          [plain(c) for c in calls], None,
                          [stencil_bound(c[0], g) for c in calls], gpu,
                          dtype="float32", inputs="main path",
                          nb=u0.shape[0], width=u0.shape[2])
    emit({"timing": "amr step split", "gpu": gpu, "steps_per_exchange": 1,
          "step_ms": step_line["step_ms"], "kernel_ms": times["ms"],
          "assemble_ms": step_line["assemble_ms_per_step"],
          "rest_ms": step_line["step_ms"] - times["ms"] -
          step_line["assemble_ms_per_step"],
          "kernel_share": times["ms"] / step_line["step_ms"],
          "kernel_over_bound": times["ms"] / times["bound_ms"]})
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
    from repro_torch.kernels.scan import scan
    from repro_torch.kernels.stencil import stencil

    # the fp32 plain versions must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"gpu": gpu})

    t0 = time.perf_counter()
    libs = build.build_all([paged.SOURCE, flash.SOURCE, scan.SOURCE,
                            stencil.SOURCE])
    emit({"build": [str(p.relative_to(ROOT)) for p in libs],
          "build_s": time.perf_counter() - t0})
    # registers, stack and spills of the tensor-core attention kernels
    # (every instantiation), from the build's -Xptxas -v log
    for lib in libs[:2]:
        for entry in ptxas_report(lib.with_suffix(".log").read_text(),
                                  TC_KERNEL):
            emit({"ptxas": lib.name, **tc_shape(entry["function"]),
                  **entry})
    # and of the split decode kernel and its combine (paged source)
    for entry in ptxas_report(libs[0].with_suffix(".log").read_text(),
                              DECODE_KERNEL):
        emit({"ptxas": libs[0].name, **decode_shape(entry["function"]),
              **entry})
    # and of the two scan kernels (sequential, chunked)
    for entry in ptxas_report(libs[2].with_suffix(".log").read_text(),
                              SCAN_KERNEL):
        emit({"ptxas": libs[2].name, **entry})

    worst = phase_kernels(gpu)
    worst[FLASH] = phase_flash_kernel(gpu)
    counted, recs, n_rows = phase_serve(gpu)
    worst_main, times = phase_replay(gpu, recs["chunked"], n_rows)
    flash_shapes = [(b, s) for b, s in recs["paged"][FLASH]]
    worst_main[FLASH], times[FLASH] = phase_replay_flash(gpu, flash_shapes)

    # falcon-mamba-7b (the yi-6b weights went with phase_serve)
    worst[SCAN] = phase_scan_kernel()
    scan_launches, scan_calls, worst_serve = phase_ssm_serve(gpu)
    worst[SCAN] = max(worst[SCAN], worst_serve)
    worst_main[SCAN], times[SCAN] = phase_replay_scan(gpu, scan_calls)

    # the compiled AMR engine (falcon-mamba's weights freed first)
    worst[STENCIL] = phase_stencil_kernel()
    stencil_launches, stencil_calls, step_line = phase_amr(gpu)
    worst_main[STENCIL], times[STENCIL] = phase_replay_stencil(
        gpu, stencil_calls, step_line)

    # each kernel's launches come from its own path's counted wave: the
    # paged kernels from the chunked engine's, flash from the
    # whole-prompt paged engine's, the scan from falcon-mamba's, the
    # stencil from the AMR step's (one step per exchange)
    launches = {DECODE: counted["chunked"][DECODE],
                PREFILL: counted["chunked"][PREFILL],
                FLASH: counted["paged"][FLASH], SCAN: scan_launches,
                STENCIL: stencil_launches}
    sources = {DECODE: paged.SOURCE, PREFILL: paged.SOURCE,
               FLASH: flash.SOURCE, SCAN: scan.SOURCE,
               STENCIL: stencil.SOURCE}
    replaces = {DECODE: "src/repro/kernels/attention/paged.py:96",
                PREFILL: "src/repro/kernels/attention/paged.py:207",
                FLASH: "src/repro/kernels/attention/flash.py:88",
                SCAN: "src/repro/kernels/scan/selective_scan.py:51",
                STENCIL: "src/repro/kernels/stencil/stencil.py:83"}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": str(sources[name].relative_to(ROOT)),
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": max(worst[name], worst_main[name]), **times[name]}
        for name in (DECODE, PREFILL, FLASH, SCAN, STENCIL)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
