"""Where the split decode kernel's time goes on the card.

Variants of `src/repro_torch/kernels/attention/csrc/paged_attention.cu`,
each a copy with one part routed elsewhere or taken out, timed on the
serve path's decode shape: yi-6b's heads (32/4 of 128, bf16), B 8,
(8, 128) block tables of 16-token pages, clocks drawn from [0, 1530]
with two slots parked at 0, the split of `paged.decode_split_plan`.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/decode_probe.py [PAGES_PER_SPLIT ...]

(each PAGES_PER_SPLIT given also times the unedited kernel at that split
in place of the plan's).

It copies the source and the header it includes into
``build/decode_probe/``, applies each variant's edits (it stops if an
edit no longer matches the source), builds every copy with nvcc in
parallel (`repro_torch.kernels.build`), and for each variant times 24
calls as one CUDA graph (two passes, ms per call) and reads each
kernel's device time with `torch.profiler` (us per launch).  The
unedited kernel and the `fma` variant are first held against the plain
version at the bf16 bound; the variants that take a part out compute
nothing meaningful and are timings only.  One JSON line per variant,
after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "attention" / "csrc"
OUT = ROOT / "build" / "decode_probe"
H, KV, D, PS, P, B, CALLS = 32, 4, 128, 16, 128, 8, 24

# the edits of each variant: (text in the source, its replacement)
TO_FMA = ("if (sizeof(T) == 2 && a.D <= 128) {", "if (false) {")
NO_LOADS = [("    if (i < mine) load(i);\n", ""),
            ("    if (i + NS - 1 < mine) load(i + NS - 1);\n", "")]
MMA_START = ("  if (!split_keys(a, sp)) return;\n"
             "  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
             "  const int g = lane >> 2")
VARIANTS = {
    # the kernel as it is
    "kernel": [],
    # bf16 on the CUDA-core kernel instead of the tensor cores
    "fma": [TO_FMA],
    "fma_no_loads": [TO_FMA] + NO_LOADS,
    "fma_no_math": [TO_FMA, ("for (int st = 0; st < kSteps; ++st) {",
                             "for (int st = 0; st < 0; ++st) {")],
    "mma_no_loads": NO_LOADS,
    "mma_no_math": [("    float sc[2][4] = {};",
                     "    if (a.window >= 0) { __syncwarp(); continue; }\n"
                     "    float sc[2][4] = {};")],
    # each block returns once it knows its split's keys
    "setup_only": [(MMA_START, MMA_START.replace(
        "return;\n", "return;\n  if (a.window >= 0) return;\n", 1))],
    # the warps' partials are not merged nor written
    "no_merge": [("  merge_warps(a, sp, reinterpret_cast<const float*>"
                  "(smem_raw), kWarpFloats,\n              kMmaWarps,",
                  "  if (a.window < 0) merge_warps(a, sp, "
                  "reinterpret_cast<const float*>(smem_raw), kWarpFloats,"
                  "\n              kMmaWarps,")],
    # the combine returns at once
    "combine_floor": [("  const size_t base = (size_t)blockIdx.x * splits;\n",
                       "  const size_t base = (size_t)blockIdx.x * splits;\n"
                       "  if (splits > 0) return;\n")],
}
CHECKED = ("kernel", "fma")


def sources():
    """One edited copy of the source per variant, beside the header."""
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "attention_core.cuh", OUT / "attention_core.cuh")
    base = (CSRC / "paged_attention.cu").read_text()
    paths = {}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                sys.exit(f"decode_probe: variant {name}: edit no longer "
                         f"matches the source: {old!r}")
            text = text.replace(old, new)
        paths[name] = OUT / f"paged_attention_{name}.cu"
        paths[name].write_text(text)
    return paths


def bind(path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_decode.argtypes = \
        [p] * 7 + [i] * 7 + [ctypes.c_float, i, i, p]
    lib.paged_attention_decode.restype = i
    return lib


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_probe: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import paged, ref

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    paths = sources()
    libs = dict(zip(paths, build.build_all(paths.values())))

    gen = torch.Generator(device="cuda").manual_seed(0)
    n = B * P + 2
    kp = torch.randn(n, PS, KV, D, generator=gen, device="cuda").bfloat16()
    vp = torch.randn(n, PS, KV, D, generator=gen, device="cuda").bfloat16()
    pps, splits = paged.decode_split_plan(
        B, H, KV, P, PS,
        torch.cuda.get_device_properties(0).multi_processor_count)
    calls = []
    for _ in range(CALLS):
        clocks = torch.randint(0, 1531, (B,), generator=gen, device="cuda",
                               dtype=torch.int32)
        clocks[1] = clocks[6] = 0
        tables = torch.randint(0, n - 1, (B, P), generator=gen,
                               device="cuda", dtype=torch.int32)
        q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
        calls.append((q, tables, clocks))

    def thunk(lib, q, tables, clocks, pages=pps):
        work = torch.empty(B * H * -(-P // pages) * (D + 2),
                           dtype=torch.float32, device="cuda")
        out = torch.empty_like(q)

        def run():
            err = lib.paged_attention_decode(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                tables.data_ptr(), clocks.data_ptr(), out.data_ptr(),
                work.data_ptr(), B, H, KV, D, PS, P, 0, D ** -0.5, pages, 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"decode_probe: CUDA error {err}")
            return out
        return run

    def graph_ms(fns, iters=50):
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
        return start.elapsed_time(end) / (iters * len(fns))

    results = {name: {"variant": name, "graph_ms": []} for name in libs}
    for _ in range(2):
        for name, path in libs.items():
            lib = bind(path)
            fns = [thunk(lib, *c) for c in calls]
            if name in CHECKED and not results[name]["graph_ms"]:
                worst = 0.0
                for (q, tables, clocks), fn in zip(calls, fns):
                    got = fn().float()
                    want = ref.paged_attention_ref(
                        q[:, None], kp, vp, tables, clocks)[:, 0].float()
                    pabs = ref.paged_attention_ref(
                        q[:, None], kp, vp.abs(), tables, clocks)[:, 0]
                    tol = 2.0 ** -7 * (pabs.float() + want.abs())
                    worst = max(worst, ((got - want).abs() / tol).max().item())
                if worst > 1.0:
                    sys.exit(f"decode_probe: {name} disagrees with the plain "
                             f"version ({worst} times the bf16 bound)")
                results[name]["err_over_tol"] = worst
            results[name]["graph_ms"].append(graph_ms(fns))
    for name, path in libs.items():
        fns = [thunk(bind(path), *c) for c in calls]
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", 0)
            for kernel in ("decode_mma", "decode_fma", "decode_combine"):
                if t > 0 and kernel in ev.key:
                    results[name][f"{kernel}_us"] = t / ev.count
        print(json.dumps({**results[name], "pages_per_split": pps,
                          "splits": splits}), flush=True)
    for pages in (int(x) for x in sys.argv[1:]):
        fns = [thunk(bind(libs["kernel"]), *c, pages) for c in calls]
        print(json.dumps({"variant": "kernel", "pages_per_split": pages,
                          "splits": -(-P // pages),
                          "graph_ms": [graph_ms(fns), graph_ms(fns)]}),
              flush=True)


if __name__ == "__main__":
    main()
