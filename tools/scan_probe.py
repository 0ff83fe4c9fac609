"""Where the chunked selective-scan kernel's time goes on the card.

Variants of `src/repro_torch/kernels/scan/csrc/selective_scan.cu`, each
a copy with one edit, timed on falcon-mamba-7b's scan (d_inner 8192,
state 16, f32): the prefills of the serve smoke's counted wave (B 1 at
the dense buckets of its 8 prompts, from a zero state) and its decode
step (B 8 x S 1 from a state).  The sequential kernel, which runs the
decode step, is timed on the prefills too: the design the chunked
kernel replaced, in the same call.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/scan_probe.py [--source FILE] [VARIANT ...]

(no variant: every one; ``--source`` takes another copy of the source,
e.g. an earlier design, in place of the checkout's).  It copies the
source into
``build/scan_probe/``, applies each variant's edits (it stops if an
edit no longer matches the source), builds every copy with nvcc in
parallel (`repro_torch.kernels.build`), prints each build's
``-Xptxas -v`` lines for the chunked kernel and, from its SASS
(``cuobjdump``), the instructions of the innermost loop that holds its
exps per exp at state size 16, holds the variants that
compute the function against the plain version (atol 1e-5 + rtol
1e-5, the reference's scan tolerance) on shapes on and beside the tile
edges, and times each as a CUDA graph of the whole prefill sequence and
launched one call at a time (two passes each, ms per call).  One JSON
line per variant, after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "scan" / "csrc" / \
    "selective_scan.cu"
OUT = ROOT / "build" / "scan_probe"
D, N, SLOTS = 8192, 16, 8
WAVE = (256, 1536, 768, 1024, 512, 1280, 768, 1024)  # the wave's buckets
# (B, S, D, N, with a state): on and beside the 128-step tile, a d_inner
# that leaves the last block part-empty, the small state sizes
CHECKS = ((1, 1000, D, N, False), (1, 129, D, N, True), (2, 127, 40, 4, True),
          (3, 128, 72, 8, False), (2, 2, 36, 2, True))

N_LOOP = "#pragma unroll 1\n    for (int n = 0; n < N; ++n) {"
VARIANTS = {
    # the kernel as it is
    "kernel": [],
    # dbx formed again in the second pass (B read twice), not kept
    "dbx_again": [("      float da[kItems], dbx[kItems];",
                   "      float da[kItems];"),
                  ("          dbx[k] = dxv[k] * bv[r];\n"
                   "          h = fmaf(da[k], h, dbx[k]);",
                   "          h = fmaf(da[k], h, dxv[k] * bv[r]);"),
                  ("        const float4 cq = c4[n * kStateStride / 4 + q];",
                   "        const float4 cq = c4[n * kStateStride / 4 + q];\n"
                   "        const float4 bq = b4[n * kStateStride / 4 + q];\n"
                   "        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};"),
                  ("          h = fmaf(da[k], h, dbx[k]);\n"
                   "          yv[k] = fmaf(h, cv[r], yv[k]);",
                   "          h = fmaf(da[k], h, dxv[k] * bv[r]);\n"
                   "          yv[k] = fmaf(h, cv[r], yv[k]);")],
    # one block an SM, up to 255 registers a thread
    "blocks1": [("__launch_bounds__(kChThreads, 2)",
                 "__launch_bounds__(kChThreads, 1)")],
    # the loop over states unrolled
    "n_unrolled": [(N_LOOP, N_LOOP.replace("unroll 1", "unroll"))],
    # timings only: the exp replaced by a multiply
    "no_exp": [("da[k] = expf(dtv[k] * an);", "da[k] = dtv[k] * an;")],
    # timings only: no composition across groups (each starts from 0)
    "no_scan": [("      if (g == 0) s_h[c * N + n] = prev;\n"
                 "      h = g == 0 ? carry : prev;\n",
                 "      h = carry;\n")],
}
CHECKED = ("kernel", "n_unrolled", "dbx_again", "blocks1")


def sources(names, source=SOURCE):
    """One edited copy of `source` per variant."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = Path(source).read_text()
    out = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name]:
            if old not in src:
                sys.exit(f"variant {name}: edit no longer matches: {old!r}")
            src = src.replace(old, new)
        path = OUT / f"{Path(source).stem}_{name}.cu"
        path.write_text(src)
        out[name] = path
    return out


def sass_per_exp(lib):
    """Instructions per MUFU.EX2 in the innermost loop that holds every
    exp of the chunked kernel (at N 16 where it is instantiated per
    state size), from `cuobjdump -sass`, or None."""
    from repro_torch.kernels.build import nvcc_path
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:] if "chunked" in
             f.split()[0]]
    funcs = [f for f in funcs if "ILi16E" in f.split()[0]] or funcs
    if not funcs:
        return None
    body = funcs[0]
    code = [(int(a, 16), t) for a, t in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    exps = [a for a, t in code if "MUFU.EX2" in t]
    loops = [(int(m.group(1), 16), a) for a, t in code
             for m in [re.search(r"BRA .*?0x([0-9a-f]+)", t)]
             if m and int(m.group(1), 16) < a]
    loops = [(b, e) for b, e in loops if exps and b <= exps[0]
             and exps[-1] <= e]
    if not loops:
        return None
    b, e = min(loops, key=lambda p: p[1] - p[0])
    return sum(b <= a <= e for a, _ in code) / len(exps)


def bind(path):
    lib = ctypes.CDLL(str(path))
    for fn in (lib.selective_scan_sequential, lib.selective_scan_chunked):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def inputs(gen, b, s, d, n, with_state):
    """`chip_smoke.scan_inputs` at any shape."""
    import torch
    kw = dict(generator=gen, device="cuda")
    return (torch.randn(b, s, d, **kw).abs(), torch.randn(b, s, d, **kw) * 0.3,
            torch.randn(b, s, n, **kw) * 0.3, torch.randn(b, s, n, **kw),
            -(torch.rand(d, n, **kw) + 0.5),
            torch.randn(b, d, n, **kw) * 0.3 if with_state else None)


def call(fn, args):
    """A thunk launching `fn` on `args` into preallocated outputs."""
    import torch
    dt, x, bm, cm, a, h0 = args
    b, s, d = dt.shape
    n = a.shape[-1]
    y = torch.empty_like(dt)
    h_t = torch.empty(b, d, n, device="cuda")
    ptr = [t.data_ptr() for t in (dt, x, bm, cm, a)]

    def run():
        err = fn(*ptr, None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_t.data_ptr(), b, s, d, n,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")
        return y, h_t
    return run


def check(fn, gen):
    """Largest error over tolerance on CHECKS."""
    import torch
    from repro_torch.kernels.scan import ref
    worst = 0.0
    for b, s, d, n, st in CHECKS:
        args = inputs(gen, b, s, d, n, st)
        y, h_t = call(fn, args)()
        yp, hp = ref.selective_scan_fused_ref(*args)
        for got, want in ((y, yp), (h_t, hp)):
            tol = 1e-5 + 1e-5 * want.abs()
            r = ((got - want).abs() / tol).max().item()
            worst = max(worst, r if bool(torch.isfinite(got).all())
                        else float("inf"))
    return worst


def timed(thunks, iters=20):
    """[host-launched ms, graph ms] per call, each the lower of two
    passes (chip_smoke's `time_ms` and `graph_ms`)."""
    return {"ms": min(chip_smoke.time_ms(thunks, iters) for _ in range(2)),
            "graph_ms": min(chip_smoke.graph_ms(thunks, iters)
                            for _ in range(2))}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    global chip_smoke
    import chip_smoke
    from repro_torch.kernels import build
    args = sys.argv[1:]
    source = SOURCE
    if args[:1] == ["--source"]:
        source, args = Path(args[1]).resolve(), args[2:]
    names = args or list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    paths = sources(names, source)
    libs = dict(zip(names, build.build_all(paths[k] for k in names)))
    gen = torch.Generator(device="cuda").manual_seed(11)
    wave = [inputs(gen, 1, s, D, N, False) for s in WAVE]
    decode = inputs(gen, SLOTS, 1, D, N, True)
    for name in names:
        lib = bind(libs[name])
        report = chip_smoke.ptxas_report(
            libs[name].with_suffix(".log").read_text(), "chunked_kernel")
        line = {"variant": name, "source": source.name,
                "ptxas": report[0]["report"],
                "sass_loop_per_exp": sass_per_exp(libs[name])}
        if name in CHECKED:
            line["err_over_tol"] = check(lib.selective_scan_chunked, gen)
        line["prefill"] = timed([call(lib.selective_scan_chunked, w)
                                 for w in wave])
        if name == "kernel":
            line["prefill_sequential"] = timed(
                [call(lib.selective_scan_sequential, w) for w in wave])
            line["decode_sequential"] = timed(
                [call(lib.selective_scan_sequential, decode)] * 16)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
