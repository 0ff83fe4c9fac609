"""Serving entry point of the port: reduced-config serving demo
(counterpart of `repro.launch.serve` for the flags the port serves).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --device cpu --pages 24 --chunk-size 32 --step-tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --device cpu --prefix-cache-compute
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --device cpu --engine dense

``--engine`` picks the chunked engine (default), the whole-prompt
paged engine or the dense slot-pool baseline.  A family without a
paged layout is served by the dense engine whatever ``--engine`` says,
as in the reference:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch falcon-mamba-7b --device cpu

Like the reference CLI it serves the reduced config (`cfg.reduced()`)
with random weights from a seed.  ``--device`` defaults to ``cuda``,
which needs a card; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--engine", choices=("chunked", "paged", "dense"),
                    default="chunked")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="page-pool size (0 = dense-equivalent)")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="prefill chunk width (0 = 2 pages)")
    ap.add_argument("--step-tokens", type=int, default=0,
                    help="per-step token budget (0 = slots + chunk)")
    ap.add_argument("--prefix-cache-compute", action="store_true",
                    help="prefix-cache compute skip (DESIGN.md §4e)")
    ap.add_argument("--pin-threshold", type=int, default=4,
                    help="radix-index hits before a prefix page is "
                         "pinned hot (0 disables pinning)")
    ap.add_argument("--ttft-slo-ms", type=float, default=0.0,
                    help="TTFT deadline attached to every request "
                         "(ms; 0 = untracked)")
    ap.add_argument("--itl-slo-ms", type=float, default=0.0,
                    help="inter-token p95 deadline attached to every "
                         "request (ms; 0 = untracked)")
    args = ap.parse_args(argv)

    import repro_torch.configs as configs
    from repro_torch.device import make_generator
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Request, make_engine

    cfg = configs.get_reduced(args.arch)
    params = T.init_params(make_generator(args.seed, args.device), cfg)
    eng = make_engine(params, cfg, engine=args.engine,
                      slots=args.slots, max_len=args.max_len,
                      page_size=args.page_size,
                      n_pages=args.pages or None,
                      chunk_size=args.chunk_size or None,
                      step_tokens=args.step_tokens or None,
                      prefix_cache_compute=args.prefix_cache_compute,
                      pin_threshold=args.pin_threshold,
                      device=args.device)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    futs = []
    for rid in range(args.requests):
        n = int(rng.integers(8, 48))
        futs.append(eng.submit(Request(rid, rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=args.max_new,
            ttft_deadline_ms=args.ttft_slo_ms or None,
            itl_deadline_ms=args.itl_slo_ms or None)))
    eng.run_to_completion()
    dt = time.perf_counter() - t0
    total_new = sum(len(c.tokens) for c in eng.completions)
    print(f"[serve] {type(eng).__name__} on {eng.device}: "
          f"{len(eng.completions)} completions, "
          f"{total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s)")
    for f in futs[:4]:
        c = f.get()                       # the completion LCO
        print(f"  rid={c.rid} new={len(c.tokens)} "
              f"prefill={c.prefill_s * 1e3:.0f}ms "
              f"decode={c.decode_s * 1e3:.0f}ms "
              f"preempts={c.preemptions}")
    if not hasattr(eng, "stats"):         # the dense engine keeps none
        return
    s = eng.stats()
    print(f"[serve] steps={s['steps']} "
          f"peak_active={s['peak_active']} "
          f"peak_page_occ={s['peak_page_occupancy']:.2f} "
          f"preemptions={s['preemptions']} "
          f"shares={s['page_shares']} cow={s['cow_copies']}")
    if s["prefix_cache_compute"]:
        print(f"[serve] compute skip: "
              f"full_skips={s['prefix_skips']} "
              f"partial_hits={s['prefix_partial_hits']} "
              f"prefill_tokens_skipped={s['prefill_tokens_skipped']}")
    print(f"[serve] ttft_p50={s['ttft_p50_ms']:.0f}ms "
          f"ttft_p95={s['ttft_p95_ms']:.0f}ms "
          f"itl_p50={s['itl_p50_ms']:.1f}ms "
          f"itl_p95={s['itl_p95_ms']:.1f}ms")
    if s.get("slo"):
        slo = s["slo"]
        print(f"[serve] slo: goodput={slo['goodput']:.0%} "
              f"({slo['met']}/{slo['requests']} met, "
              f"ttft_misses={slo['ttft_misses']} "
              f"itl_misses={slo['itl_misses']})")


if __name__ == "__main__":
    main()
