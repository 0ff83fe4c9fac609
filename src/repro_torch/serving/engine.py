"""Continuous-batching serving on PyTorch (counterpart of
`repro.serving.engine`).

The ParalleX reading of serving (DESIGN.md §4): each request is a
first-class object whose completion is an LCO — `submit` returns a
`core.lco.Future` that is set exactly once when the request finishes.
Arriving requests are parcels; decode is a dataflow chain per slot,
and the engine packs ready slots into batched decode steps.

Three engines share that skeleton, as in the reference:

* `ChunkedPagedServingEngine` (the default `ServingEngine`): prompts
  are split into page-aligned CHUNKS and every `step()` spends a token
  budget on the decode batch first and pending chunks in the
  remainder (DESIGN.md §4b), over the AGAS page pool of
  `serving/kvcache.py`, with prefix-cache compute skip (§4e) and
  preemption — mid-decode and mid-prefill — under page pressure.
* `PagedServingEngine`: the whole-prompt baseline over the same page
  pool — each admission runs one bucketed prefill of the entire
  prompt (`T.prefill`, flash attention) before decode resumes; the
  chunked engine takes decode, resume and preemption from it.
* `DenseServingEngine`: the static-ownership baseline — a bulk
  (slots, max_len) cache with one shared position clock (`T.init_cache`
  / `T.decode_step`); prompts are left-padded to their bucket.  It is
  also the engine of the ``ssm`` family, whose recurrent state has no
  paged layout: `make_engine` sends it there whatever ``engine`` says.

The disaggregated engine, tiering, sharded pools and failure plans are
not ported yet and raise `NotImplementedError` naming their ROADMAP
item.

On the card the model steps run the hand-written CUDA kernels (paged
decode, chunked prefill, flash attention; the selective scan for the
ssm family); on the CPU
(``device="cpu"``) their plain PyTorch versions.  Page pools and the
dense cache are updated in place.  Sampling is greedy argmax, or a
`torch.Generator` seeded with ``rid * 7919 + n_gen``.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.lco import Future
from repro_torch.device import DeviceLike, check_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.slo import FlightRecorder, NULL_RECORDER, classify, \
    record_verdict
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.kvcache import (PagedKVCache, PageExhausted,
                                         PAGED_FAMILIES)
from repro_torch.serving.types import Completion, Request
from repro_torch.serving.workers import (DecodeWorker, PrefillWorker,
                                         StepScheduler)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP {item})")


def _refuse_unported(tiering: bool = False, host_pages: int = 0,
                     kv_shards: int = 1, failure_plan=None) -> None:
    """Raise for the options whose subsystems are not ported yet."""
    if kv_shards != 1:
        raise _not_ported("a sharded page pool", "Queue A item 5")
    if tiering or host_pages:
        raise _not_ported("tiering", "Queue A item 4")
    if failure_plan is not None:
        raise _not_ported("failure plans", "Queue A item 6")


class _EngineBase:
    """Queue intake, bucketed prefill, sampling, and the run loop."""

    def __init__(self, params: Any, cfg: ArchConfig, *, slots: int,
                 max_len: int, prefill_buckets=(64, 128, 256),
                 device: DeviceLike = None, tracer=None,
                 flight_recorder=False):
        self.device = check_device(params, device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.buckets = tuple(sorted(prefill_buckets))
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.metrics = MetricsRegistry()
        # per-request lifecycle timelines (obs/slo.py); disabled is a
        # constant-time no-op singleton, mirroring NULL_TRACER
        self.recorder = FlightRecorder() if flight_recorder \
            else NULL_RECORDER
        self.slo_verdicts: Dict[int, dict] = {}   # rid -> classify()
        # queue items: {"req", "gen" (tokens carried over a
        # preemption), "preempts"}
        self.queue: List[dict] = []
        self.active: Dict[int, dict] = {}      # slot -> request state
        self.free_slots = list(range(slots))
        self.completions: List[Completion] = []
        self._futures: Dict[int, Future] = {}
        self._prefills: Dict[int, Any] = {}

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    # -- observability ------------------------------------------------
    def _record_step_metrics(self, c: dict) -> None:
        """Fold one per-step counter dict into the registry."""
        m = self.metrics
        m.counter("engine.steps").inc()
        m.gauge("engine.peak_active").set_max(c["active"])
        resident = c.get("resident", c["active"])
        m.gauge("engine.peak_resident").set_max(resident)
        m.histogram("engine.resident").record(resident)
        if "page_occupancy" in c:
            m.gauge("engine.peak_page_occupancy").set_max(
                c["page_occupancy"])
        m.histogram("engine.decode_ms").record(c["decode_ms"])

    # -- request intake (a parcel arriving at the engine locality) ----
    def submit(self, req: Request) -> Future:
        """Enqueue; returns the completion LCO (set exactly once)."""
        fut = Future()
        self._futures[req.rid] = fut
        t_submit = time.perf_counter()
        self.queue.append({"req": req, "gen": [], "preempts": 0,
                           "t_submit": t_submit,
                           "ttft_s": None, "tok_t": []})
        self.trace.instant("engine", "submit", rid=req.rid,
                           prompt_len=len(req.prompt))
        if self.recorder.enabled:
            self.recorder.event(req.rid, "submit", t=t_submit,
                                prompt_len=len(req.prompt))
        return fut

    def _slot_bind(self, rid: int, slot: int) -> None:
        """Admission boundary: trace instant + flight-recorder bind."""
        self.trace.instant("engine", "slot_bind", rid=rid, slot=slot)
        if self.recorder.enabled:
            self.recorder.event(rid, "bind", slot=slot)

    @staticmethod
    def _queue_prompt(item: dict) -> np.ndarray:
        """Prompt + any tokens generated before a preemption."""
        req = item["req"]
        if item["gen"]:
            return np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(item["gen"], np.int32)])
        return np.asarray(req.prompt, np.int32)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        # beyond the ladder: multiples of the largest bucket, so the
        # prefill shapes stay bounded
        big = self.buckets[-1]
        return -(-n // big) * big

    @staticmethod
    def _pad_to(tokens: np.ndarray, length: int) -> np.ndarray:
        padded = np.zeros(length, np.int32)
        padded[length - len(tokens):] = tokens           # left-pad
        return padded

    def _padded_prompt(self, tokens: np.ndarray) -> np.ndarray:
        return self._pad_to(tokens, self._bucket(len(tokens)))

    def _prefill_fn(self, bucket: int):
        """The prefill of one bucket, kept per bucket as the reference
        keeps one compiled prefill per bucket (`_prefills` lists the
        rungs served).  The last index is an argument, so a
        right-padded prompt never needs an entry of its own."""
        if bucket not in self._prefills:
            cfg = self.cfg

            def fn(params, tokens, last_index):
                hidden, cache = T.prefill(params, {"tokens": tokens}, cfg,
                                          last_index=last_index)
                return T.logits_fn(params, hidden), cache
            self._prefills[bucket] = fn
        return self._prefills[bucket]

    def _sample(self, logits: torch.Tensor, req: Request,
                n_gen: int) -> int:
        """Sample keyed by (rid, generated-token count) — each step of
        each request gets its own seeded generator."""
        if req.temperature <= 0:
            return int(torch.argmax(logits))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(req.rid * 7919 + n_gen)
        probs = torch.softmax(logits.float() / req.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _reject(self, item: dict, err: Exception) -> None:
        """Fail one request without killing the engine: its completion
        LCO carries the error; everything else keeps flowing."""
        fut = self._futures.pop(item["req"].rid, None)
        if fut is not None:
            fut.set_error(err)

    def _finish_queued(self, item: dict) -> None:
        """Finish a queued (preempted) request without re-admitting it,
        delivering the generation it carries (re-admission hit the
        length cap: its generated tokens are real work)."""
        now = time.perf_counter()
        self._finish({"req": item["req"], "tokens": list(item["gen"]),
                      "prefill_s": 0.0, "t0": now,
                      "preempts": item.get("preempts", 0),
                      **self._latency_state(item, now)})

    def _fail_pending(self, err: Exception) -> None:
        """Fail every request still queued or active (engine exiting
        with work pending): each completion LCO carries the error, and
        pages/slots are reclaimed so the engine stays usable."""
        for slot in list(self.active):
            self.active.pop(slot)
            kvc = getattr(self, "kvc", None)
            if kvc is not None:
                kvc.release(slot)
            self.free_slots.append(slot)
        self.queue.clear()
        for rid in list(self._futures):
            fut = self._futures.pop(rid)
            if not fut.done():
                fut.set_error(err)

    def _finish(self, st: dict) -> None:
        tok_t = st.get("tok_t", [])
        now = time.perf_counter()
        comp = Completion(st["req"].rid, st["tokens"], st["prefill_s"],
                          now - st["t0"],
                          st.get("preempts", 0),
                          ttft_s=st.get("ttft_s") or 0.0,
                          itl_s=[b - a for a, b in zip(tok_t, tok_t[1:])])
        self.completions.append(comp)
        m = self.metrics
        m.histogram("engine.prefill_ms").record(comp.prefill_s * 1e3)
        if comp.ttft_s > 0.0:
            m.histogram("engine.ttft_ms").record(comp.ttft_s * 1e3)
        itl_hist = m.histogram("engine.itl_ms")
        for d in comp.itl_s:
            itl_hist.record(d * 1e3)
        self.trace.instant("engine", "finish", rid=comp.rid,
                           n_tokens=len(comp.tokens))
        if self.recorder.enabled:
            self.recorder.event(comp.rid, "finish", t=now,
                                n_tokens=len(comp.tokens))
        req = st["req"]
        if req.ttft_deadline_ms is not None or \
                req.itl_deadline_ms is not None:
            v = classify(req, comp,
                         timeline=self.recorder.timeline(comp.rid))
            record_verdict(m, v)
            self.slo_verdicts[comp.rid] = v
        fut = self._futures.pop(comp.rid, None)
        if fut is not None:
            fut.set(comp)

    @staticmethod
    def _latency_state(item: dict, now: float) -> dict:
        """TTFT / inter-token bookkeeping threaded from a queue item
        into a slot state (and back, across preemptions)."""
        return {"t_submit": item.get("t_submit", now),
                "ttft_s": item.get("ttft_s"),
                "tok_t": list(item.get("tok_t", []))}

    def _first_token(self, st: dict, now: float) -> None:
        if st["ttft_s"] is None:
            st["ttft_s"] = now - st["t_submit"]
            if self.recorder.enabled:
                self.recorder.event(st["req"].rid, "first_token",
                                    t=now)
        st["tok_t"].append(now)

    @staticmethod
    def _stopped(req: Request, tokens: List[int]) -> bool:
        """EOS or length cap reached — checked after EVERY sampled
        token, including the one prefill produces."""
        if req.eos_id is not None and tokens and \
                tokens[-1] == req.eos_id:
            return True
        return len(tokens) >= req.max_new_tokens

    def step(self) -> int:
        """One scheduling step (the root span of the per-step trace)."""
        if not self.trace.enabled:
            return self._step()
        with self.trace.span("engine", "step") as sp:
            n = self._step()
            sp.args["ran"] = n
        return n

    def _step(self) -> int:
        raise NotImplementedError

    def _admit(self) -> None:
        raise NotImplementedError

    def run_to_completion(self, max_steps: int = 10_000,
                          on_step=None) -> None:
        """Drive the engine until idle.  Never exits with submitted
        futures unset: exhausting `max_steps`, or a permanently
        head-of-line-blocked queue, fails the remaining futures."""
        blocked_len = -1
        for _ in range(max_steps):
            if not self.active and not self.queue:
                return
            n = self.step()              # step() admits first
            if on_step is not None:
                on_step(self)
            if n == 0 and not self.active and self.queue:
                if len(self.queue) == blocked_len:
                    self._fail_pending(RuntimeError(
                        f"head-of-line blocked: {len(self.queue)} "
                        "queued request(s) cannot be admitted and "
                        "nothing is active to free pages"))
                    return
                blocked_len = len(self.queue)
            else:
                blocked_len = -1
        if self.active or self.queue:
            self._fail_pending(RuntimeError(
                f"run_to_completion exhausted max_steps={max_steps} "
                f"with {len(self.active)} active and "
                f"{len(self.queue)} queued request(s)"))


class DenseServingEngine(_EngineBase):
    """Static bulk KV ownership: (slots, max_len), one shared clock.

    The CSP-style baseline, kept for parity tests and comparisons.
    Prompts are LEFT-padded with token 0 to their bucket and the pad
    is attended over (no pad mask); each prefill cache is spliced into
    the slot pool and the shared ``len``/``cursor``/``abs`` clock keeps
    the max, so the clock is exact only when every resident prompt
    filled the same bucket.  One batched decode runs over all slots,
    idle ones included.  These are the reference's semantics, carried
    over as they are.
    """

    def __init__(self, params: Any, cfg: ArchConfig, *, slots: int = 4,
                 max_len: int = 512, prefill_buckets=(64, 128, 256),
                 tracer=None, flight_recorder=False,
                 device: DeviceLike = None):
        super().__init__(params, cfg, slots=slots, max_len=max_len,
                         prefill_buckets=prefill_buckets, device=device,
                         tracer=tracer, flight_recorder=flight_recorder)
        # one shared batched cache across slots
        self.cache = T.init_cache(cfg, slots, max_len, device=self.device)

    def _admit(self) -> None:
        while self.queue and self.free_slots:
            item = self.queue.pop(0)
            req = item["req"]
            toks = self._padded_prompt(self._queue_prompt(item))
            bucket = len(toks)
            if bucket > self.max_len:
                self._reject(item, ValueError(
                    f"request {req.rid}: padded prompt {bucket} "
                    f"exceeds max_len {self.max_len}"))
                continue
            slot = self.free_slots.pop(0)
            self._slot_bind(req.rid, slot)
            t0 = time.perf_counter()
            with self.trace.span("engine", "prefill", kind="compute",
                                 rid=req.rid, bucket=bucket):
                logits, pcache = self._prefill_fn(bucket)(
                    self.params, self._tensor(toks[None]), bucket - 1)
            if self.recorder.enabled:
                self.recorder.event(req.rid, "prefill", bucket=bucket,
                                    dur=time.perf_counter() - t0)
            # splice this request's prefill cache into the slot pool
            self._splice_cache(slot, pcache)
            first = self._sample(logits[0], req, len(item["gen"]))
            now = time.perf_counter()
            self.active[slot] = {
                "req": req, "tokens": item["gen"] + [int(first)],
                "prefill_s": now - t0,
                "t0": now,
                "preempts": item["preempts"],
                **self._latency_state(item, now),
            }
            self._first_token(self.active[slot], now)
            if self._stopped(req, self.active[slot]["tokens"]):
                self._finish(self.active.pop(slot))
                self.free_slots.append(slot)

    def _splice_cache(self, slot: int, pcache: dict) -> None:
        """Write every entry of a one-request prefill cache (k/v
        (L, 1, S', KV, D); the ssm family's ``ssm``/``conv`` state) into
        `slot` of the pool's entry: the batch axis is the first where
        the part has 1 and the pool `slots`, and the part is zero-padded
        to the pool's other extents (the reference's `_splice_cache`).
        The shared counters keep their max."""
        for key, pool in self.cache.items():
            part = pcache.get(key)
            if key in ("len", "cursor", "abs") or part is None or \
                    pool.ndim == 0:
                continue
            ax = next((ax for ax in range(pool.ndim)
                       if part.shape[ax] == 1 and
                       pool.shape[ax] == self.slots), None)
            if ax is None:
                continue
            row = pool.select(ax, slot)
            src = part.select(ax, 0)
            row.zero_()
            row[tuple(slice(0, n) for n in src.shape)] = src.to(pool.dtype)
        for key in ("len", "cursor", "abs"):
            self.cache[key] = torch.maximum(self.cache[key], pcache[key])

    # -- the decode work-queue ----------------------------------------
    def _step(self) -> int:
        """One batched decode step over all slots."""
        with self.trace.span("engine", "admit", kind="sched"):
            self._admit()
        if not self.active:
            return 0
        tokens = np.zeros((self.slots, 1), np.int32)
        for slot, st in self.active.items():
            tokens[slot, 0] = st["tokens"][-1]
        with self.trace.span("engine", "decode_batch", kind="compute",
                             n=len(self.active)):
            logits, self.cache = T.decode_step(
                self.params, self.cache, {"tokens": self._tensor(tokens)},
                self.cfg)
        done = []
        now = time.perf_counter()
        for slot, st in self.active.items():
            req = st["req"]
            tok = self._sample(logits[slot], req, len(st["tokens"]))
            st["tokens"].append(tok)
            st["tok_t"].append(now)
            if self._stopped(req, st["tokens"]):
                done.append(slot)
        for slot in done:
            self._finish(self.active.pop(slot))
            self.free_slots.append(slot)
        return len(self.active) + len(done)


class PagedServingEngine(_EngineBase):
    """KV memory as AGAS pages: demand allocation, prefix sharing,
    page-gated admission, and preemption under pressure.  Each
    admission prefills the whole prompt at its bucket (right-padded in
    the compute buffer only: the cache layout stays pad-free) and
    attaches its K/V as pages; the chunked engine subclasses it.

    ``prefix_cache_compute=True`` (DESIGN.md §4e): every prefill
    checkpoints the post-norm hidden state at each page's last
    position into the prefix index, and a later prompt fully covered
    by cached pages admits straight to decode — its first token is
    sampled from the cached checkpoint (`T.resume_prefill`).  Greedy
    outputs are token-identical with the flag on or off.  This
    whole-prompt engine skips full covers only; the chunked engine also
    resumes partially covered prompts at the cover's end.
    """

    def __init__(self, params: Any, cfg: ArchConfig, *, slots: int = 4,
                 max_len: int = 512, prefill_buckets=(64, 128, 256),
                 page_size: int = 16, n_pages: Optional[int] = None,
                 kv_shards: int = 1, tiering: bool = False,
                 host_pages: int = 0,
                 prefix_cache_compute: bool = False,
                 pin_threshold: int = 4, tracer=None,
                 flight_recorder=False, failure_plan=None,
                 device: DeviceLike = None):
        _refuse_unported(tiering=tiering, host_pages=host_pages,
                         kv_shards=kv_shards, failure_plan=failure_plan)
        super().__init__(params, cfg, slots=slots, max_len=max_len,
                         prefill_buckets=prefill_buckets, device=device,
                         tracer=tracer, flight_recorder=flight_recorder)
        if n_pages is None:
            # default: the dense engine's worst-case footprint
            n_pages = slots * (-(-max_len // page_size))
        self.kvc = PagedKVCache(cfg, slots, max_len, n_pages, page_size,
                                device=self.device,
                                pin_threshold=pin_threshold,
                                tracer=self.trace)
        self._seq = itertools.count()          # admission order
        self.preemptions = 0
        self.counters: List[dict] = []         # per-step telemetry
        # prefix-cache compute skip (DESIGN.md §4e)
        self._prefix_skip = bool(prefix_cache_compute)
        self.prefix_skips = 0            # fully-covered admissions
        self.prefix_partial_hits = 0     # partially-covered admissions
        self.prefill_tokens_skipped = 0  # prompt tokens never recomputed

    def _prefill_fn(self, bucket: int):
        """The base engine's per-bucket prefill, keeping every position
        (``full_kv``) and also returning the post-norm hidden at every
        page boundary plus the true last position — the activation
        checkpoints the prefix index stores for compute skip (§4e)."""
        if bucket not in self._prefills:
            cfg = self.cfg
            ps = self.kvc.pool.page_size

            def fn(params, tokens, last_index):
                hidden, cache = T.prefill(params, {"tokens": tokens}, cfg,
                                          full_kv=True, all_hidden=True)
                last = hidden[:, last_index]
                return (T.logits_fn(params, last), cache,
                        hidden[:, ps - 1::ps], last)
            self._prefills[bucket] = fn
        return self._prefills[bucket]

    # -- prefix-cache compute skip (DESIGN.md §4e) --------------------
    def _admit_skip(self, item: dict, layout: np.ndarray, real: int,
                    cov) -> bool:
        """Admit the queue head's fully-covered prompt straight to
        decode: attach the cached pages by refcount and sample the
        first token from the stored activation checkpoint — zero
        prefill compute.  False leaves the item at the queue head."""
        kvc = self.kvc
        need = sum(kvc.pool.page_cost(k) for k in cov.keys) + 1
        if need + self._upcoming_allocs() > kvc.pool.free_pages:
            return False
        self.queue.pop(0)
        slot = self.free_slots.pop(0)
        self._slot_bind(item["req"].rid, slot)
        t0 = time.perf_counter()
        try:
            kvc.attach_covered(slot, layout, cov.keys)
        except PageExhausted:
            self.free_slots.append(slot)
            self.queue.insert(0, item)
            return False
        req = item["req"]
        tr = time.perf_counter() if self.recorder.enabled else 0.0
        with self.trace.span("engine", "resume", kind="compute",
                             rid=req.rid, slot=slot):
            logits = T.resume_prefill(self.params, cov.hidden[None])
        if self.recorder.enabled:
            self.recorder.event(req.rid, "resume",
                                dur=time.perf_counter() - tr)
        first = self._sample(logits[0], req, len(item["gen"]))
        now = time.perf_counter()
        self.prefix_skips += 1
        self.prefill_tokens_skipped += real
        self.active[slot] = {
            "req": req, "tokens": item["gen"] + [int(first)],
            "phase": "decode",       # no prefill phase at all (§4e)
            "n_gen0": len(item["gen"]),
            "prefill_s": now - t0,
            "t0": now,
            "seq": next(self._seq),
            "preempts": item["preempts"],
            **self._latency_state(item, now),
        }
        self._first_token(self.active[slot], now)
        if self._stopped(req, self.active[slot]["tokens"]):
            self._finish(self.active.pop(slot))
            kvc.release(slot)
            self.free_slots.append(slot)
        return True

    # -- page-gated admission -----------------------------------------
    def _admission_layout(self, item: dict) -> Optional[tuple]:
        """Rebuild the queue head's position-normalized token layout
        (prompt + tokens generated before a preemption, no pad) and
        screen out requests that can never run.  Returns (layout,
        real, need) — `need` counting fresh prefill pages plus one
        decode page of headroom — or None if the item was rejected
        (and popped)."""
        req = item["req"]
        layout = self._queue_prompt(item)
        real = len(layout)
        if real > self.max_len:
            self.queue.pop(0)
            if item["gen"]:
                self._finish_queued(item)
            else:
                self._reject(item, ValueError(
                    f"request {req.rid}: prompt {real} "
                    f"exceeds max_len {self.max_len}"))
            return None
        need = self.kvc.pages_needed(layout) + 1
        if need > self.kvc.pool.capacity:
            self.queue.pop(0)
            if item["gen"]:
                self._finish_queued(item)
            else:
                self._reject(item, RuntimeError(
                    f"request {req.rid} needs {need} pages but the "
                    f"pool holds {self.kvc.pool.capacity}"))
            return None
        return layout, real, need

    def _upcoming_allocs(self) -> int:
        """Pages the CURRENT step's committed work will still take —
        the admission watermark."""
        return sum(1 for s in self.active if self.kvc.needs_alloc(s))

    def _admit(self) -> None:
        while self.queue and self.free_slots:
            item = self.queue[0]
            req = item["req"]
            adm = self._admission_layout(item)
            if adm is None:
                continue
            layout, real, need = adm
            if self._prefix_skip:
                cov = self.kvc.covered_prefix(layout)
                if cov.full:
                    if self._admit_skip(item, layout, real, cov):
                        continue
                    break                      # head-of-line blocking
            # admit on PAGES, not slots: prefill pages (prefix-shared
            # ones are free), one decode page of headroom, plus the
            # watermark of active slots whose next write takes a page
            upcoming = self._upcoming_allocs()
            if need + upcoming > self.kvc.pool.free_pages:
                break                          # head-of-line blocking
            self.queue.pop(0)
            slot = self.free_slots.pop(0)
            self._slot_bind(req.rid, slot)
            t0 = time.perf_counter()
            # prefill at the bucket ladder, padded RIGHT: junk tokens
            # after the real end never enter the cache and, under
            # causality, cannot reach earlier positions
            bucket = self._bucket(real)
            toks = np.zeros(bucket, np.int32)
            toks[:real] = layout
            tr = time.perf_counter() if self.recorder.enabled else 0.0
            with self.trace.span("engine", "prefill", kind="compute",
                                 rid=req.rid, bucket=bucket):
                logits, pcache, bh, hlast = self._prefill_fn(bucket)(
                    self.params, self._tensor(toks[None]), real - 1)
            if self.recorder.enabled:
                self.recorder.event(req.rid, "prefill", bucket=bucket,
                                    dur=time.perf_counter() - tr)
            self.kvc.attach(slot, layout, pcache["k"][:, 0, :real],
                            pcache["v"][:, 0, :real])
            if self._prefix_skip:
                # copies, so the prompt's hidden states are not kept
                # alive by the checkpoints
                self.kvc.store_hidden_prefill(slot, real, bh[0].clone(),
                                              hlast[0].clone())
            first = self._sample(logits[0], req, len(item["gen"]))
            now = time.perf_counter()
            self.active[slot] = {
                "req": req, "tokens": item["gen"] + [int(first)],
                "prefill_s": now - t0,
                "t0": now,
                "seq": next(self._seq),
                "preempts": item["preempts"],
                **self._latency_state(item, now),
            }
            self._first_token(self.active[slot], now)
            if self._stopped(req, self.active[slot]["tokens"]):
                self._finish(self.active.pop(slot))
                self.kvc.release(slot)
                self.free_slots.append(slot)

    # -- preemption under page pressure -------------------------------
    def _preempt(self, slot: int) -> None:
        """Evict a request: free its pages and requeue it at the FRONT
        with its progress; re-admission re-prefills the identical
        position-normalized layout (prompt + generated tokens)."""
        st = self.active.pop(slot)
        self.kvc.release(slot)
        self.free_slots.append(slot)
        self.preemptions += 1
        self.trace.instant("engine", "preempt", rid=st["req"].rid,
                           slot=slot, offloaded=False)
        if self.recorder.enabled:
            self.recorder.event(st["req"].rid, "preempt", slot=slot,
                                offloaded=False)
        self.queue.insert(0, {"req": st["req"], "gen": st["tokens"],
                              "preempts": st["preempts"] + 1,
                              "prefill_s": st.get("prefill_s", 0.0),
                              "t_submit": st["t_submit"],
                              "ttft_s": st.get("ttft_s"),
                              "tok_t": st.get("tok_t", [])})

    def _decode_slots(self) -> List[int]:
        """Slots currently in the decode phase (prefilling slots ride
        the decode batch as masked passengers)."""
        return [s for s in self.active
                if self.active[s].get("phase", "decode") == "decode"]

    def _prepare_writes(self, slots: Optional[List[int]] = None) -> None:
        """Reserve every decoding slot's write page, preempting the
        youngest request (LIFO) until the pool fits.  A lone request
        the pool cannot hold is failed via its LCO, not the engine."""
        while True:
            try:
                todo = [s for s in slots if s in self.active] \
                    if slots is not None else self._decode_slots()
                for slot in sorted(todo,
                                   key=lambda s: self.active[s]["seq"]):
                    self.kvc.prepare_decode(slot)
                return
            except PageExhausted:
                if len(self.active) <= 1:
                    slot, st = next(iter(self.active.items()))
                    self.active.pop(slot)
                    self.kvc.release(slot)
                    self.free_slots.append(slot)
                    self._reject({"req": st["req"]}, RuntimeError(
                        "page pool too small for request "
                        f"{st['req'].rid}: {self.kvc.pool.capacity} "
                        f"pages of {self.kvc.pool.page_size}"))
                    return
                victim = max(self.active,
                             key=lambda s: self.active[s]["seq"])
                self._preempt(victim)

    # -- the decode work-queue ----------------------------------------
    def _decode_batch(self, slots: List[int]) -> List[int]:
        """One decode step for `slots`: assemble the batch, sample each
        slot's next token, finish/release requests that hit EOS or
        their length cap.  Returns the finished slots."""
        if not self.trace.enabled:
            return self._decode_batch_impl(slots)
        with self.trace.span("engine", "decode_batch", kind="compute",
                             n=len(slots)) as sp:
            done = self._decode_batch_impl(slots)
            sp.args["finished"] = len(done)
        return done

    def _decode_batch_impl(self, slots: List[int]) -> List[int]:
        tokens = np.zeros((self.slots, 1), np.int64)
        for slot in slots:
            tokens[slot, 0] = self.active[slot]["tokens"][-1]
        batch = {"tokens": self._tensor(tokens),
                 **self.kvc.batch_inputs()}
        logits, _ = T.decode_step_paged(self.params, self.kvc.pool.pages,
                                        batch, self.cfg)
        done: List[int] = []
        now = time.perf_counter()
        for slot in slots:
            st = self.active[slot]
            self.kvc.advance(slot)
            req = st["req"]
            tok = self._sample(logits[slot], req, len(st["tokens"]))
            st["tokens"].append(tok)
            st["tok_t"].append(now)
            if self._stopped(req, st["tokens"]):
                done.append(slot)
        for slot in done:
            self._finish(self.active.pop(slot))
            self.kvc.release(slot)
            self.free_slots.append(slot)
        return done

    def _step(self) -> int:
        """One batched decode step over all active slots."""
        with self.trace.span("engine", "admit", kind="sched"):
            self._admit()
        # truncate requests whose next token has no cache room left
        for slot in [s for s in self.active
                     if self.kvc.lengths[s] >= self.max_len]:
            self._finish(self.active.pop(slot))
            self.kvc.release(slot)
            self.free_slots.append(slot)
        if not self.active:
            return 0
        with self.trace.span("engine", "prepare_writes", kind="pages"):
            self._prepare_writes()
        if not self.active:                    # lone request rejected
            return 0
        t0 = time.perf_counter()
        done = self._decode_batch(list(self.active))
        pool = self.kvc.pool
        self.counters.append({
            "t": time.perf_counter(),
            "queue_depth": len(self.queue),
            "active": len(self.active) + len(done),
            "resident": len(self.active) + len(done),
            "pages_used": pool.used_pages,
            "page_occupancy": pool.occupancy(),
            "preemptions": self.preemptions,
            "decode_ms": (time.perf_counter() - t0) * 1e3,
        })
        self._record_step_metrics(self.counters[-1])
        return len(self.active) + len(done)

    def stats(self) -> dict:
        """Aggregate telemetry assembled from the metrics registry
        (the Fig 9 overhead view); safe before the first completion."""
        m = self.metrics
        pool = self.kvc.pool
        for name, v in pool.metrics().items():
            if isinstance(v, (int, float)):
                m.gauge(name).set(v)
        m.counter("engine.preemptions").value = self.preemptions
        m.counter("engine.prefix_skips").value = self.prefix_skips
        m.counter("engine.prefix_partial_hits").value = \
            self.prefix_partial_hits
        m.counter("engine.prefill_tokens_skipped").value = \
            self.prefill_tokens_skipped
        ttft = m.histogram("engine.ttft_ms")
        itl = m.histogram("engine.itl_ms")
        out = {
            "steps": int(m.counter("engine.steps").value),
            "peak_active": int(m.gauge("engine.peak_active").value),
            "peak_resident": int(m.gauge("engine.peak_resident").value),
            "mean_resident": m.histogram("engine.resident").mean,
            "peak_page_occupancy": float(
                m.gauge("engine.peak_page_occupancy").value),
            "mean_decode_ms": m.histogram("engine.decode_ms").mean,
            "preemptions": self.preemptions,
            "page_allocs": pool.allocs,
            "page_shares": pool.shares,
            "cow_copies": pool.cow_copies,
            "kv_shards": pool.n_shards,
            "mean_prefill_ms": m.histogram("engine.prefill_ms").mean,
            "mean_ttft_ms": ttft.mean,
            "ttft_p50_ms": ttft.quantile(50.0),
            "ttft_p95_ms": ttft.quantile(95.0),
            "ttft_p99_ms": ttft.quantile(99.0),
            "mean_itl_ms": itl.mean,
            "itl_p50_ms": itl.quantile(50.0),
            "itl_p95_ms": itl.quantile(95.0),
            "itl_p99_ms": itl.quantile(99.0),
            "prefix_cache_compute": self._prefix_skip,
            "prefix_skips": self.prefix_skips,
            "prefix_partial_hits": self.prefix_partial_hits,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
        }
        tracked = m.get("slo.requests")
        if tracked is not None and tracked.value:
            from repro_torch.obs.slo import BLAME_PHASES
            snap = m.snapshot()
            out["slo"] = {
                "requests": int(tracked.value),
                "met": int(snap.get("slo.met", 0)),
                "goodput": float(snap.get("slo.goodput", 0.0)),
                "ttft_misses": int(snap.get("slo.ttft_misses", 0)),
                "itl_misses": int(snap.get("slo.itl_misses", 0)),
                "blame": {p: int(snap.get(f"slo.blame.{p}", 0))
                          for p in BLAME_PHASES + ("unattributed",)},
            }
        return out


class ChunkedPagedServingEngine(PagedServingEngine):
    """Chunked prefill under a token-budget step scheduler.

    The serving grain is a page-size-aligned CHUNK of a prompt
    (DESIGN.md §4b): every `step()` spends at most `step_tokens`
    tokens — one per decoding slot first (decode priority), pending
    prefill chunks filling the remainder in admission order.
    Admission is gated on the FIRST chunk's pages (plus headroom);
    later chunks allocate as they run, and page exhaustion mid-prefill
    preempts LIFO exactly like exhaustion mid-decode (the preempted
    request re-prefills from scratch on re-admission — deterministic,
    since an identical pad-free layout reproduces identical pages).

    With ``prefix_cache_compute=True`` (§4e) fully-covered prompts skip
    prefill entirely and partially-covered ones attach the cached pages
    by refcount and start chunking at the cover's end.
    """

    def __init__(self, params: Any, cfg: ArchConfig, *, slots: int = 4,
                 max_len: int = 512, prefill_buckets=(64, 128, 256),
                 page_size: int = 16, n_pages: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 step_tokens: Optional[int] = None,
                 kv_shards: int = 1, tiering: bool = False,
                 host_pages: int = 0,
                 prefix_cache_compute: bool = False,
                 pin_threshold: int = 4, tracer=None,
                 flight_recorder=False, failure_plan=None,
                 device: DeviceLike = None):
        super().__init__(params, cfg, slots=slots, max_len=max_len,
                         prefill_buckets=prefill_buckets,
                         page_size=page_size, n_pages=n_pages,
                         kv_shards=kv_shards, tiering=tiering,
                         host_pages=host_pages,
                         prefix_cache_compute=prefix_cache_compute,
                         pin_threshold=pin_threshold,
                         tracer=tracer,
                         flight_recorder=flight_recorder,
                         failure_plan=failure_plan, device=device)
        if chunk_size is None:
            chunk_size = 2 * page_size
        if chunk_size <= 0 or chunk_size % page_size:
            raise ValueError(
                f"chunk_size {chunk_size} must be a positive multiple "
                f"of page_size {page_size}")
        self.chunk_size = int(chunk_size)
        # every decoding slot gets its token, and at least one full
        # chunk always fits in the remainder-free case
        self.step_tokens = int(step_tokens or (slots + chunk_size))
        if self.step_tokens < self.chunk_size:
            raise ValueError(
                f"step_tokens {self.step_tokens} must cover at least "
                f"one chunk of {self.chunk_size}")
        # the role composition (DESIGN.md §4f): a role-agnostic token-
        # budget scheduler drives a prefill role and a decode role,
        # both running where the engine runs
        self._sched = StepScheduler(self.step_tokens, self.chunk_size,
                                    page_size)
        self._prefill_role = PrefillWorker()
        self._decode_role = DecodeWorker()

    def _chunk_step(self, toks, tables, start, rows, last: int):
        """One chunk through the model: logits at the true last
        position, that position's post-norm hidden, and the hidden at
        every page boundary (the activation checkpoints the prefix
        index stores for compute skip, §4e)."""
        ps = self.kvc.pool.page_size
        x, _ = T.prefill_chunk(self.params, self.kvc.pool.pages, {
            "tokens": toks, "block_tables": tables, "start": start,
            "chunk_rows": rows, "last_index": last}, self.cfg,
            all_hidden=True)
        out = x[:, last]
        return T.logits_fn(self.params, out), out, x[:, ps - 1::ps]

    # -- admission: gated on the first chunk, not the whole prompt ----
    def _upcoming_allocs(self) -> int:
        """The watermark counts EVERY allocation already committed for
        this step: decode writes at a page boundary/COW, AND the pages
        each mid-prefill slot's next chunk will take."""
        upcoming = sum(1 for s in self._decode_slots()
                       if self.kvc.needs_alloc(s))
        for s, st in self.active.items():
            if st.get("phase") == "prefill":
                nxt = min(st["pos"] + self.chunk_size, st["real"])
                upcoming += self.kvc.pages_needed_chunk(
                    st["layout"], st["pos"], nxt)
        return upcoming

    def _admit(self) -> None:
        while self.queue and self.free_slots:
            item = self.queue[0]
            req = item["req"]
            adm = self._admission_layout(item)
            if adm is None:
                continue
            layout, real, _ = adm
            # compute skip (§4e): a fully-covered prompt admits
            # straight to decode off its cached checkpoint; a partial
            # cover starts chunking at the cover's end
            start = 0
            cov = None
            if self._prefix_skip:
                cov = self.kvc.covered_prefix(layout)
                if cov.full:
                    if self._admit_skip(item, layout, real, cov):
                        continue
                    break                      # head-of-line blocking
                start = cov.covered
            # gate on the first UNCOVERED chunk plus one page of
            # headroom (and the watermark)
            first_end = min(start + self.chunk_size, real)
            upcoming = self._upcoming_allocs()
            need = self.kvc.pages_needed_chunk(layout, start,
                                               first_end) + 1
            if cov is not None:
                need += sum(self.kvc.pool.page_cost(k)
                            for k in cov.keys)
            if need + upcoming > self.kvc.pool.free_pages:
                break                          # head-of-line blocking
            self.queue.pop(0)
            slot = self.free_slots.pop(0)
            self._slot_bind(req.rid, slot)
            if start:
                try:
                    self.kvc.attach_covered(slot, layout, cov.keys)
                except PageExhausted:
                    self.free_slots.append(slot)
                    self.queue.insert(0, item)
                    break
                self.prefix_partial_hits += 1
                self.prefill_tokens_skipped += start
            now = time.perf_counter()
            self.active[slot] = {
                "req": req, "tokens": list(item["gen"]),
                "phase": "prefill",
                "layout": layout, "real": real, "pos": start,
                "prefill_s": 0.0,
                "t0": now,                      # reset at first token
                "seq": next(self._seq),
                "preempts": item["preempts"],
                "n_gen0": len(item["gen"]),
                    **self._latency_state(item, now),
            }

    # -- one prefill chunk as a schedulable task ----------------------
    def _run_chunk(self, slot: int, take: int) -> bool:
        """Acquire pages for and run one chunk of `slot`'s prompt.
        Returns False if the slot was preempted (or rejected) by page
        exhaustion instead of advanced."""
        rec = self.recorder.enabled
        if not self.trace.enabled and not rec:
            return self._run_chunk_impl(slot, take)
        st = self.active[slot]
        rid = st["req"].rid
        start = st["pos"]
        tr = time.perf_counter() if rec else 0.0
        if not self.trace.enabled:
            ok = self._run_chunk_impl(slot, take)
        else:
            with self.trace.span("engine", "prefill_chunk",
                                 kind="compute", rid=rid, slot=slot,
                                 start=start, take=take) as sp:
                ok = self._run_chunk_impl(slot, take)
                sp.args["ran"] = ok
        if rec:
            self.recorder.event(rid, "prefill_chunk", start=start,
                                take=take, ran=ok,
                                dur=time.perf_counter() - tr)
        return ok

    def _run_chunk_impl(self, slot: int, take: int) -> bool:
        st = self.active[slot]
        start = st["pos"]
        end = start + take
        while True:
            try:
                rows, _ = self.kvc.begin_chunk(slot, st["layout"],
                                               start, end)
                break
            except PageExhausted:
                if len(self.active) <= 1:
                    self.active.pop(slot)
                    self.kvc.release(slot)
                    self.free_slots.append(slot)
                    self._reject({"req": st["req"]}, RuntimeError(
                        "page pool too small for request "
                        f"{st['req'].rid}: {self.kvc.pool.capacity} "
                        f"pages of {self.kvc.pool.page_size}"))
                    return False
                victim = max(self.active,
                             key=lambda s: self.active[s]["seq"])
                self._preempt(victim)
                if victim == slot:
                    return False
        ps = self.kvc.pool.page_size
        t0 = time.perf_counter()
        toks = np.zeros(self.chunk_size, np.int64)
        toks[:take] = st["layout"][start:end]
        rows_arr = np.full(self.chunk_size // ps,
                           self.kvc.pool.null_row, np.int32)
        rows_arr[:len(rows)] = rows
        logits, hlast, bh = self._chunk_step(
            self._tensor(toks[None]),
            self._tensor(self.kvc.tables[slot][None]),
            self._tensor(np.asarray([start], np.int32)),
            self._tensor(rows_arr[None]),
            take - 1)
        if self._prefix_skip:
            # checkpoint the chunk's page-boundary activations into
            # the prefix index (copies, so the chunk's hidden states
            # are not kept alive) — later identical prefixes resume
            # from them instead of recomputing (§4e)
            self.kvc.store_hidden_chunk(slot, start, end,
                                        bh[0].clone(), hlast[0].clone())
        st["pos"] = end
        st["prefill_s"] += time.perf_counter() - t0
        if end == st["real"]:
            self._finish_prefill(slot, st, logits)
        return True

    def _finish_prefill(self, slot: int, st: dict, logits) -> None:
        """Final chunk landed: the prompt is resident — sample the
        first token and hand the slot to the decode batch."""
        now = time.perf_counter()
        st["phase"] = "decode"
        st["t0"] = now
        first = self._sample(logits[0], st["req"], st["n_gen0"])
        st["tokens"].append(int(first))
        self._first_token(st, now)
        if self._stopped(st["req"], st["tokens"]):
            self._finish(self.active.pop(slot))
            self.kvc.release(slot)
            self.free_slots.append(slot)

    # -- the token-budget step ----------------------------------------
    def _step(self) -> int:
        """One budgeted step: every decoding slot gets its token, and
        pending prefill chunks (FCFS by admission order) fill whatever
        budget remains.  A prompt whose final chunk lands this step
        samples its first token now but starts decoding next step."""
        with self.trace.span("engine", "admit", kind="sched"):
            self._admit()
        # truncate decoding requests whose next token has no cache room
        for slot in [s for s in self._decode_slots()
                     if self.kvc.lengths[s] >= self.max_len]:
            self._finish(self.active.pop(slot))
            self.kvc.release(slot)
            self.free_slots.append(slot)
        if not self.active:
            return 0
        done, decoding, n_chunks, prefill_tok, t0 = \
            self._sched.run_step(self, self._prefill_role,
                                 self._decode_role)
        pool = self.kvc.pool
        self.counters.append({
            "t": time.perf_counter(),
            "queue_depth": len(self.queue),
            "active": len(self.active) + len(done),
            "resident": len(self.active) + len(done),
            "pages_used": pool.used_pages,
            "page_occupancy": pool.occupancy(),
            "preemptions": self.preemptions,
            "decode_ms": (time.perf_counter() - t0) * 1e3,
            "prefill_chunks": n_chunks,
            "prefill_chunk_tokens": prefill_tok,
            "decode_tokens": len(decoding),
            "budget_tokens": self.step_tokens,
        })
        self._record_step_metrics(self.counters[-1])
        return len(self.active) + len(done)


#: The serving engine: chunked prefill over AGAS pages.
ServingEngine = ChunkedPagedServingEngine


def make_engine(params: Any, cfg: ArchConfig, *,
                engine: str = "chunked", disagg: bool = False,
                **kwargs) -> _EngineBase:
    """Engine factory.  `engine` selects the scheduler for the
    attention-cache families (dense, audio): "chunked" (default —
    chunked prefill under a token budget), "paged" (whole-prompt
    prefill over AGAS pages) or "dense" (static slot-pool baseline).
    The ssm family, whose recurrent state has no paged layout, always
    falls back to the dense engine, the page-pool options dropped (the
    reference's fallback).  ``disagg=True``, tiering, sharded pools and
    failure plans on the attention families, the moe family and the
    hybrid and vlm families raise `NotImplementedError` naming their
    ROADMAP item.  ``device`` (default ``"cuda"``) must be where
    `params` live."""
    if engine not in ("chunked", "paged", "dense"):
        raise ValueError(f"unknown engine {engine!r}")
    if disagg and engine != "chunked":
        raise ValueError(
            "disaggregated prefill/decode requires the chunked engine")
    if cfg.family not in T.PORTED_FAMILIES:
        item = "Queue A item 3" if cfg.family == "moe" \
            else "Queue A item 10"
        raise _not_ported(f"serving the {cfg.family!r} family", item)
    if cfg.family not in PAGED_FAMILIES:
        return DenseServingEngine(params, cfg, **_dense_kwargs(kwargs))
    if disagg:
        raise _not_ported("the disaggregated engine", "Queue A item 6")
    if engine == "chunked":
        kwargs.pop("prefill_workers", None)
        kwargs.pop("decode_workers", None)
        return ChunkedPagedServingEngine(params, cfg, **kwargs)
    if engine == "paged":
        kwargs.pop("chunk_size", None)
        kwargs.pop("step_tokens", None)
        return PagedServingEngine(params, cfg, **kwargs)
    # the reference's dense engine drops the page-pool options; the
    # port refuses the ones whose subsystems it does not have yet
    # rather than drop them unseen
    _refuse_unported(tiering=kwargs.get("tiering", False),
                     host_pages=kwargs.get("host_pages", 0),
                     kv_shards=kwargs.get("kv_shards", 1),
                     failure_plan=kwargs.get("failure_plan"))
    return DenseServingEngine(params, cfg, **_dense_kwargs(kwargs))


def _dense_kwargs(kwargs: dict) -> dict:
    """`kwargs` without the page-pool and worker options, which the
    dense engine has no use for."""
    drop = ("page_size", "n_pages", "chunk_size", "step_tokens",
            "kv_shards", "mesh", "rebalance_tolerance", "tiering",
            "host_pages", "prefix_cache_compute", "pin_threshold",
            "prefill_workers", "decode_workers", "failure_plan")
    return {k: v for k, v in kwargs.items() if k not in drop}
