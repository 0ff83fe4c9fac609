"""Prefill/decode worker roles and the role-agnostic step scheduler.

DESIGN.md §4f: the serving engine is a COMPOSITION — a token-budget
step scheduler that knows nothing about where work runs, plus two
roles it drives each step:

* the **prefill role** turns pending prompt chunks into executed
  chunks.  `PrefillWorker` runs them where the engine runs (the
  single-locality composition `ChunkedPagedServingEngine` uses);
  `ParcelPrefillWorker` lowers each chunk into a `PrefillParcel`
  dispatched through a `ParcelPort` to the AGAS locality that owns
  the prompt's prefix pages — the paper's "move the work to the
  data", at serving granularity.

* the **decode role** owns the decode batch.  `HandoffDecodeWorker`
  additionally commits staged prefill->decode KV handoffs at the top
  of its step, so the handoff copy staged under the PREVIOUS step's
  decode batch lands before this step's batch assembles (the §4d
  double-buffer pattern applied to the §4f role boundary).

The scheduler's budget policy is byte-for-byte the one the chunked
engine always had: every decoding slot reserves its token first,
pending prefill chunks fill the remainder FCFS by admission order,
budget-trimmed to page-aligned pieces, no overtaking.  Roles only
change WHERE a chunk executes, never WHETHER — which is why the
disaggregated engine stays greedy token-identical to the
single-locality one (the differential fuzzer asserts it).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

from repro_torch.core.agas import GlobalAddress
from repro_torch.core.parcels import (ActionRegistry, Parcel, PrefillParcel,
                                lower_prefill_parcels)

#: Actions a prefill worker executes.  One registry shared by every
#: engine instance — actions close over nothing; the engine arrives
#: as the parcel's `state`.
PREFILL_ACTIONS = ActionRegistry()


@PREFILL_ACTIONS.register("prefill_chunk")
def _prefill_chunk_action(engine: Any, target: Optional[GlobalAddress],
                          slot: int, take: int) -> bool:
    """Run one prefill chunk at the destination locality.  The slot
    may have been preempted by an earlier chunk's page pressure while
    this parcel sat in the inbound queue — then the parcel is a no-op
    (its request re-prefills after re-admission)."""
    st = engine.active.get(slot)
    ok = False
    if st is not None and st.get("phase") == "prefill":
        ok = engine._run_chunk(slot, take)
    engine._last_chunk_ok = ok
    return ok


class PrefillWorker:
    """Single-locality prefill role: chunks execute in place."""

    def pending(self, eng) -> List[int]:
        """Prefilling slots in admission order (FCFS by seq)."""
        return sorted((s for s in eng.active
                       if eng.active[s]["phase"] == "prefill"),
                      key=lambda s: eng.active[s]["seq"])

    def run_chunk(self, eng, slot: int, take: int) -> bool:
        return eng._run_chunk(slot, take)

    def flush(self, eng) -> None:
        """End-of-budget-loop hook (parcel batching); no-op locally."""


class ParcelPrefillWorker(PrefillWorker):
    """Parcel-dispatched prefill role (DESIGN.md §4f).

    Every chunk becomes a `PrefillParcel` whose destination is the
    engine's dispatch policy (`_dispatch_target`): the locality
    owning the prompt's radix-matched prefix pages when the prompt is
    warm, least-loaded among the prefill workers when cold.  The
    parcel is posted through the port (local apply or send + drain)
    and the step's parcels are batch-lowered per destination at
    canonical power-of-two sizes — the same size-class program cache
    the migration lowering uses, so dispatch compiles one program per
    (locality, size class), not one per step.
    """

    def __init__(self, n_workers: int):
        self.n_workers = int(n_workers)
        self.parcels = 0            # prefill parcels dispatched
        self.owner_parcels = 0      # ... to the prefix-owner locality
        self.cold_parcels = 0       # ... placed least-loaded (no owner)
        self.dispatch_sizes: set = set()   # canonical batch sizes seen
        self.inter_locality = 0     # parcels that crossed localities
        self._step_parcels: List[PrefillParcel] = []

    def run_chunk(self, eng, slot: int, take: int) -> bool:
        st = eng.active[slot]
        anchor, dst, warm = eng._dispatch_target(slot, st)
        self._step_parcels.append(PrefillParcel(
            rid=st["req"].rid, slot=slot, start=st["pos"], take=take,
            anchor=anchor, locality=dst))
        if eng.recorder.enabled:
            # the flight timeline keeps the dispatch decision next to
            # the chunk it placed: which locality, owner-affine or not
            eng.recorder.event(st["req"].rid, "dispatch", slot=slot,
                               loc=dst, warm=warm)
        self.parcels += 1
        if warm:
            self.owner_parcels += 1
        else:
            self.cold_parcels += 1
        home = eng._home_locality(slot)
        if dst != home:
            self.inter_locality += 1
        port = eng._port
        port.post(Parcel(target=anchor, action="prefill_chunk",
                         args=(slot, take)), dst, home, eng)
        if dst != home:
            port.drain(dst, eng)
        return bool(eng._last_chunk_ok)

    def flush(self, eng) -> None:
        """Lower the step's dispatched parcels into per-destination
        batches at canonical sizes (the compiled-dispatch accounting a
        multi-host port would execute as one program per locality)."""
        if not self._step_parcels:
            return
        lowering = lower_prefill_parcels(self._step_parcels)
        self.dispatch_sizes.update(lowering.sizes)
        self._step_parcels = []


class DecodeWorker:
    """Decode role: owns the decode batch."""

    def commit_handoffs(self, eng) -> None:
        """Step-top hook; only the disaggregated role commits."""

    def run_batch(self, eng, slots: List[int]) -> List[int]:
        return eng._decode_batch(slots)


class HandoffDecodeWorker(DecodeWorker):
    """Decode role that adopts prefill workers' finished KV: staged
    handoff snapshots are committed (restored into their slot) before
    the step schedules, so a prompt whose prefill finished in step N
    decodes from step N+1 — the same cadence the single-locality
    engine has, with the copy double-buffered under step N's decode
    batch instead of serialized before it."""

    def commit_handoffs(self, eng) -> None:
        for slot in [s for s, st in list(eng.active.items())
                     if st.get("phase") == "handoff"]:
            eng._commit_handoff(slot)


class StepScheduler:
    """Role-agnostic token-budget step (DESIGN.md §4b policy, §4f
    composition): decode reservation first, FCFS prefill chunks in
    the remainder, page-aligned budget trim, no overtaking.  A chunk
    that fails (page exhaustion preempted its slot) returns its
    budget to the chunks behind it — exactly the legacy loop."""

    def __init__(self, step_tokens: int, chunk_size: int,
                 page_size: int):
        self.step_tokens = int(step_tokens)
        self.chunk_size = int(chunk_size)
        self.page_size = int(page_size)

    def run_step(self, eng, prefill: PrefillWorker,
                 decode: DecodeWorker
                 ) -> Tuple[List[int], List[int], int, int, float]:
        """Returns (done, decoding, n_chunks, prefill_tok, t0)."""
        # the decode reservation is taken at step start; a slot whose
        # prefill completes THIS step joins the decode batch NEXT
        # step, so prefill chunks + decode tokens never exceed the
        # step's token budget
        decoding = eng._decode_slots()
        budget = self.step_tokens - len(decoding)
        prefill_tok = 0
        n_chunks = 0
        ps = self.page_size
        for slot in prefill.pending(eng):
            if slot not in eng.active:   # preempted by an earlier
                continue                 # chunk's page pressure
            st = eng.active[slot]
            take = min(self.chunk_size, st["real"] - st["pos"])
            if take > budget:
                # trim to the page-aligned piece the budget covers
                take = (budget // ps) * ps
            if take <= 0:
                break                    # FCFS: no overtaking
            if prefill.run_chunk(eng, slot, take):
                budget -= take
                prefill_tok += take
                n_chunks += 1
        prefill.flush(eng)
        # the decode batch: prefilling slots ride along masked (their
        # write row is the null page; their logits are discarded)
        done: List[int] = []
        decoding = [s for s in decoding if s in eng.active]
        if decoding:
            with eng.trace.span("engine", "prepare_writes",
                                 kind="pages"):
                eng._prepare_writes(decoding)
            decoding = [s for s in decoding if s in eng.active]
        # timer starts after write preparation, matching the
        # whole-prompt engine so mean_decode_ms stays comparable
        t0 = time.perf_counter()
        if decoding:
            done = decode.run_batch(eng, decoding)
        return done, decoding, n_chunks, prefill_tok, t0
