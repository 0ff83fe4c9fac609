"""AGAS-managed paged KV cache on torch tensors (counterpart of
`repro.serving.kvcache`, DESIGN.md §4a).

The bookkeeping is the reference's, copied: `PagePool` names every
page by an AGAS global address whose (locality, slot) is its physical
row, refcounts pages, keeps the radix prefix index over
position-normalized page-key chains and the activation checkpoints
compute skip resumes from (§4e); `PagedKVCache` keeps one block table
and one position clock per decode slot and attaches prompts whole
(`attach`) or one page-aligned chunk at a time (`begin_chunk`, §4b).

What changes is the device side.  The page arrays are torch tensors
on the pool's device — ``(L, n_pages + 1, page_size, KV, D)``, the
trailing row being the null page idle slots write into, or ``(L,
n_shards, pages_per_shard + 1, ...)`` for a pool sharded over
simulated localities — and every mutation (page scatter, COW clone)
is an in-place index copy where the reference donates the pool to a
jitted update.  Activation checkpoints stay on the device as tensors.

Not in this slice: the host tier (`tiering.py`, ROADMAP Queue A item
4), inter-shard page migration (item 5), and locality loss and the
prefill->decode handoff snapshots (item 6).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.agas import AGAS, AGASError, GlobalAddress
from repro_torch.core.localities import LocalityDomain
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import PAGED_FAMILIES, init_paged_cache
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.radix import RadixPrefixIndex


class PageExhausted(RuntimeError):
    """No free page in the pool; callers preempt or defer."""


def _chain_new(pad: int = 0) -> Any:
    """A fresh page-key chain for a layout with `pad` leading padding
    rows.  The pad count seeds the chain — RoPE positions differ
    across layouts, so a padded layout's pages must never alias a
    pad-free one's even when the real tokens agree."""
    h = hashlib.blake2b(digest_size=16)
    h.update(int(pad).to_bytes(4, "little", signed=True))
    return h


def _chain_extend(chain: Any, tokens: np.ndarray, start: int,
                  end: int, page_size: int, pad: int = 0
                  ) -> List[Tuple[bytes, int]]:
    """Extend a page-key chain over layout rows [start, end) (`start`
    page-aligned), returning one (digest, fill) key per page.

    Each page hashes its start row (so keys stay distinct even for
    pages holding zero real tokens) followed by its REAL tokens —
    `tokens` is the full layout and rows below `pad` are padding,
    excluded from the digest.  Byte-for-byte the continuation of
    `page_keys` over the same layout: update() chunking never changes
    a blake2b digest, and the per-page update sequence here is
    identical.
    """
    keys: List[Tuple[bytes, int]] = []
    # one serialization of the layout, byte-sliced per page: this runs
    # on every admission attempt, so it must stay microseconds
    buf = np.ascontiguousarray(tokens, np.int32).tobytes()
    for pstart in range(start, end, page_size):
        pend = min(pstart + page_size, end)
        chain.update(int(pstart).to_bytes(4, "little", signed=True))
        chain.update(buf[4 * max(pstart, pad):4 * pend])
        keys.append((chain.digest(), pend - pstart))
    return keys


def _chain_seed(tokens: np.ndarray, start: int, page_size: int,
                pad: int = 0) -> Any:
    """A chain with rows [0, start) already consumed — what a slot's
    running chain would hold after attaching that prefix."""
    chain = _chain_new(pad)
    if start:
        _chain_extend(chain, tokens, 0, start, page_size, pad)
    return chain


def page_keys(tokens: np.ndarray, page_size: int, pad: int = 0
              ) -> List[Tuple[bytes, int]]:
    """Position-normalized chained prefix hashes, one per layout page.

    Key i commits to the layout's pad count plus every REAL token
    through page i (and the page's row count as its fill), so two
    layouts share page i iff they agree on the pad count and on every
    real token up to and including it.  `tokens` is the full layout;
    `pad` declares how many of its leading rows are padding (excluded
    from the digests — their values are irrelevant, only their count
    names the position shift).  Pad-free layouts (``pad=0``, the paged
    engines') therefore share prefix pages across prompts of
    *different total lengths* — the mixed-length traffic DESIGN.md
    §4e's compute skip exists for.
    """
    return _chain_extend(_chain_new(pad), tokens, 0, len(tokens),
                         page_size, pad)


class PagePool:
    """Refcounted AGAS page allocator + the device page arrays.

    ``n_shards > 1`` shards the pool across simulated AGAS localities
    (DESIGN.md §4c): allocation is least-loaded-shard-first and every
    physical row is named ``locality * rows_per_shard + slot``.
    """

    def __init__(self, cfg: ArchConfig, n_pages: int, page_size: int, *,
                 n_shards: int = 1, device: DeviceLike = None,
                 tracer=None, pin_threshold: int = 4):
        if cfg.family not in PAGED_FAMILIES:
            raise ValueError(
                f"paged KV cache supports {PAGED_FAMILIES}, "
                f"not {cfg.family!r}")
        if n_shards < 1 or n_pages % n_shards:
            raise ValueError(
                f"n_pages {n_pages} must be a positive multiple of "
                f"n_shards {n_shards}")
        self.cfg = cfg
        self.capacity = int(n_pages)
        self.page_size = int(page_size)
        self.n_shards = int(n_shards)
        self.sharded = self.n_shards > 1
        self.pages_per_shard = self.capacity // self.n_shards
        # every shard carries its own null page, so a shard's rows are
        # pages_per_shard + 1 and the flat encoding below never
        # collides between shards
        self.rows_per_shard = self.pages_per_shard + 1
        # shard 0's local null row; any shard's null works as a write
        # sink (no mask ever reads one) and 0 * rows_per_shard +
        # pages_per_shard keeps the single-shard value n_pages
        self.null_row = self.pages_per_shard
        self.device = resolve_device(device)
        # One AGAS locality per KV shard; per-locality capacity is the
        # shard's page count (the directory's free lists ARE the
        # least-loaded allocation signal).
        self.agas = AGAS(LocalityDomain.simulated(self.n_shards),
                         self.pages_per_shard, space="kvpage")
        self._refs: Dict[int, int] = {}            # gid -> refcount
        # the prefix index: a radix tree over page-key chains
        # (serving/radix.py) — longest-prefix covers walk it, point
        # lookups go through its O(1) digest directory, and its hit
        # statistics pin hot prefixes
        self.prefix = RadixPrefixIndex(
            pin_threshold=pin_threshold,
            pin_capacity=max(1, n_pages // 4))
        # gid -> last-position activation checkpoint ((D,) tensor on
        # the pool's device): lives and dies with the page's
        # prefix-index membership (§4e)
        self._hidden: Dict[int, torch.Tensor] = {}
        self.pages: Dict[str, torch.Tensor] = init_paged_cache(
            cfg, self.rows_per_shard, self.page_size,
            n_shards=self.n_shards, device=self.device)
        # performance counters (Fig 9 spirit: runtime overhead visible)
        self.allocs = 0
        self.shares = 0
        self.cow_copies = 0
        self.trace = tracer if tracer is not None else NULL_TRACER

    # -- allocation / refcounting -------------------------------------
    @property
    def free_pages(self) -> int:
        # global count: least-loaded-first allocation keeps every shard
        # reachable, so n free pages really do admit n allocations
        return sum(self.agas.free_count(l)
                   for l in self.active_shards())

    @property
    def used_pages(self) -> int:
        return len(self._refs)

    def occupancy(self) -> float:
        return self.used_pages / max(self.capacity, 1)

    def active_shards(self) -> List[int]:
        """Device shards currently accepting placement."""
        return [l for l in range(self.n_shards)
                if self.agas.is_active(l)]

    def metrics(self) -> Dict[str, Any]:
        """Counters under the unified ``subsystem.metric`` namespace
        (the engine mirrors these into its MetricsRegistry)."""
        return {
            "pool.capacity": self.capacity,
            "pool.page_size": self.page_size,
            "pool.kv_shards": self.n_shards,
            "pool.used_pages": self.used_pages,
            "pool.free_pages": self.free_pages,
            "pool.occupancy": self.occupancy(),
            "pool.allocs": self.allocs,
            "pool.shares": self.shares,
            "pool.cow_copies": self.cow_copies,
            **self.prefix.metrics(),
        }

    def alloc(self, locality: Optional[int] = None) -> GlobalAddress:
        """Allocate a page, least-loaded shard first.  Prefix-shared
        pages are pinned to their owner by construction — sharing
        increfs an existing page wherever it lives; only FRESH pages
        go through placement.  An explicit `locality` pins the page."""
        if locality is None:
            locality = self.agas.least_loaded(tier=0)
        try:
            addr = self.agas.allocate(locality)
        except AGASError:
            raise PageExhausted(
                f"page pool exhausted ({self.capacity} pages over "
                f"{self.n_shards} shard(s))") from None
        self._refs[addr.gid] = 1
        self.allocs += 1
        self.trace.instant("kvcache", "page_alloc", lane=locality,
                           gid=addr.gid)
        return addr

    def incref(self, addr: GlobalAddress) -> None:
        self._refs[addr.gid] += 1

    def _purge_index(self, gid: int) -> None:
        """Remove a departing page's prefix-index node AND its stored
        activation checkpoint in one step, so `covered_prefix` can
        never observe a key whose page is freed but whose checkpoint —
        or index entry — lingers."""
        self._hidden.pop(gid, None)
        self.prefix.remove_gid(gid)

    def decref(self, addr: GlobalAddress) -> None:
        self._refs[addr.gid] -= 1
        if self._refs[addr.gid] == 0:
            del self._refs[addr.gid]
            self._purge_index(addr.gid)
            self.agas.free(addr)
            self.trace.instant("kvcache", "page_free", gid=addr.gid)

    def refcount(self, addr: GlobalAddress) -> int:
        return self._refs[addr.gid]

    def discard(self, addr: GlobalAddress) -> None:
        """Rollback decref for pages whose content was never written
        (attach/begin_chunk exception paths).  Identical to `decref`
        in a single-tier pool."""
        self.decref(addr)

    def ensure_device(self, addr: GlobalAddress) -> None:
        """Guarantee a page is resident in fast memory before its row
        is resolved.  Single-tier pools have nowhere else a page could
        be."""

    def page_cost(self, key: Tuple[bytes, int]) -> int:
        """Fast-tier rows acquiring this prefix key will consume: 0 on
        a hit, 1 on a miss."""
        return 0 if self.lookup_prefix(key) is not None else 1

    def row(self, addr: GlobalAddress) -> int:
        """Physical row of a page: ``locality * rows_per_shard + slot``
        (reduces to the plain AGAS slot when n_shards == 1)."""
        loc, slot = self.agas.lookup(addr)
        return loc * self.rows_per_shard + slot

    def _split_rows(self, rows) -> Tuple[torch.Tensor, torch.Tensor]:
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return r // self.rows_per_shard, r % self.rows_per_shard

    # -- prefix sharing ------------------------------------------------
    def lookup_prefix(self, key: Tuple[bytes, int]
                      ) -> Optional[GlobalAddress]:
        return self.prefix.lookup(key)

    def register_prefix(self, key: Tuple[bytes, int],
                        addr: GlobalAddress,
                        parent: Optional[bytes] = None) -> None:
        # one key per page: a second registration (either direction)
        # is a no-op, so freeing a page can never leave a stale key
        # behind in the prefix index.  `parent` is the chain's
        # previous digest (None for a chain's first page).
        self.prefix.insert(key, addr, parent)

    # -- activation checkpoints (compute skip, DESIGN.md §4e) ---------
    def store_hidden(self, addr: GlobalAddress,
                     hidden: torch.Tensor) -> None:
        """Attach the post-norm hidden state of a page's last position
        to a prefix-indexed page.  First write wins; pages outside the
        prefix index carry no checkpoint."""
        gid = addr.gid
        if self.prefix.owns_gid(gid) and gid not in self._hidden:
            self._hidden[gid] = hidden

    def hidden_for(self, key: Tuple[bytes, int]
                   ) -> Optional[torch.Tensor]:
        """The activation checkpoint cached under a prefix key, or
        None."""
        addr = self.prefix.lookup(key)
        if addr is None:
            return None
        return self._hidden.get(addr.gid)

    # -- device-side page content -------------------------------------
    def write_pages(self, rows: List[int], k_spans: torch.Tensor,
                    v_spans: torch.Tensor) -> None:
        """One batched in-place scatter of whole pages: spans are
        (L, len(rows), page_size, KV, D)."""
        kd = k_spans.to(self.pages["k"].dtype)
        vd = v_spans.to(self.pages["v"].dtype)
        if self.sharded:
            loc, slot = self._split_rows(rows)
            self.pages["k"][:, loc, slot] = kd
            self.pages["v"][:, loc, slot] = vd
        else:
            idx = torch.as_tensor(np.asarray(rows, np.int64),
                                  device=self.device)
            self.pages["k"].index_copy_(1, idx, kd)
            self.pages["v"].index_copy_(1, idx, vd)

    def copy_page(self, src_row: int, dst_row: int) -> None:
        """COW: clone a page's contents under a fresh global name."""
        if self.sharded:
            sl, ss = divmod(src_row, self.rows_per_shard)
            dl, ds = divmod(dst_row, self.rows_per_shard)
            for arr in (self.pages["k"], self.pages["v"]):
                arr[:, dl, ds] = arr[:, sl, ss]
        else:
            for arr in (self.pages["k"], self.pages["v"]):
                arr[:, dst_row] = arr[:, src_row]
        self.cow_copies += 1
        self.trace.instant("kvcache", "cow_copy", src_row=src_row,
                           dst_row=dst_row)

    def note_page_write(self, addr: GlobalAddress) -> None:
        """Hook: `addr` is about to receive an in-place decode write.
        Single-tier pools retain no host copies — no-op."""


@dataclasses.dataclass
class _SlotState:
    addrs: List[GlobalAddress]
    length: int                      # tokens stored = abs position clock
    # running blake2b prefix chain for chunked prefill: hashes exactly
    # the tokens already resident, so each chunk hashes only its own
    # tokens instead of re-walking the prefix (None = not chunking)
    chain: Optional[Any] = None


@dataclasses.dataclass
class PrefixCover:
    """The longest cached prefix run of a prompt layout (DESIGN.md
    §4e): `keys` are the covered pages' chain keys (each currently a
    live radix root-path hit), `covered` the layout rows they hold.  `full` means
    every page of the prompt hit AND the final page carries an
    activation checkpoint (`hidden`, the post-norm last-position
    hidden state) — the prompt can admit straight to decode with zero
    prefill compute.  Partial covers are page-aligned by construction
    (a partially-filled page key can only ever be a prompt's final
    page, so matching one implies a full cover), which is exactly
    what lets chunked prefill resume at `covered`."""

    covered: int
    keys: List[Tuple[bytes, int]]
    full: bool
    hidden: Optional[torch.Tensor] = None



class PagedKVCache:
    """Per-slot block tables over a shared PagePool.

    Every decode slot carries its own position counter (`lengths`) —
    the per-slot clock that replaces the dense cache's shared
    ``len/cursor/abs`` triple — and a block table row mapping its token
    positions onto physical page rows.  The tables and clocks are host
    numpy arrays; `batch_inputs` ships them to the device each step.
    """

    def __init__(self, cfg: ArchConfig, slots: int, max_len: int,
                 n_pages: int, page_size: int, *,
                 n_shards: int = 1, device: DeviceLike = None,
                 tracer=None, pin_threshold: int = 4):
        self.pool = PagePool(cfg, n_pages, page_size,
                             n_shards=n_shards, device=device,
                             tracer=tracer, pin_threshold=pin_threshold)
        self.trace = self.pool.trace
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.max_pages_slot = -(-self.max_len // page_size)
        null = self.pool.null_row
        self.tables = np.full((slots, self.max_pages_slot), null,
                              np.int32)
        self.lengths = np.zeros(slots, np.int32)
        self.write_rows = np.full(slots, null, np.int32)
        self.write_offs = np.zeros(slots, np.int32)
        self._state: List[_SlotState] = [
            _SlotState([], 0) for _ in range(slots)]

    # -- admission-time accounting ------------------------------------
    def pages_needed(self, tokens: np.ndarray, pad: int = 0) -> int:
        """Fresh pages a prefill would allocate (prefix hits excluded)."""
        ps = self.pool.page_size
        return sum(self.pool.page_cost(key)
                   for key in page_keys(tokens, ps, pad))

    def pages_needed_chunk(self, tokens: np.ndarray,
                           start: int, end: int, pad: int = 0) -> int:
        """Fresh pages one chunk [start, end) would allocate.

        The chain keys are computed over the full prefix up to `end`,
        so a chunk boundary never changes a page's identity: chunked
        and whole-prompt prefills of the same layout hash to the same
        pages (prefix sharing works across the two paths).
        """
        ps = self.pool.page_size
        keys = page_keys(tokens[:end], ps, pad)[start // ps:]
        return sum(self.pool.page_cost(key) for key in keys)

    # -- prefill attach ------------------------------------------------
    def attach(self, slot: int, tokens: np.ndarray,
               k, v, pad: int = 0) -> int:
        if not self.trace.enabled:
            return self._attach(slot, tokens, k, v, pad)
        with self.trace.span("kvcache", "attach", kind="pages",
                             slot=slot) as sp:
            covered = self._attach(slot, tokens, k, v, pad)
            sp.args["gids"] = [a.gid for a in self._state[slot].addrs]
            sp.args["covered"] = covered
            return covered

    def _attach(self, slot: int, tokens: np.ndarray,
                k, v, pad: int = 0) -> int:
        """Install a prefilled prompt layout into `slot`.

        k/v: (L, S, KV, D) tensors, the KV of the full layout (the
        engines attach pad-free layouts, so S is the real prompt
        length).  Shared
        pages (prefix-hash hits) are reused by refcount instead of
        rewritten.  Returns the covered-token count of the longest
        cached prefix run (leading pages served by hits) — the memory
        the prefix cache saved, and the span compute skip could have
        skipped (DESIGN.md §4e).
        """
        ps = self.pool.page_size
        s = len(tokens)
        if s > self.max_len:
            raise ValueError(f"prompt {s} exceeds max_len {self.max_len}")
        st = self._state[slot]
        assert not st.addrs, f"slot {slot} already attached"
        keys = page_keys(tokens, ps, pad)
        acquired: List[GlobalAddress] = []
        fresh: List[int] = []               # page indices to write
        fresh_gids: set = set()
        covered = 0
        leading = True
        try:
            for i, key in enumerate(keys):
                shared = self.pool.lookup_prefix(key)
                if shared is not None:
                    # incref first (pin, and into `acquired` so a
                    # failed promotion rolls it back), THEN promote: a
                    # spilled page being promoted must not be
                    # eviction's candidate
                    self.pool.incref(shared)
                    acquired.append(shared)
                    self.pool.ensure_device(shared)
                    self.pool.shares += 1
                    if leading:
                        covered += key[1]
                else:
                    leading = False
                    addr = self.pool.alloc()
                    self.pool.register_prefix(
                        key, addr,
                        parent=keys[i - 1][0] if i else None)
                    acquired.append(addr)
                    fresh.append(i)
                    fresh_gids.add(addr.gid)
        except PageExhausted:
            # rollback: only THIS call's fresh (never-written) pages
            # must bypass retention; shared hits hold valid content
            # and go back to the cache via plain decref
            for a in acquired:
                if a.gid in fresh_gids:
                    self.pool.discard(a)
                else:
                    self.pool.decref(a)
            raise
        if fresh:
            # one batched whole-page scatter (zero-padded tail on the
            # partial page — never read: masks stop at the clock)
            tail = len(keys) * ps - s
            kp = F.pad(k, (0, 0, 0, 0, 0, tail)) \
                .reshape(k.shape[0], len(keys), ps, *k.shape[2:])
            vp = F.pad(v, (0, 0, 0, 0, 0, tail)) \
                .reshape(v.shape[0], len(keys), ps, *v.shape[2:])
            fi = torch.as_tensor(fresh, device=kp.device)
            self.pool.write_pages(
                [self.pool.row(acquired[i]) for i in fresh],
                kp[:, fi], vp[:, fi])
        st.addrs = acquired
        st.length = s
        self.lengths[slot] = s
        for i, a in enumerate(acquired):
            self.tables[slot, i] = self.pool.row(a)
        return covered

    # -- prefix-cache compute skip (DESIGN.md §4e) --------------------
    def covered_prefix(self, tokens: np.ndarray,
                       pad: int = 0) -> PrefixCover:
        """The longest cached prefix run of a prompt layout.

        One radix-tree walk (`RadixPrefixIndex.match`, O(prompt
        pages)): the longest leading run of the chained page keys
        forming a live root path — the walk also stamps the hit
        statistics that drive hot-prefix pinning.  A full-cover result
        additionally requires the final page's activation checkpoint;
        when the KV is all cached but the checkpoint is missing (the
        pages were attached by a path that never computed hidden
        states), the final page is dropped from the cover so a resumed
        chunk recomputes it — the cover is then page-aligned and
        strictly inside the prompt, exactly what `begin_chunk` needs
        to resume.
        """
        keys = page_keys(tokens, self.pool.page_size, pad)
        nodes = self.pool.prefix.match(keys)
        ck: List[Tuple[bytes, int]] = [n.key for n in nodes]
        covered = sum(k[1] for k in ck)
        if covered == len(tokens) and ck:
            hidden = self.pool.hidden_for(ck[-1])
            if hidden is not None:
                return PrefixCover(covered, ck, True, hidden)
            last = ck.pop()
            covered -= last[1]
        return PrefixCover(covered, ck, False)

    def attach_covered(self, slot: int, tokens: np.ndarray,
                       keys: List[Tuple[bytes, int]]) -> None:
        if not self.trace.enabled:
            return self._attach_covered(slot, tokens, keys)
        with self.trace.span("kvcache", "attach_covered", kind="pages",
                             slot=slot) as sp:
            self._attach_covered(slot, tokens, keys)
            sp.args["gids"] = [a.gid for a in self._state[slot].addrs]
            sp.args["covered"] = sum(k[1] for k in keys)

    def _attach_covered(self, slot: int, tokens: np.ndarray,
                        keys: List[Tuple[bytes, int]]) -> None:
        """Install a covered prefix's cached pages into `slot` with
        ZERO prefill compute and zero KV writes: every key must
        currently hit the prefix index (the caller just computed the
        cover).  The slot is left exactly as a prefill of the covered
        span would have left it — block table and position clock — so
        `begin_chunk` resumes at the cover's end, or decode starts
        immediately on a full cover.  Atomic under PageExhausted
        (promoting a spilled page may need a device row, and a
        promotion-triggered cold drop can even evict a not-yet-pinned
        covered page): on failure every acquired page returns to the
        cache and the caller retries later.
        """
        st = self._state[slot]
        assert not st.addrs, f"slot {slot} already attached"
        pool = self.pool
        acquired: List[GlobalAddress] = []
        try:
            for key in keys:
                shared = pool.lookup_prefix(key)
                if shared is None:
                    raise PageExhausted(
                        "covered prefix page vanished before attach "
                        "(cold drop under promotion pressure)")
                pool.incref(shared)             # pin, then promote
                acquired.append(shared)
                pool.ensure_device(shared)
                pool.shares += 1
        except PageExhausted:
            for a in acquired:
                pool.decref(a)
            raise
        covered = sum(k[1] for k in keys)
        st.addrs = acquired
        st.length = covered
        self.lengths[slot] = covered
        for i, a in enumerate(acquired):
            self.tables[slot, i] = pool.row(a)

    def store_hidden_chunk(self, slot: int, start: int, end: int,
                           boundary: torch.Tensor,
                           last: torch.Tensor) -> None:
        """Checkpoint the page-boundary activations of chunk
        [start, end): ``boundary[j]`` is the post-norm hidden at
        chunk-local position ``(j + 1) * ps - 1``, ``last`` the hidden
        at ``end - 1`` (the partial final page of a prompt's last
        chunk).  First write wins (`PagePool.store_hidden`)."""
        ps = self.pool.page_size
        st = self._state[slot]
        base = start // ps
        for j in range(-(-(end - start) // ps)):
            addr = st.addrs[base + j]
            if start + (j + 1) * ps <= end:
                self.pool.store_hidden(addr, boundary[j])
            else:
                self.pool.store_hidden(addr, last)

    def store_hidden_prefill(self, slot: int, real: int,
                             boundary: torch.Tensor,
                             last: torch.Tensor) -> None:
        """Checkpoint a whole-prompt prefill's page-boundary
        activations — exactly the chunk case starting at 0 (attach
        created one addr per page of ``real``)."""
        self.store_hidden_chunk(slot, 0, real, boundary, last)

    # -- chunked prefill (DESIGN.md §4b) ------------------------------
    def begin_chunk(self, slot: int, tokens: np.ndarray,
                    start: int, end: int, pad: int = 0,
                    locality: Optional[int] = None
                    ) -> Tuple[List[int], int]:
        if not self.trace.enabled:
            return self._begin_chunk(slot, tokens, start, end, pad,
                                     locality)
        with self.trace.span("kvcache", "chunk_attach", kind="pages",
                             slot=slot, start=start, end=end) as sp:
            rows, covered = self._begin_chunk(slot, tokens,
                                              start, end, pad,
                                              locality)
            ps = self.pool.page_size
            base = start // ps
            sp.args["gids"] = [a.gid for a in
                               self._state[slot].addrs[base:]]
            return rows, covered

    def _begin_chunk(self, slot: int, tokens: np.ndarray,
                     start: int, end: int, pad: int = 0,
                     locality: Optional[int] = None
                     ) -> Tuple[List[int], int]:
        """Acquire the pages covering chunk [start, end) of a chunked
        prefill and install them in `slot`'s block table.

        `start` must be page-aligned and equal the slot's resident
        length (chunks arrive in order); `end` is page-aligned except
        on the prompt's final chunk, which may leave the last page
        partially filled — the slot holds that partial page between
        the chunk and its first decode write.  Prefix-shared pages are
        reused by refcount.  Returns ``(rows, covered)``: one physical
        write row per page of the chunk, with the pool's null row
        substituted for shared pages so the compiled scatter cannot
        clobber shared content, and the covered-token count of the
        chunk's leading run of prefix hits (DESIGN.md §4e telemetry).
        Atomic under PageExhausted: either every page of the chunk is
        acquired or none (the caller preempts a victim and retries).
        """
        ps = self.pool.page_size
        st = self._state[slot]
        if start % ps:
            raise ValueError(f"chunk start {start} not page-aligned")
        if start != st.length:
            raise ValueError(
                f"slot {slot}: chunk starts at {start} but {st.length} "
                f"tokens are resident")
        if end > self.max_len:
            raise ValueError(f"chunk end {end} exceeds {self.max_len}")
        # extend the slot's running prefix chain (committed only on
        # success, so a PageExhausted retry re-hashes just this chunk);
        # digests match page_keys over the whole layout exactly —
        # `_chain_extend` replays the identical per-page updates
        if st.chain is not None:
            chain = st.chain.copy()
        else:                        # resident tokens came via attach()
            chain = _chain_seed(tokens, start, ps, pad)
        # the radix parent of this chunk's first page: the digest of
        # the slot's resident prefix (root when the chunk starts the
        # prompt — the chain then holds only the pad-count seed, which
        # no node owns)
        prev = chain.digest() if start else None
        keys = _chain_extend(chain, tokens, start, end, ps, pad)
        acquired: List[GlobalAddress] = []
        rows: List[int] = []
        fresh_gids: set = set()
        covered = 0
        leading = True
        try:
            for key in keys:
                shared = self.pool.lookup_prefix(key)
                if shared is not None:
                    self.pool.incref(shared)        # pin, then promote
                    acquired.append(shared)
                    self.pool.ensure_device(shared)
                    self.pool.shares += 1
                    rows.append(self.pool.null_row)
                    if leading:
                        covered += key[1]
                else:
                    leading = False
                    # placement preference (§4f): a dispatched chunk
                    # allocates at its prefill worker's locality, so
                    # the prefix pages it registers make that worker
                    # the owner the NEXT matching prompt dispatches
                    # to.  Soft: an exhausted preferred shard falls
                    # back to the default least-loaded policy rather
                    # than preempting while other shards have room.
                    # a retired hint (§4g) falls back too: allocating
                    # on a dead shard would raise, and the resulting
                    # PageExhausted would read as pool pressure
                    loc = locality
                    if loc is not None and (
                            not self.pool.agas.is_active(loc)
                            or self.pool.agas.free_count(loc) == 0):
                        loc = None
                    addr = self.pool.alloc(loc)
                    self.pool.register_prefix(key, addr, parent=prev)
                    acquired.append(addr)
                    fresh_gids.add(addr.gid)
                    rows.append(self.pool.row(addr))
                prev = key[0]
        except PageExhausted:
            # fresh (unwritten) pages bypass retention; shared hits
            # return to the prefix cache with their content intact
            for a in acquired:
                if a.gid in fresh_gids:
                    self.pool.discard(a)
                else:
                    self.pool.decref(a)
            raise
        base = start // ps
        for i, a in enumerate(acquired):
            st.addrs.append(a)
            self.tables[slot, base + i] = self.pool.row(a)
        st.chain = chain
        st.length = end
        self.lengths[slot] = end
        return rows, covered

    # -- decode-step bookkeeping --------------------------------------
    def prepare_decode(self, slot: int) -> None:
        """Reserve the write target for this slot's next token.

        Allocates a fresh page at page boundaries; clones (COW) a
        shared page before the first divergent append.  Idempotent, so
        the engine can retry after preempting a victim on
        PageExhausted.
        """
        st = self._state[slot]
        ps = self.pool.page_size
        pos = st.length
        page_idx, off = divmod(pos, ps)
        if page_idx >= self.max_pages_slot:
            raise RuntimeError(
                f"slot {slot} overflows max_len {self.max_len}")
        if page_idx == len(st.addrs):
            addr = self.pool.alloc()
            st.addrs.append(addr)
        else:
            addr = st.addrs[page_idx]
            if self.pool.refcount(addr) > 1:
                fresh = self.pool.alloc()
                self.pool.copy_page(self.pool.row(addr),
                                    self.pool.row(fresh))
                self.pool.decref(addr)
                st.addrs[page_idx] = fresh
                addr = fresh
        # the write target mutates in place: any retained host-tier
        # copy of it is stale from here on (DESIGN.md §4g)
        self.pool.note_page_write(addr)
        row = self.pool.row(addr)
        self.tables[slot, page_idx] = row
        self.write_rows[slot] = row
        self.write_offs[slot] = off

    def needs_alloc(self, slot: int) -> bool:
        """Will this slot's next prepare_decode take a page from the
        pool?  True at page boundaries (fresh page) and on shared
        partial pages (COW clone) — the admission watermark."""
        st = self._state[slot]
        page_idx, _ = divmod(st.length, self.pool.page_size)
        if page_idx >= len(st.addrs):
            return True
        return self.pool.refcount(st.addrs[page_idx]) > 1

    def advance(self, slot: int) -> None:
        st = self._state[slot]
        st.length += 1
        self.lengths[slot] = st.length

    def release(self, slot: int) -> None:
        st = self._state[slot]
        if self.trace.enabled and st.addrs:
            self.trace.instant("kvcache", "release", slot=slot,
                               gids=[a.gid for a in st.addrs])
        for a in st.addrs:
            self.pool.decref(a)
        st.addrs = []
        st.length = 0
        st.chain = None
        null = self.pool.null_row
        self.tables[slot, :] = null
        self.lengths[slot] = 0
        self.write_rows[slot] = null
        self.write_offs[slot] = 0

    # -- the step's device view ---------------------------------------
    def batch_inputs(self) -> Dict[str, torch.Tensor]:
        """The decode step's block tables, clocks and write targets as
        int32 tensors on the pool's device."""
        dev = self.pool.device
        return {
            "block_tables": torch.as_tensor(self.tables, device=dev),
            "positions": torch.as_tensor(self.lengths, device=dev),
            "write_rows": torch.as_tensor(self.write_rows, device=dev),
            "write_offs": torch.as_tensor(self.write_offs, device=dev),
        }
