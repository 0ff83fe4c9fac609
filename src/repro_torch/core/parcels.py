"""Parcels: message-driven work transport, lowered to TPU collectives.

Paper, Sec. II: "Parcels are the remote semantic equivalent to creating
a local HPX-thread. ... Parcels are either used to move the work to the
data ... or to gather small pieces of data back to the caller."

A `Parcel` here is a *descriptor*: (destination object, action id,
continuation, payload refs).  The host dataflow engine executes parcels
directly (action-manager semantics: local -> run, remote -> enqueue at
destination locality).  The compiled engine *lowers batches of parcels*
into jax collectives:

* same-pattern point-to-point parcels (halo exchange) -> `lax.ppermute`
* all-pairs redistribution (MoE dispatch, AGAS migration) -> `all_to_all`
  or gather/scatter permutations
* reductions back to a caller -> `psum` / `psum_scatter`

`lower_halo_parcels` and `migration_plan` are the two lowering entry
points used by amr/compiled.py and ft/straggler.py.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.agas import AGAS, GlobalAddress
from repro_torch.obs import trace as _trace


@dataclasses.dataclass(frozen=True)
class Parcel:
    """An active message.

    Attributes:
      target:  global address of the object the action is applied to.
      action:  action id (a registered callable name or opaque tag).
      args:    payload (small data moved with the parcel).
      continuation: optional global address of an LCO to set with the
        action's result ("gather small pieces of data back").
    """

    target: GlobalAddress
    action: str
    args: tuple = ()
    continuation: Optional[GlobalAddress] = None


class ActionRegistry:
    """Named remotable actions (the paper's component actions)."""

    def __init__(self):
        self._actions: Dict[str, Callable] = {}

    def register(self, name: str) -> Callable[[Callable], Callable]:
        def deco(fn: Callable) -> Callable:
            if name in self._actions:
                raise ValueError(f"action {name!r} already registered")
            self._actions[name] = fn
            return fn
        return deco

    def __getitem__(self, name: str) -> Callable:
        return self._actions[name]

    def __contains__(self, name: str) -> bool:
        return name in self._actions


class ParcelPort:
    """Host-engine parcel port: per-locality inbound queues (paper Fig 1).

    The action manager (`drain`) decodes parcels and runs the action
    where the target lives — exactly the local/remote decision path of
    the HPX architecture walkthrough.
    """

    def __init__(self, agas: AGAS, registry: ActionRegistry):
        self.agas = agas
        self.registry = registry
        self.queues: List[List[Parcel]] = [[] for _ in range(len(agas.domain))]
        self.sent = 0          # performance counters
        self.local_applied = 0

    def apply(self, parcel: Parcel, from_locality: int, state: Any) -> None:
        """Action-manager entry: run locally or send a parcel."""
        if self.agas.is_local(parcel.target, from_locality):
            self.local_applied += 1
            _trace.GLOBAL.instant("parcels", "local_apply",
                                  action=parcel.action)
            self._run(parcel, state)
        else:
            self.sent += 1
            _trace.GLOBAL.instant("parcels", "send", action=parcel.action,
                                  dst=self.agas.locality_of(parcel.target))
            self.queues[self.agas.locality_of(parcel.target)].append(parcel)

    def post(self, parcel: Parcel, dst: int, from_locality: int,
             state: Any) -> None:
        """Action-manager entry with an EXPLICIT destination locality.

        `apply` routes by looking the target up in the directory; that
        requires the target object to exist.  Some parcels move work
        to a locality where their object does not exist YET — the
        first chunk of a cold prompt allocates its pages at the
        destination (its `target` may be None) — so the dispatcher
        resolves the destination itself (prefix-owner or
        least-loaded) and posts here."""
        if dst == from_locality:
            self.local_applied += 1
            _trace.GLOBAL.instant("parcels", "local_apply",
                                  action=parcel.action)
            self._run(parcel, state)
        else:
            self.sent += 1
            _trace.GLOBAL.instant("parcels", "send",
                                  action=parcel.action, dst=dst)
            self.queues[dst].append(parcel)

    def drain(self, locality: int, state: Any) -> int:
        """Process the inbound queue of one locality; returns #parcels."""
        q, self.queues[locality] = self.queues[locality], []
        if not q:
            return 0
        with _trace.GLOBAL.span("parcels", "drain", kind="parcel",
                                lane=locality, n=len(q)):
            for p in q:
                self._run(p, state)
        return len(q)

    def _run(self, parcel: Parcel, state: Any) -> None:
        fn = self.registry[parcel.action]
        result = fn(state, parcel.target, *parcel.args)
        if parcel.continuation is not None:
            state.lcos[parcel.continuation.gid].set(result)


# ---------------------------------------------------------------------------
# Compiled lowerings
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloLowering:
    """A batch of same-shaped p2p parcels lowered to ppermute legs.

    Each leg is one `lax.ppermute` call: `perm[i]` is the list of
    (src_locality, dst_locality) pairs, and `slot_src[i]` / `slot_dst[i]`
    give, per destination locality, which local pool slot the payload is
    read from / written to.  Legs partition the parcels so that within a
    leg every locality sends to at most one peer (ppermute's contract).
    """

    perms: tuple            # tuple of tuple[(src, dst), ...]
    gather_slots: tuple     # per leg: np.ndarray [n_localities] src slot
    scatter_slots: tuple    # per leg: np.ndarray [n_localities] dst slot
    n_parcels: int


def lower_halo_parcels(
    edges: Sequence[Tuple[GlobalAddress, GlobalAddress]],
    agas: AGAS,
) -> HaloLowering:
    """Lower (src_block -> dst_block) payload parcels to ppermute legs.

    Greedy edge-colouring: repeatedly take a maximal set of edges whose
    (src locality, dst locality) are each used at most once; every colour
    class becomes one ppermute leg.  Local edges (src and dst on the same
    locality) are returned in leg form too (ppermute with i->i pairs),
    because on-device they compile to a copy, keeping the lowering
    uniform.
    """
    n_loc = len(agas.domain)
    remaining = [
        (agas.lookup(s), agas.lookup(d)) for s, d in edges
    ]  # [((sloc, sslot), (dloc, dslot))]
    perms, gathers, scatters = [], [], []
    while remaining:
        used_src, used_dst = set(), set()
        leg, rest = [], []
        for (sloc, sslot), (dloc, dslot) in remaining:
            if sloc in used_src or dloc in used_dst:
                rest.append(((sloc, sslot), (dloc, dslot)))
            else:
                used_src.add(sloc)
                used_dst.add(dloc)
                leg.append(((sloc, sslot), (dloc, dslot)))
        remaining = rest
        perm = tuple((sloc, dloc) for (sloc, _), (dloc, _) in leg)
        gs = np.zeros(n_loc, np.int32)
        ss = np.zeros(n_loc, np.int32)
        for (sloc, sslot), (dloc, dslot) in leg:
            gs[sloc] = sslot
            ss[dloc] = dslot
        perms.append(perm)
        gathers.append(gs)
        scatters.append(ss)
    return HaloLowering(tuple(perms), tuple(gathers), tuple(scatters),
                        n_parcels=len(edges))


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """AGAS migration lowered to a permutation of the block pool.

    `src_locality/src_slot -> dst_locality/dst_slot` for each moved gid,
    grouped into ppermute legs like halo parcels.  Applied between
    compiled steps by ft/straggler.py.
    """

    moves: tuple  # ((gid, src_loc, src_slot, dst_loc, dst_slot), ...)
    lowering: HaloLowering


def migration_plan(agas: AGAS, moves: Dict[GlobalAddress, int]) -> MigrationPlan:
    """Plan (and commit to the directory) a set of migrations.

    Commits directory updates eagerly — the payload permutation encoded
    in `lowering` must then be applied to the data arrays to restore
    consistency (tested by tests/test_agas.py round-trips).
    """
    recs = []
    # Snapshot sources before committing, then migrate one by one.
    with _trace.GLOBAL.span("parcels", "migration_plan", kind="parcel",
                            moves=len(moves)) as sp:
        for addr, new_loc in sorted(moves.items(), key=lambda kv: kv[0].gid):
            src_loc, src_slot = agas.lookup(addr)
            if src_loc == new_loc:
                continue
            agas.migrate(addr, new_loc)
            dst_loc, dst_slot = agas.lookup(addr)
            recs.append((addr.gid, src_loc, src_slot, dst_loc, dst_slot))
        lowered = _lower_moves(recs, len(agas.domain))
        sp.args["gids"] = [r[0] for r in recs]
    return MigrationPlan(tuple(recs), lowered)


def _lower_moves(recs, n_loc) -> HaloLowering:
    remaining = [((r[1], r[2]), (r[3], r[4])) for r in recs]
    perms, gathers, scatters = [], [], []
    while remaining:
        used_src, used_dst = set(), set()
        leg, rest = [], []
        for e in remaining:
            (sloc, _), (dloc, _) = e
            if sloc in used_src or dloc in used_dst:
                rest.append(e)
            else:
                used_src.add(sloc)
                used_dst.add(dloc)
                leg.append(e)
        remaining = rest
        perm = tuple((s[0], d[0]) for s, d in leg)
        gs = np.zeros(n_loc, np.int32)
        ss = np.zeros(n_loc, np.int32)
        for (sloc, sslot), (dloc, dslot) in leg:
            gs[sloc] = sslot
            ss[dloc] = dslot
        perms.append(perm)
        gathers.append(gs)
        scatters.append(ss)
    return HaloLowering(tuple(perms), tuple(gathers), tuple(scatters),
                        n_parcels=len(recs))


@dataclasses.dataclass(frozen=True)
class PrefillParcel:
    """One prefill chunk as an active message (DESIGN.md §4f).

    The serving rendering of "move the work to the data": a chunk of
    prompt [start, start+take) for request `rid` in engine slot
    `slot`, dispatched to `locality` — the AGAS locality owning the
    prompt's radix-matched prefix pages (`anchor` is the deepest
    matched page, or the slot's last resident page for chunks after
    the first), or the least-loaded prefill worker when the prompt is
    cold (`anchor` None: there is no data yet; the chunk's pages are
    allocated at the destination, so the NEXT prompt sharing this
    prefix finds an owner)."""

    rid: int
    slot: int
    start: int
    take: int
    anchor: Optional[GlobalAddress]
    locality: int


@dataclasses.dataclass(frozen=True)
class PrefillLowering:
    """A step's prefill parcels grouped per destination locality,
    each batch padded to the canonical power-of-two size class — the
    same trick `plan_move_arrays` uses, so a compiled dispatch
    program exists per (locality, size class), never per step."""

    batches: tuple      # ((locality, (PrefillParcel, ...)), ...)
    sizes: tuple        # canonical (padded) batch size per destination
    n_parcels: int


def lower_prefill_parcels(parcels: Sequence[PrefillParcel]
                          ) -> PrefillLowering:
    """Group one step's prefill parcels by destination and pad each
    batch to `canonical_size` — the batched-dispatch lowering."""
    by_dst: Dict[int, List[PrefillParcel]] = defaultdict(list)
    for p in parcels:
        by_dst[p.locality].append(p)
    batches = tuple((loc, tuple(by_dst[loc]))
                    for loc in sorted(by_dst))
    sizes = tuple(canonical_size(len(b)) for _, b in batches)
    return PrefillLowering(batches, sizes, len(parcels))


def canonical_size(n: int) -> int:
    """Smallest power of two >= n (and >= 1).

    Permutation and transfer programs are compiled at canonical batch
    sizes: padding a move list up to the next power of two with
    identity moves onto a scratch slot means one compiled program per
    size class instead of one per exact count — the production-pool
    fix DESIGN.md §9.4 called for.
    """
    p = 1
    while p < n:
        p <<= 1
    return p


def plan_move_arrays(plan: MigrationPlan, pad_to: Optional[int] = None,
                     pad_move: Tuple[int, int] = (0, 0)
                     ) -> Tuple[np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """(src_loc, src_slot, dst_loc, dst_slot) int32 arrays of a plan.

    This is the single-device lowering of the plan's ppermute legs:
    applied as ONE gather-before-scatter permutation
    (``arr.at[:, dst_loc, dst_slot].set(arr[:, src_loc, src_slot])``),
    every payload is read from the pre-plan array before any
    destination is written, so the move order inside the legs cannot
    matter — exactly the semantics the legged ppermute execution has
    when each leg gathers from a snapshot of the source pool.

    `pad_to` pads the arrays to a canonical length with identity
    self-moves of `pad_move` = (locality, slot) — point it at a
    scratch slot (the page pool's null row) and the padded entries
    copy that slot onto itself, so one compiled permutation program
    serves every plan in the size class.
    """
    moves = np.array([m[1:] for m in plan.moves],
                     np.int32).reshape(-1, 4)
    if pad_to is not None and pad_to > len(moves):
        loc, slot = pad_move
        fill = np.tile(np.array([loc, slot, loc, slot], np.int32),
                       (pad_to - len(moves), 1))
        moves = np.concatenate([moves, fill], axis=0)
    return moves[:, 0], moves[:, 1], moves[:, 2], moves[:, 3]


def parcel_traffic_bytes(lowering: HaloLowering, payload_bytes: int) -> dict:
    """Traffic accounting for the roofline collective term."""
    inter = sum(
        1 for perm in lowering.perms for (s, d) in perm if s != d
    )
    intra = lowering.n_parcels - inter
    return {
        "parcels": lowering.n_parcels,
        "inter_locality": inter,
        "intra_locality": intra,
        "bytes_on_wire": inter * payload_bytes,
        "legs": len(lowering.perms),
    }
