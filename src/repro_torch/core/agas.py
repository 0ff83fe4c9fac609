"""AGAS: the Active Global Address Space.

The paper (Sec. II) motivates AGAS by dynamic AMR: "the requirements for
dynamic load-balancing ... define the necessity for a single global
address space"; unlike PGAS systems (UPC/X10/Chapel) the *active* part
means objects can move without their global name changing.

Here AGAS is a directory mapping immutable global ids (gids) to
(locality, slot) pairs, where a slot indexes a fixed-capacity local
object pool on each locality.  On device, the pools are the leading axis
of block-batched arrays, so an AGAS "lookup" compiles to a gather index
and a "migration" compiles to a permutation (gather/scatter or
ppermute) — nothing dynamic survives to run time, which is this
framework's analogue of the paper's Sec. V proposal to accelerate AGAS
lookups in hardware.

Localities need not be homogeneous: `pool_capacity` may be a
per-locality sequence, and each locality can carry an integer *tier*
tag (`core/percolation.py` uses 0 = device HBM, 1 = host DRAM).  An
object's global name is stable across a move between tiers exactly as
it is across a move between same-tier localities — percolation
(DESIGN.md §4d) is AGAS migration along the vertical memory axis.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.localities import LocalityDomain
from repro_torch.obs import trace as _trace


class AGASError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class GlobalAddress:
    """Immutable first-class name of an object (block, LCO, thread...)."""

    gid: int
    space: str = "default"

    def __index__(self) -> int:
        return self.gid


class AGAS:
    """Directory of global names -> (locality, slot) with migration.

    The directory also keeps per-locality free lists so allocation is
    O(1); `checkpoint_state`/`restore_state` make the directory itself a
    first-class checkpointable object (needed for elastic restart).
    """

    def __init__(self, domain: LocalityDomain, pool_capacity,
                 space: str = "default",
                 tiers: Optional[Sequence[int]] = None):
        self.domain = domain
        if isinstance(pool_capacity, (int, np.integer)):
            self.capacities = [int(pool_capacity)] * len(domain)
        else:
            if len(pool_capacity) != len(domain):
                raise ValueError(
                    f"{len(pool_capacity)} capacities for "
                    f"{len(domain)} localities")
            self.capacities = [int(c) for c in pool_capacity]
        # uniform-pool compat: `capacity` is THE per-locality capacity
        # when the pools are homogeneous, the largest otherwise
        self.capacity = max(self.capacities, default=0)
        if tiers is None:
            tiers = [0] * len(domain)
        if len(tiers) != len(domain):
            raise ValueError(
                f"{len(tiers)} tier tags for {len(domain)} localities")
        self.tiers = [int(t) for t in tiers]
        self.space = space
        self._gids = itertools.count()
        self._where: Dict[int, Tuple[int, int]] = {}
        self._free: List[List[int]] = [
            list(range(c)) for c in self.capacities
        ]
        self._residents: List[set] = [set() for _ in range(len(domain))]
        self._inactive: set = set()
        self.migrations = 0  # counter surfaced as a performance counter

    # -- tiers -------------------------------------------------------------
    def tier_of(self, locality: int) -> int:
        return self.tiers[locality]

    def localities_in_tier(self, tier: int) -> List[int]:
        return [l for l, t in enumerate(self.tiers) if t == tier]

    # -- locality lifecycle ------------------------------------------------
    def deactivate(self, locality: int) -> None:
        """Retire a locality from placement (failure or planned drain).

        Allocation, migration targets and `least_loaded` refuse it
        until `activate`.  Residents are NOT touched — the caller
        decides their fate (kill sweep, evacuation); `free` keeps
        working on a retired locality so a sweep can return slots,
        and a later `activate` finds the free list intact (elastic
        re-join without rebuilding the directory).
        """
        self._inactive.add(int(locality))

    def activate(self, locality: int) -> None:
        """Re-admit a retired locality to placement (elastic join)."""
        self._inactive.discard(int(locality))

    def is_active(self, locality: int) -> bool:
        return locality not in self._inactive

    # -- allocation --------------------------------------------------------
    def allocate(self, locality: int) -> GlobalAddress:
        if locality in self._inactive:
            raise AGASError(f"locality {locality} is retired")
        if not self._free[locality]:
            raise AGASError(
                f"locality {locality} pool exhausted "
                f"(capacity {self.capacities[locality]})"
            )
        slot = self._free[locality].pop()
        gid = next(self._gids)
        self._where[gid] = (locality, slot)
        self._residents[locality].add(gid)
        return GlobalAddress(gid, self.space)

    def allocate_many(self, locality: int, n: int) -> List[GlobalAddress]:
        return [self.allocate(locality) for _ in range(n)]

    def free(self, addr: GlobalAddress) -> None:
        loc, slot = self._where.pop(addr.gid)
        self._residents[loc].discard(addr.gid)
        self._free[loc].append(slot)

    # -- lookup --------------------------------------------------------------
    def lookup(self, addr: GlobalAddress) -> Tuple[int, int]:
        """gid -> (locality, slot).  Raises on dangling references."""
        try:
            return self._where[addr.gid]
        except KeyError:
            raise AGASError(f"dangling global address {addr.gid}") from None

    def locality_of(self, addr: GlobalAddress) -> int:
        return self.lookup(addr)[0]

    def slot_of(self, addr: GlobalAddress) -> int:
        return self.lookup(addr)[1]

    def is_local(self, addr: GlobalAddress, locality: int) -> bool:
        """The action-manager query: local action or parcel? (paper Fig 1)."""
        return self.locality_of(addr) == locality

    def residents(self, locality: int) -> set:
        return set(self._residents[locality])

    def resident_on(self, gid: int, locality: int) -> bool:
        """Is `gid` currently homed on `locality`?  False for freed
        (dangling) gids — a sweep-safe residency probe: a kill sweep's
        own evictions may move or drop pages it has not reached yet."""
        loc_slot = self._where.get(gid)
        return loc_slot is not None and loc_slot[0] == locality

    def free_count(self, locality: int) -> int:
        """Free pool slots on one locality (the allocator's load signal)."""
        return len(self._free[locality])

    def least_loaded(self, tier: Optional[int] = None) -> int:
        """Locality with the most free slots (ties -> lowest id).

        The locality-aware allocation policy: new objects land where
        capacity is, which keeps the per-locality pools balanced without
        a central planner (the HPX local-first/least-loaded placement
        the sharded KV page pool uses).  `tier` restricts the choice to
        one memory tier — a tiered pool allocates fresh objects in fast
        memory only; the slow tier is reached by explicit percolation.
        """
        cands = range(len(self.domain)) if tier is None \
            else self.localities_in_tier(tier)
        cands = [l for l in cands if l not in self._inactive]
        if not cands:
            raise AGASError(f"no active locality in tier {tier}")
        return max(cands, key=lambda l: (self.free_count(l), -l))

    # -- migration -----------------------------------------------------------
    def migrate(self, addr: GlobalAddress, new_locality: int) -> Tuple[int, int]:
        """Move an object; its global name is unchanged (the AGAS promise).

        Returns (old_locality, new_slot).  The caller is responsible for
        moving the payload (see core/parcels.migration_plan).
        """
        old_loc, old_slot = self.lookup(addr)
        if old_loc == new_locality:
            return old_loc, old_slot
        if new_locality in self._inactive:
            raise AGASError(
                f"migration target {new_locality} is retired")
        if not self._free[new_locality]:
            raise AGASError(f"migration target {new_locality} pool full")
        new_slot = self._free[new_locality].pop()
        self._free[old_loc].append(old_slot)
        self._residents[old_loc].discard(addr.gid)
        self._residents[new_locality].add(addr.gid)
        self._where[addr.gid] = (new_locality, new_slot)
        self.migrations += 1
        _trace.GLOBAL.instant("agas", "migrate", gid=addr.gid,
                              src=old_loc, dst=new_locality)
        return old_loc, new_slot

    # -- bulk views (compiled into gather indices) ----------------------------
    def placement_arrays(self, addrs: Sequence[GlobalAddress]
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(localities, slots) int32 arrays for a list of gids, in order."""
        locs = np.empty(len(addrs), np.int32)
        slots = np.empty(len(addrs), np.int32)
        for i, a in enumerate(addrs):
            locs[i], slots[i] = self.lookup(a)
        return locs, slots

    def load(self) -> np.ndarray:
        """Objects resident per locality (the load-balance signal)."""
        return np.array([len(r) for r in self._residents], np.int64)

    # -- checkpoint / elastic restore ----------------------------------------
    def checkpoint_state(self) -> dict:
        return {
            "capacity": self.capacity,
            "capacities": list(self.capacities),
            "tiers": list(self.tiers),
            "space": self.space,
            "n_localities": len(self.domain),
            "where": dict(self._where),
            "next_gid": next(self._gids),  # consumes one id; fine for ckpt
        }

    @staticmethod
    def restore_state(state: dict, domain: LocalityDomain,
                      remap: Optional[Dict[int, int]] = None) -> "AGAS":
        """Rebuild a directory, optionally remapping localities.

        `remap` supports elastic restore: a checkpoint taken on P
        localities can be restored onto P' by providing old->new ids
        (defaults to `old % P'`, the round-robin fold).  Restoring onto
        a different locality count keeps the UNIFORM capacity (tier
        tags do not survive a fold across counts).
        """
        caps = state.get("capacities")
        tiers = state.get("tiers")
        if caps is None or len(caps) != len(domain):
            caps = state["capacity"]
            tiers = None
        agas = AGAS(domain, caps, state["space"], tiers=tiers)
        n_new = len(domain)
        for gid, (loc, _slot) in sorted(state["where"].items()):
            new_loc = remap[loc] if remap else loc % n_new
            if not agas._free[new_loc]:
                raise AGASError(f"restore overflows locality {new_loc}")
            slot = agas._free[new_loc].pop()
            agas._where[gid] = (new_loc, slot)
            agas._residents[new_loc].add(gid)
        agas._gids = itertools.count(state["next_gid"])
        return agas


def balanced_placement(costs: Sequence[float], n_localities: int
                       ) -> List[int]:
    """LPT (longest-processing-time) static placement of objects.

    This is the *static* load balancer the compiled engine uses; the
    paper's emergent work-queue balancing is the dynamic complement
    (core/scheduler.py) and ft/straggler.py re-invokes this between
    compiled steps when measured load drifts.
    """
    order = sorted(range(len(costs)), key=lambda i: -costs[i])
    loads = np.zeros(n_localities)
    out = [0] * len(costs)
    for i in order:
        tgt = int(np.argmin(loads))
        out[i] = tgt
        loads[tgt] += costs[i]
    return out


def contiguous_placement(n_objects: int, n_localities: int) -> List[int]:
    """Block-contiguous placement (the MPI-style static decomposition)."""
    per = -(-n_objects // n_localities)
    return [min(i // per, n_localities - 1) for i in range(n_objects)]
