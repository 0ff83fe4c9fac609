"""Radix longest-prefix index over page-key chains (DESIGN.md §4e).

The prefix cache's index used to be a flat ``(digest, fill) ->
GlobalAddress`` dict: correct, but structure-blind — it cannot answer
"what is the longest cached prefix of this prompt" without probing
key by key, it has no notion of a prefix being *hot*, and a dropped
interior page silently strands its descendants.  This module replaces
it with the vLLM/SGLang-style radix tree over page chains:

* **Nodes are pages.**  One `RadixNode` per registered page key; the
  parent edge follows the hash chain (key i's parent is key i-1), so
  a root-to-node path IS a prompt prefix.  Because every key is a
  *chained* digest — key i commits to the pad count and every real
  token through page i — a digest uniquely identifies its whole path,
  and the index keeps a flat digest -> node directory next to the
  tree.  Point lookups (`lookup`, the allocation-cost probe) stay
  O(1); the longest-prefix walk (`match`) is O(prompt pages), never
  O(index size).

* **Lifecycle is tied to the page's.**  `remove_gid` runs when a page
  leaves the pool (freed on decref, or dropped cold under host-tier
  pressure): the node's address is cleared in place — a *tombstone* —
  and childless tombstones are trimmed up the path.  A tombstone
  keeps live descendants reachable through the directory (a chunk
  extension can still hit page i+1 after page i dropped) while the
  tree walk correctly refuses to cover across the hole.

* **Hit statistics drive pinning.**  `match` stamps every node it
  traverses; a node that accumulates `pin_threshold` hits is pinned
  (capacity-bounded).  Pins are advisory: the tiered pool's LRU
  eviction (serving/tiering.py) demotes/drops *unpinned* cold pages
  first and touches pinned ones only when nothing else is evictable —
  hot shared prefixes stay device-resident, cold one-off tails
  percolate out, and correctness never deadlocks on a pin.

Everything is exported through `metrics()` under the ``prefix.*``
namespace and mirrored into the engine's MetricsRegistry (§10).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.agas import GlobalAddress

Key = Tuple[bytes, int]


class RadixNode:
    """One registered page key: a node on some prompt's page chain."""

    __slots__ = ("key", "addr", "parent", "children", "hits",
                 "last_hit", "pinned")

    def __init__(self, key: Optional[Key],
                 addr: Optional[GlobalAddress],
                 parent: Optional["RadixNode"]):
        self.key = key                   # None only for the root
        self.addr = addr                 # None = tombstone (or root)
        self.parent = parent
        self.children: Dict[bytes, RadixNode] = {}
        self.hits = 0
        self.last_hit = -1
        self.pinned = False

    @property
    def digest(self) -> bytes:
        return self.key[0]

    def __repr__(self) -> str:          # debugging aid only
        state = "root" if self.key is None else \
            ("tomb" if self.addr is None else f"gid={self.addr.gid}")
        return (f"RadixNode({state}, hits={self.hits}, "
                f"children={len(self.children)})")


class RadixPrefixIndex:
    """Longest-prefix index over chained page keys.

    ``pin_threshold`` hits on a node pin its page (0 disables
    pinning); at most ``pin_capacity`` pages are pinned at once.
    """

    def __init__(self, *, pin_threshold: int = 4,
                 pin_capacity: int = 8):
        self.root = RadixNode(None, None, None)
        self._nodes: Dict[bytes, RadixNode] = {}    # digest -> node
        self._by_gid: Dict[int, RadixNode] = {}     # live pages only
        self._pinned: Set[int] = set()              # pinned gids
        self.pin_threshold = int(pin_threshold)
        self.pin_capacity = int(pin_capacity)
        self._tick = 0
        # counters (prefix.* in metrics())
        self.inserts = 0
        self.rearms = 0          # tombstones revived by re-derivation
        self.removes = 0
        self.trims = 0           # nodes physically deleted
        self.node_hits = 0
        self.full_walks = 0      # match() covered every key
        self.partial_walks = 0   # match() covered a proper prefix
        self.miss_walks = 0      # match() covered nothing
        self.pins = 0
        self.unpins = 0
        self.forced_unpins = 0   # pin released under eviction duress
        self.orphan_inserts = 0  # parent digest unknown -> root

    # -- size / membership --------------------------------------------
    def __len__(self) -> int:
        """Live (non-tombstone) nodes."""
        return len(self._by_gid)

    @property
    def node_count(self) -> int:
        """All nodes, tombstones included (root excluded)."""
        return len(self._nodes)

    @property
    def tombstones(self) -> int:
        return len(self._nodes) - len(self._by_gid)

    # -- point lookups (O(1) via the digest directory) ----------------
    def lookup(self, key: Key) -> Optional[GlobalAddress]:
        """The live page registered under `key`, or None (unknown key
        or tombstone).  Chained digests uniquely identify paths, so a
        directory probe answers without a walk."""
        node = self._nodes.get(key[0])
        if node is None or node.addr is None or node.key != key:
            return None
        return node.addr

    def node_for_gid(self, gid: int) -> Optional[RadixNode]:
        return self._by_gid.get(gid)

    def key_for_gid(self, gid: int) -> Optional[Key]:
        node = self._by_gid.get(gid)
        return None if node is None else node.key

    def owns_gid(self, gid: int) -> bool:
        """True while `gid` is the live owner of some prefix key —
        the tiered pool's cold-retention predicate."""
        return gid in self._by_gid

    # -- registration --------------------------------------------------
    def insert(self, key: Key, addr: GlobalAddress,
               parent: Optional[bytes] = None) -> None:
        """Register `addr` under `key`, as a child of the node owning
        digest `parent` (root when None — the chain's first page).

        One key per page and one page per key: registering a taken
        digest or an already-keyed gid is a no-op, EXCEPT that a
        tombstone re-derived by a fresh prefill is re-armed in place —
        the new page adopts the old node, keeping its subtree and hit
        history.
        """
        node = self._nodes.get(key[0])
        if node is not None:
            if node.addr is None and node.key == key \
                    and addr.gid not in self._by_gid:
                node.addr = addr
                self._by_gid[addr.gid] = node
                self.rearms += 1
            return
        if addr.gid in self._by_gid:
            return
        pnode = self.root
        if parent is not None:
            pnode = self._nodes.get(parent)
            if pnode is None:           # chain head dropped entirely:
                pnode = self.root       # keep the node reachable via
                self.orphan_inserts += 1  # the directory at least
        node = RadixNode(key, addr, pnode)
        pnode.children[key[0]] = node
        self._nodes[key[0]] = node
        self._by_gid[addr.gid] = node
        self.inserts += 1

    # -- longest-prefix match (O(len(keys))) --------------------------
    def match(self, keys: List[Key]) -> List[RadixNode]:
        """The longest leading run of `keys` forming a LIVE root path:
        one tree step per key, stopping at the first miss, tombstone,
        or fill mismatch.  Stamps hit statistics on every matched node
        (this is the admission-time probe; `lookup` stays stat-free)
        and auto-pins nodes that cross the hit threshold.
        """
        out: List[RadixNode] = []
        cur = self.root
        self._tick += 1
        for key in keys:
            child = cur.children.get(key[0])
            if child is None or child.addr is None or child.key != key:
                break
            child.hits += 1
            child.last_hit = self._tick
            self.node_hits += 1
            self._maybe_pin(child)
            out.append(child)
            cur = child
        if not out:
            self.miss_walks += 1
        elif len(out) == len(keys):
            self.full_walks += 1
        else:
            self.partial_walks += 1
        return out

    # -- pinning -------------------------------------------------------
    def _maybe_pin(self, node: RadixNode) -> None:
        if node.pinned or self.pin_threshold <= 0:
            return
        if node.hits < self.pin_threshold:
            return
        if len(self._pinned) >= self.pin_capacity:
            return
        node.pinned = True
        self._pinned.add(node.addr.gid)
        self.pins += 1

    def is_pinned(self, gid: int) -> bool:
        return gid in self._pinned

    @property
    def pinned_gids(self) -> Set[int]:
        return self._pinned

    def unpin_gid(self, gid: int, *, forced: bool = False) -> None:
        """Release a pin (eviction found no other candidate, or the
        page left the pool)."""
        node = self._by_gid.get(gid)
        if node is not None and node.pinned:
            node.pinned = False
        if gid in self._pinned:
            self._pinned.discard(gid)
            self.unpins += 1
            if forced:
                self.forced_unpins += 1

    # -- removal (page left the pool) ---------------------------------
    def remove_gid(self, gid: int) -> None:
        """Tombstone the node owning `gid` and trim childless
        tombstones up the path.  No-op for unkeyed gids."""
        node = self._by_gid.pop(gid, None)
        if node is None:
            return
        if node.pinned:
            node.pinned = False
            self._pinned.discard(gid)
            self.unpins += 1
        node.addr = None
        self.removes += 1
        while node is not self.root and node.addr is None \
                and not node.children:
            parent = node.parent
            if parent is not None:
                parent.children.pop(node.digest, None)
            self._nodes.pop(node.digest, None)
            node.parent = None
            self.trims += 1
            node = parent if parent is not None else self.root

    # -- telemetry -----------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        return {
            "prefix.nodes": len(self._by_gid),
            "prefix.tombstones": self.tombstones,
            "prefix.inserts": self.inserts,
            "prefix.rearms": self.rearms,
            "prefix.removes": self.removes,
            "prefix.node_hits": self.node_hits,
            "prefix.full_walks": self.full_walks,
            "prefix.partial_walks": self.partial_walks,
            "prefix.miss_walks": self.miss_walks,
            "prefix.pinned": len(self._pinned),
            "prefix.pins": self.pins,
            "prefix.unpins": self.unpins,
            "prefix.forced_unpins": self.forced_unpins,
        }

    # -- invariants (the property suite's oracle) ---------------------
    def check(self) -> None:
        """Assert structural invariants; raises AssertionError."""
        seen_gids: Set[int] = set()
        # every directory node is reachable from the root by parent
        # edges, consistent both ways
        for digest, node in self._nodes.items():
            assert node.key is not None and node.digest == digest
            parent = node.parent
            assert parent is not None, f"detached node {node!r}"
            assert parent.children.get(digest) is node, \
                f"parent/child edge broken at {node!r}"
            if node.addr is not None:
                assert self._by_gid.get(node.addr.gid) is node
                seen_gids.add(node.addr.gid)
            else:
                assert node.children, \
                    f"childless tombstone survived trim: {node!r}"
                assert not node.pinned
        assert seen_gids == set(self._by_gid), "gid directory drift"
        for gid in self._pinned:
            node = self._by_gid.get(gid)
            assert node is not None and node.pinned, \
                f"pinned gid {gid} has no live pinned node"
        for node in self._by_gid.values():
            assert node.pinned == (node.addr.gid in self._pinned)
        assert len(self._pinned) <= self.pin_capacity
        # children maps only contain directory members
        stack = [self.root]
        reachable = 0
        while stack:
            n = stack.pop()
            for d, c in n.children.items():
                assert self._nodes.get(d) is c
                assert c.parent is n
                reachable += 1
                stack.append(c)
        assert reachable == len(self._nodes), \
            "directory and tree disagree on membership"
