"""Localities: the ParalleX boundary between synchronous and asynchronous.

In the paper (Sec. II) a *locality* is "a contiguous physical domain,
managing intra-locality latencies, while guaranteeing compound atomic
operations on local state"; HPX equates a locality with a cluster node.

In this framework a locality is one mesh device (a TPU chip in the
production mesh, a host CPU worker in the simulator).  Intra-locality
operations are vectorized block-batched computations that XLA keeps in
VMEM; inter-locality operations are explicit collectives (parcels).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Locality:
    """A single ParalleX locality.

    Attributes:
      lid:   dense locality id in [0, num_localities).
      coords: coordinates in the device mesh (e.g. (pod, data, model)),
              empty for host-simulated localities.
      kind:  "device" for mesh-backed, "sim" for the scheduler simulator.
    """

    lid: int
    coords: tuple = ()
    kind: str = "sim"

    def __index__(self) -> int:
        return self.lid


@dataclasses.dataclass(frozen=True)
class LocalityDomain:
    """An ordered set of localities cooperating on one computation.

    The domain is the unit over which AGAS distributes first-class
    objects and over which the scheduler balances tasks.
    """

    localities: tuple

    @staticmethod
    def simulated(n: int) -> "LocalityDomain":
        return LocalityDomain(tuple(Locality(i, (), "sim") for i in range(n)))

    @staticmethod
    def from_mesh_axis(mesh, axis: str | Sequence[str]) -> "LocalityDomain":
        """One locality per device along `axis` of a jax Mesh.

        Several mesh axes may be folded together (e.g. ("pod", "data")),
        producing their cartesian product in row-major order.
        """
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        sizes = [mesh.shape[a] for a in axes]
        n = 1
        for s in sizes:
            n *= s
        locs = []
        for i in range(n):
            rem, coords = i, []
            for s in reversed(sizes):
                coords.append(rem % s)
                rem //= s
            locs.append(Locality(i, tuple(reversed(coords)), "device"))
        return LocalityDomain(tuple(locs))

    def __len__(self) -> int:
        return len(self.localities)

    def __iter__(self):
        return iter(self.localities)

    def __getitem__(self, i: int) -> Locality:
        return self.localities[i]
