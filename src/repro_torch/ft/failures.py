"""Failure injection for fault-tolerance tests and drills.

`FailurePlan` deterministically raises `InjectedFailure` at configured
steps — the supervisor (ft/supervisor.py) must recover from every one
of them by restarting from the last checkpoint (tests/test_ft.py).

The serving stack consumes the same plan through a different trigger:
`kill_locality(shard, at_step)` schedules the loss of one KV-cache
locality mid-serve.  Nothing is raised for those — the serving engine
polls `shard_to_kill` at the top of each step and runs its drain /
rebuild / re-admit protocol (DESIGN.md §4g) instead of unwinding the
stack, because in-flight requests must finish, not restart.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable, Optional, Tuple


class InjectedFailure(RuntimeError):
    """Stands in for a lost node / preemption / hardware fault."""


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    fail_at_steps: FrozenSet[int] = frozenset()
    kind: str = "node_loss"
    #: (step, locality) pairs: at the top of `step`, serving locality
    #: `locality` dies (its KV pages are swept; see PagePool.kill_locality)
    kill_at: FrozenSet[Tuple[int, int]] = frozenset()

    @staticmethod
    def at(*steps: int) -> "FailurePlan":
        return FailurePlan(frozenset(steps))

    @staticmethod
    def kill_locality(shard: int, at_step: int) -> "FailurePlan":
        """A serving-facing plan: kill one KV locality at one step."""
        return FailurePlan(kill_at=frozenset({(int(at_step), int(shard))}))

    def check(self, step: int, already_failed: set) -> None:
        if step in self.fail_at_steps and step not in already_failed:
            already_failed.add(step)
            raise InjectedFailure(
                f"injected {self.kind} at step {step}")

    def shard_to_kill(self, step: int, already_killed: set
                      ) -> Optional[int]:
        """The serving-side trigger: which locality (if any) dies at
        `step`.  Fires once per (step, shard) pair; does not raise —
        the engine's recovery path keeps every request alive."""
        for at, shard in sorted(self.kill_at):
            if at == step and (at, shard) not in already_killed:
                already_killed.add((at, shard))
                return shard
        return None
