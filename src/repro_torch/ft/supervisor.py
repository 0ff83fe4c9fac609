"""The restart budget of the checkpoint-restart supervisor.

Only `RecoveryBudget` is carried over from `repro.ft.supervisor`: the
serving engine spends from it on locality loss.  The supervisor loop
itself (`run_supervised`) comes with the training slice.
"""

from __future__ import annotations

import dataclasses

from repro_torch.ft.failures import InjectedFailure

#: `repro.ft.supervisor.SupervisorConfig.max_restarts`
MAX_RESTARTS = 8


@dataclasses.dataclass
class RecoveryBudget:
    """The supervisor's restart budget, factored out so the serving
    engine's locality-loss recovery (DESIGN.md §4g) spends from the
    same ledger: each recovered failure costs one restart; exceeding
    the budget re-raises, exactly like `run_supervised` — a fleet that
    keeps losing localities should crash loudly, not thrash forever."""

    max_restarts: int = MAX_RESTARTS
    restarts: int = 0

    def spend(self, what: str = "failure") -> None:
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise InjectedFailure(
                f"recovery budget exhausted: {self.restarts} restarts "
                f"(max {self.max_restarts}) after {what}")
