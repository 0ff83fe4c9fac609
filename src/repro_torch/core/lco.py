"""Local Control Objects (LCOs): futures, dataflow, and friends.

The paper (Sec. II, "Local Control Objects") describes LCOs as the
synchronization abstraction that lets "every single function proceed as
far as possible": futures proxy not-yet-computed values, dataflow LCOs
fire a continuation once their precedent constraints are satisfied, and
both eliminate global barriers in favour of point-to-point dependence.

Two realizations live here:

* Host LCOs (`Future`, `Dataflow`, `FullEmptyBit`, `CountingSemaphore`)
  — real synchronization objects used by the host dataflow engine.  They
  are deliberately *cooperative*: `Dataflow.set_input` runs ready
  continuations inline on the caller (the analogue of an HPX-thread being
  scheduled on the OS-thread that satisfied the last dependency), so a
  single-threaded caller exhibits exactly the paper's event-driven
  semantics without preemption.

* Compiled LCOs — when a task graph is lowered onto a device mesh the
  LCO disappears into HLO data dependence (see core/scheduler.py).  That
  is this framework's answer to the paper's Sec. V "hardware acceleration
  of runtime functions": synchronization costs are paid at compile time,
  not at run time.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Optional

from repro_torch.obs import trace as _trace

_UNSET = object()


class LCOError(RuntimeError):
    pass


class Future:
    """A write-once value proxy (paper refs [15-17]).

    `set` may be called exactly once; `get` returns the value, running
    queued continuations first if needed.  Continuations registered via
    `then` run inline when the value arrives (cooperative scheduling).
    """

    _ids = itertools.count()

    __slots__ = ("gid", "_value", "_error", "_cbs", "_lock")

    def __init__(self, gid: Optional[int] = None):
        self.gid = gid if gid is not None else next(Future._ids)
        self._value = _UNSET
        self._error: Optional[BaseException] = None
        self._cbs: list[Callable[[Any], None]] = []
        self._lock = threading.Lock()

    # -- producer side ----------------------------------------------------
    def set(self, value: Any) -> None:
        with self._lock:
            if self._value is not _UNSET or self._error is not None:
                raise LCOError(f"future {self.gid} set twice")
            self._value = value
            cbs, self._cbs = self._cbs, []
        _trace.GLOBAL.instant("lco", "future_set", lco=self.gid,
                              waiters=len(cbs))
        for cb in cbs:  # run continuations inline, outside the lock
            cb(value)

    def set_error(self, err: BaseException) -> None:
        with self._lock:
            if self._value is not _UNSET or self._error is not None:
                raise LCOError(f"future {self.gid} set twice")
            self._error = err
            self._cbs = []
        _trace.GLOBAL.instant("lco", "future_error", lco=self.gid)

    # -- consumer side ----------------------------------------------------
    def done(self) -> bool:
        return self._value is not _UNSET or self._error is not None

    def get(self) -> Any:
        if self._error is not None:
            raise self._error
        if self._value is _UNSET:
            raise LCOError(
                f"future {self.gid} read before set: in the cooperative "
                "host engine a get() on an unset future means the task "
                "graph has a missing dependence edge"
            )
        return self._value

    def then(self, cb: Callable[[Any], None]) -> None:
        with self._lock:
            if self._value is _UNSET and self._error is None:
                self._cbs.append(cb)
                _trace.GLOBAL.instant("lco", "future_wait", lco=self.gid)
                return
            value = self._value
        if self._error is None:
            cb(value)


class Dataflow:
    """Dataflow LCO: fires a continuation when all N inputs are set.

    "The dataflow LCO construct acquires result values (or references)
    and is event driven updating its internal state accordingly until one
    or more precedent constraints are satisfied; then it initiates
    further program action" (paper, Sec. II).
    """

    __slots__ = ("n", "inputs", "_remaining", "_action", "_fired", "_lock")

    def __init__(self, n_inputs: int, action: Callable[[list], Any]):
        if n_inputs < 0:
            raise ValueError("n_inputs must be >= 0")
        self.n = n_inputs
        self.inputs: list = [_UNSET] * n_inputs
        self._remaining = n_inputs
        self._action = action
        self._fired = False
        self._lock = threading.Lock()
        if n_inputs == 0:
            self._fire()

    def set_input(self, slot: int, value: Any) -> None:
        fire = False
        with self._lock:
            if self.inputs[slot] is not _UNSET:
                raise LCOError(f"dataflow input {slot} set twice")
            self.inputs[slot] = value
            self._remaining -= 1
            fire = self._remaining == 0
        if fire:
            self._fire()

    def _fire(self) -> None:
        if self._fired:
            raise LCOError("dataflow fired twice")
        self._fired = True
        _trace.GLOBAL.instant("lco", "dataflow_fire", inputs=self.n)
        self._action(list(self.inputs))

    @property
    def fired(self) -> bool:
        return self._fired


class FullEmptyBit:
    """Classic full/empty synchronization word (single producer/consumer)."""

    __slots__ = ("_full", "_value", "_waiters")

    def __init__(self):
        self._full = False
        self._value = None
        self._waiters: list[Callable[[Any], None]] = []

    def write_ef(self, value: Any) -> None:
        """Write when empty, mark full, wake readers."""
        if self._full:
            raise LCOError("write_ef on a full cell")
        self._value, self._full = value, True
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            w(value)

    def read_fe(self) -> Any:
        """Read when full, mark empty."""
        if not self._full:
            raise LCOError("read_fe on an empty cell")
        self._full = False
        v, self._value = self._value, None
        return v

    def read_ff(self, cb: Callable[[Any], None]) -> None:
        """Read-when-full leaving the cell full (continuation form)."""
        if self._full:
            cb(self._value)
        else:
            self._waiters.append(cb)


class CountingSemaphore:
    """Cooperative counting semaphore; continuations instead of blocking."""

    __slots__ = ("_count", "_waiters")

    def __init__(self, initial: int = 0):
        self._count = initial
        self._waiters: list[Callable[[], None]] = []

    def signal(self, n: int = 1) -> None:
        self._count += n
        while self._count > 0 and self._waiters:
            self._count -= 1
            self._waiters.pop(0)()

    def wait(self, cb: Callable[[], None]) -> None:
        if self._count > 0:
            self._count -= 1
            cb()
        else:
            self._waiters.append(cb)


class DependencyCounter:
    """The minimal LCO behind compiled scheduling: a countdown trigger.

    Used by the scheduler to convert a task DAG into firing order without
    materializing values; this is the exact object that gets "compiled
    away" on device.
    """

    __slots__ = ("remaining", "on_zero")

    def __init__(self, n: int, on_zero: Callable[[], None]):
        self.remaining = n
        self.on_zero = on_zero
        if n == 0:
            on_zero()

    def satisfy(self) -> None:
        self.remaining -= 1
        if self.remaining == 0:
            self.on_zero()
        elif self.remaining < 0:
            raise LCOError("dependency counter over-satisfied")
