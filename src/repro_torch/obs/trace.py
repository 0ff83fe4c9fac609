"""Low-overhead ring-buffer tracer with causal ids and Chrome export.

The runtime has five interacting subsystems (engine scheduler, paged
pool, sharded AGAS, percolation tiering, prefix-cache skip); this module
gives them one shared event stream.  Two record shapes:

- **span**: a timed interval (``dur`` seconds) opened/closed via the
  ``span(...)`` context manager.  Spans carry a ``kind`` used by
  overhead attribution ("compute", "sched", "pages", "parcel", "copy").
- **instant**: a point event (``dur is None``) — page allocs, LCO sets,
  parcel sends, slot binds.

Causal ids ride in ``args``: engine events carry ``rid`` (request),
``slot``; kvcache events carry ``slot`` and ``gid``/``gids`` (AGAS page
names); parcel/percolation events carry the ``gids`` they move.  Because
AGAS gids are never recycled (itertools counter), a gid is a globally
unique causal id and "dangling" is decidable from the event stream alone
(see ``obs.attribution.check_causal``).

Parent links come from a per-thread span stack: a record's ``parent`` is
the sid of the innermost open span *of the same tracer* on this thread
at the time the record was opened.  Records land in a preallocated ring
(oldest evicted first, ``dropped`` counts evictions) so memory stays
O(capacity) over arbitrarily long runs.

Disabled tracing is the ``NULL_TRACER`` singleton: every call is a
constant-time no-op (no clock read, no allocation beyond the call
itself).  Free-standing subsystems that have no constructor path for a
tracer (``core.lco``, ``core.parcels``, ``core.agas``) emit through the
module-global ``GLOBAL``, rebindable via ``set_global`` — attribute
lookup at call time, so rebinding takes effect immediately.
"""

import json
import threading
import time

__all__ = [
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "GLOBAL",
    "set_global",
    "get_global",
]


class Span:
    """One trace record.  ``dur is None`` marks an instant event."""

    __slots__ = ("sid", "parent", "subsystem", "name", "kind", "lane",
                 "t0", "dur", "args")

    def __init__(self, sid, parent, subsystem, name, kind, lane, t0,
                 dur, args):
        self.sid = sid
        self.parent = parent
        self.subsystem = subsystem
        self.name = name
        self.kind = kind
        self.lane = lane
        self.t0 = t0
        self.dur = dur
        self.args = args

    def __repr__(self):
        shape = "instant" if self.dur is None else f"dur={self.dur:.6f}"
        return (f"Span(sid={self.sid}, {self.subsystem}/{self.name}, "
                f"t0={self.t0:.6f}, {shape}, parent={self.parent})")


class _SpanCtx:
    """Context manager opening/closing one span on a live tracer."""

    __slots__ = ("_tr", "_rec")

    def __init__(self, tr, rec):
        self._tr = tr
        self._rec = rec

    def __enter__(self):
        tr = self._tr
        rec = self._rec
        stack = tr._stack()
        rec.parent = stack[-1].sid if stack else None
        rec.t0 = tr.clock()
        stack.append(rec)
        return rec

    def __exit__(self, exc_type, exc, tb):
        tr = self._tr
        rec = self._rec
        rec.dur = tr.clock() - rec.t0
        stack = tr._stack()
        if stack and stack[-1] is rec:
            stack.pop()
        tr._append(rec)
        return False


class _NullSpan:
    """Returned by NullTracer.span().__enter__; absorbs arg mutation."""

    __slots__ = ("args",)

    def __init__(self):
        self.args = {}


class _NullCtx:
    __slots__ = ("_span",)

    def __init__(self):
        self._span = _NullSpan()

    def __enter__(self):
        return self._span

    def __exit__(self, exc_type, exc, tb):
        return False


class NullTracer:
    """Disabled tracer: every call is a constant-time no-op."""

    enabled = False
    dropped = 0
    clock = staticmethod(time.perf_counter)

    def __init__(self):
        self._ctx = _NullCtx()

    def span(self, subsystem, name, kind=None, lane=None, **args):
        return self._ctx

    def instant(self, subsystem, name, kind=None, lane=None, **args):
        return None

    def records(self):
        return []

    def clear(self):
        return None


NULL_TRACER = NullTracer()


class Tracer:
    """Ring-buffer tracer.  ``capacity`` bounds retained records."""

    enabled = True

    def __init__(self, capacity=65536, clock=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.clock = clock if clock is not None else time.perf_counter
        self._buf = [None] * capacity
        self._n = 0          # total records ever appended
        self._sid = 0
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- internals -------------------------------------------------------

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _next_sid(self):
        with self._lock:
            self._sid += 1
            return self._sid

    def _append(self, rec):
        with self._lock:
            self._buf[self._n % self.capacity] = rec
            self._n += 1

    # -- recording API ---------------------------------------------------

    def span(self, subsystem, name, kind=None, lane=None, **args):
        rec = Span(self._next_sid(), None, subsystem, name, kind, lane,
                   0.0, None, args)
        return _SpanCtx(self, rec)

    def instant(self, subsystem, name, kind=None, lane=None, **args):
        stack = self._stack()
        parent = stack[-1].sid if stack else None
        rec = Span(self._next_sid(), parent, subsystem, name, kind,
                   lane, self.clock(), None, args)
        self._append(rec)
        return rec

    # -- inspection ------------------------------------------------------

    @property
    def dropped(self):
        return max(0, self._n - self.capacity)

    def records(self):
        """Retained records, oldest first (append order)."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return [r for r in self._buf[:n]]
            i = n % cap
            return self._buf[i:] + self._buf[:i]

    def clear(self):
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0

    # -- Chrome trace-event export ---------------------------------------

    def to_chrome(self):
        """Records as a Chrome trace-event dict (perfetto-viewable).

        One process (pid) per subsystem, one thread (tid) per lane within
        it (lane None -> "main").  Spans become "X" complete events with
        microsecond ts/dur relative to the earliest record; instants
        become thread-scoped "i" events.  Causal args (rid/slot/gid/...)
        and the span sid/parent ride in each event's ``args`` so links
        survive the export.
        """
        recs = self.records()
        events = []
        pids = {}
        tids = {}
        tbase = min((r.t0 for r in recs), default=0.0)
        for r in recs:
            pid = pids.get(r.subsystem)
            if pid is None:
                pid = pids[r.subsystem] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": r.subsystem}})
            lane = "main" if r.lane is None else str(r.lane)
            tid = tids.get((pid, lane))
            if tid is None:
                tid = tids[(pid, lane)] = \
                    len([k for k in tids if k[0] == pid]) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": lane}})
            args = dict(r.args)
            args["sid"] = r.sid
            if r.parent is not None:
                args["parent"] = r.parent
            if r.kind is not None:
                args["kind"] = r.kind
            ev = {"name": r.name, "cat": r.subsystem, "pid": pid,
                  "tid": tid, "ts": (r.t0 - tbase) * 1e6, "args": args}
            if r.dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = r.dur * 1e6
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path):
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# Free-standing subsystems (lco, parcels, agas) trace through this
# global; call sites read it by attribute so set_global takes effect
# immediately.  Default is the null tracer: zero overhead when off.
GLOBAL = NULL_TRACER


def set_global(tracer):
    global GLOBAL
    GLOBAL = tracer if tracer is not None else NULL_TRACER
    return GLOBAL


def get_global():
    return GLOBAL
