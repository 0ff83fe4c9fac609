"""Request-level SLO/goodput observability (DESIGN.md §10).

Span-granularity attribution (obs/attribution.py) answers "where does
a STEP's wall-clock go"; this module answers the request-level
question the serving tier needs: *which requests missed their
deadline, and which lifecycle phase ate the budget?*

Two pieces:

- **FlightRecorder** — a per-request event timeline.  Every request
  carries a compact list of lifecycle events (submit → bind →
  prefill chunks → handoff stage/commit → first token → each
  preempt/offload/restore → finish), appended by engine hooks at the
  same boundaries the tracer spans open and close, so the recorder's
  exec durations reconcile with the §10 attribution buckets.
  Execution events carry a ``dur`` measured by the hook; everything
  else is a point event.  Disabled recording is the ``NULL_RECORDER``
  singleton — every call a constant-time no-op.  Finished requests
  are retained up to ``retain`` timelines (oldest finished evicted
  first) so memory stays bounded over arbitrarily long runs.

- **Deadline classification** — requests optionally carry
  ``ttft_deadline_ms`` / ``itl_deadline_ms`` (serving/types.py).  At
  completion the engine calls ``classify``: a request is *met* iff
  its TTFT is within the TTFT deadline and its p95 inter-token gap is
  within the ITL deadline.  A miss is blamed on the largest timeline
  contributor in the relevant window (``BLAME_PHASES``: queue /
  prefill / handoff / preempt / decode), derived from the flight
  timeline by ``derive_phases``.  Verdicts stream into the metrics
  registry under ``slo.*`` (``record_verdict``) so ``stats()`` and
  the exporters see goodput without scanning completions.

Phase semantics (``derive_phases``): the TTFT window is
[submit, first_token] and splits into ``queue`` (submit → first
bind), ``preempted`` (preempt → re-bind gaps), ``prefill_exec``
(summed durs of prefill / prefill_chunk / resume / restore exec
events), ``handoff`` (summed handoff op durs) and ``prefill_wait``
(the remainder: admitted but waiting for step budget).  The decode
window is [first_token, finish]: ``decode`` is its span minus
``preempted`` gaps (handoff op durs are reported separately but stay
inside decode — the §4f staged copy overlaps the decode batch by
design).  All values are seconds.
"""

import json
import time

import numpy as np

__all__ = [
    "BLAME_PHASES",
    "EXEC_EVENTS",
    "FlightRecorder",
    "NULL_RECORDER",
    "NullFlightRecorder",
    "classify",
    "derive_phases",
    "record_verdict",
    "build_report",
]

#: Blame categories a missed deadline resolves to (queueing /
#: prefill / handoff / preemption / decode).
BLAME_PHASES = ("queue", "prefill", "handoff", "preempt", "decode")

#: Event names whose ``dur`` counts as prefill execution.
EXEC_EVENTS = frozenset(("prefill", "prefill_chunk", "resume",
                         "restore"))

#: Event names whose ``dur`` counts as handoff copy work.
HANDOFF_EVENTS = frozenset(("handoff_stage", "handoff_commit"))

_EPS = 1e-9


class FlightEvent:
    """One lifecycle event: ``dur`` is None for point events."""

    __slots__ = ("t", "name", "args")

    def __init__(self, t, name, args):
        self.t = t
        self.name = name
        self.args = args

    @property
    def dur(self):
        return self.args.get("dur")

    def to_json(self):
        return {"t": self.t, "name": self.name, **self.args}

    def __repr__(self):
        return f"FlightEvent({self.name!r}, t={self.t:.6f}, {self.args})"


class NullFlightRecorder:
    """Disabled recorder: every call is a constant-time no-op."""

    enabled = False

    def event(self, rid, name, t=None, **args):
        return None

    def timeline(self, rid):
        return ()

    def rids(self):
        return ()

    def phases(self, rid):
        return {}

    def to_json(self):
        return {"requests": {}}

    def clear(self):
        return None


NULL_RECORDER = NullFlightRecorder()


class FlightRecorder:
    """Per-request lifecycle timelines, bounded by ``retain``."""

    enabled = True

    def __init__(self, retain=4096, clock=None):
        self.retain = int(retain)
        self.clock = clock if clock is not None else time.perf_counter
        self._events = {}          # rid -> [FlightEvent, ...]
        self._finished = []        # rids in finish order (FIFO evict)

    def event(self, rid, name, t=None, **args):
        """Append one event to ``rid``'s timeline.  ``t`` defaults to
        the recorder clock NOW; exec hooks pass ``dur=seconds``."""
        ev = FlightEvent(self.clock() if t is None else t, name, args)
        self._events.setdefault(rid, []).append(ev)
        if name == "finish":
            self._finished.append(rid)
            while len(self._finished) > self.retain:
                self._events.pop(self._finished.pop(0), None)
        return ev

    def timeline(self, rid):
        """``rid``'s events in append order (appends are monotone in
        recorder-clock time)."""
        return tuple(self._events.get(rid, ()))

    def rids(self):
        return sorted(self._events)

    def phases(self, rid):
        return derive_phases(self.timeline(rid))

    def to_json(self):
        return {"requests": {
            str(rid): {"events": [e.to_json() for e in evs],
                       "phases": derive_phases(tuple(evs))}
            for rid, evs in sorted(self._events.items())}}

    def dump_json(self, path):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        return path

    def clear(self):
        self._events.clear()
        self._finished.clear()


def _clip(a, b, lo, hi):
    """Overlap of [a, b] with [lo, hi]."""
    return max(0.0, min(b, hi) - max(a, lo))


def derive_phases(timeline):
    """Decompose one timeline into per-phase seconds (see module
    docstring).  Robust to partial timelines: a request that never
    reached its first token (or never finished) reports the phases
    of the window it did traverse."""
    if not timeline:
        return {}
    t_submit = timeline[0].t
    t_first = None
    t_finish = None
    binds = []
    preempts = []
    exec_events = []
    handoff_durs = []
    for ev in timeline:
        if ev.name == "submit":
            t_submit = ev.t
        elif ev.name == "bind":
            binds.append(ev.t)
        elif ev.name == "preempt":
            preempts.append(ev.t)
        elif ev.name == "first_token":
            t_first = ev.t
        elif ev.name == "finish":
            t_finish = ev.t
        if ev.name in EXEC_EVENTS and ev.dur is not None:
            exec_events.append(ev)
        elif ev.name in HANDOFF_EVENTS and ev.dur is not None:
            handoff_durs.append(ev)
    t_end = t_finish if t_finish is not None else timeline[-1].t
    t_cut = t_first if t_first is not None else t_end
    # queue: submit -> first bind (never past the first token)
    queue = _clip(t_submit, binds[0] if binds else t_cut,
                  t_submit, t_cut)
    # preempted: each preempt -> next bind (or end-of-trace) gap,
    # split at the first token
    pre_gaps_pre = pre_gaps_post = 0.0
    for pt in preempts:
        nxt = next((b for b in binds if b > pt + _EPS), t_end)
        pre_gaps_pre += _clip(pt, nxt, t_submit, t_cut)
        pre_gaps_post += _clip(pt, nxt, t_cut, t_end)
    # exec durs, split by the window the op STARTED in (events are
    # stamped at op end; the final prefill chunk samples the first
    # token inside itself, so its dur belongs to the TTFT window)
    exec_pre = sum(e.dur for e in exec_events
                   if e.t - e.dur <= t_cut + _EPS)
    exec_post = sum(e.dur for e in exec_events
                    if e.t - e.dur > t_cut + _EPS)
    hand_pre = sum(e.dur for e in handoff_durs
                   if e.t - e.dur <= t_cut + _EPS)
    hand_post = sum(e.dur for e in handoff_durs
                    if e.t - e.dur > t_cut + _EPS)
    ttft = max(0.0, t_cut - t_submit)
    wait = max(0.0, ttft - queue - pre_gaps_pre - exec_pre - hand_pre)
    decode = 0.0
    if t_first is not None:
        decode = max(0.0, t_end - t_first - pre_gaps_post)
    return {
        "queue": queue,
        "prefill_exec": exec_pre,
        "prefill_wait": wait,
        "prefill_exec_post": exec_post,     # mid-prefill preemption
        "handoff": hand_pre + hand_post,    # op durs (copy work)
        "preempted": pre_gaps_pre + pre_gaps_post,
        "preempted_pre_first": pre_gaps_pre,
        "decode": decode,
        "ttft_s": ttft if t_first is not None else None,
        "e2e_s": max(0.0, t_end - t_submit),
        "complete": t_finish is not None,
    }


def _blame_ttft(ph):
    """Largest TTFT-window contributor."""
    buckets = {
        "queue": ph.get("queue", 0.0),
        "prefill": ph.get("prefill_exec", 0.0)
        + ph.get("prefill_wait", 0.0),
        "handoff": 0.0,   # §4f samples the first token before detach
        "preempt": ph.get("preempted_pre_first", 0.0),
    }
    return max(buckets, key=lambda k: buckets[k])


def _blame_itl(ph):
    """Largest decode-window contributor."""
    post_pre = ph.get("preempted", 0.0) \
        - ph.get("preempted_pre_first", 0.0)
    buckets = {
        "decode": ph.get("decode", 0.0),
        "preempt": post_pre + ph.get("prefill_exec_post", 0.0),
        "handoff": ph.get("handoff", 0.0),
    }
    return max(buckets, key=lambda k: buckets[k])


def classify(req, comp, timeline=None):
    """Deadline verdict for one completion.

    ``req`` needs ``ttft_deadline_ms`` / ``itl_deadline_ms`` (both
    optional — a request carrying neither is untracked and never
    counts against goodput).  ``comp`` is a serving Completion
    (``ttft_s``, ``itl_s``).  ``timeline`` (flight-recorder events)
    enables per-phase blame; without it a miss is ``unattributed``.
    """
    ttft_dl = getattr(req, "ttft_deadline_ms", None)
    itl_dl = getattr(req, "itl_deadline_ms", None)
    tracked = ttft_dl is not None or itl_dl is not None
    ttft_ms = comp.ttft_s * 1e3
    itl_p95_ms = (float(np.percentile(comp.itl_s, 95.0)) * 1e3
                  if comp.itl_s else 0.0)
    ttft_miss = ttft_dl is not None and ttft_ms > ttft_dl
    itl_miss = itl_dl is not None and itl_p95_ms > itl_dl
    met = tracked and not (ttft_miss or itl_miss)
    blame = None
    if ttft_miss or itl_miss:
        ph = derive_phases(timeline) if timeline else {}
        if not ph:
            blame = "unattributed"
        elif ttft_miss:        # TTFT is the tighter promise: blame it
            blame = _blame_ttft(ph)
        else:
            blame = _blame_itl(ph)
    return {
        "rid": comp.rid,
        "tracked": tracked,
        "met": met,
        "ttft_miss": ttft_miss,
        "itl_miss": itl_miss,
        "blame": blame,
        "ttft_ms": ttft_ms,
        "ttft_deadline_ms": ttft_dl,
        "itl_p95_ms": itl_p95_ms,
        "itl_deadline_ms": itl_dl,
    }


def record_verdict(metrics, verdict):
    """Stream one verdict into the §10 registry (``slo.*``)."""
    if not verdict["tracked"]:
        return
    req_c = metrics.counter("slo.requests")
    met_c = metrics.counter("slo.met")
    req_c.inc()
    if verdict["met"]:
        met_c.inc()
    if verdict["ttft_miss"]:
        metrics.counter("slo.ttft_misses").inc()
    if verdict["itl_miss"]:
        metrics.counter("slo.itl_misses").inc()
    if verdict["blame"] is not None:
        metrics.counter(f"slo.blame.{verdict['blame']}").inc()
    metrics.gauge("slo.goodput").set(met_c.value / req_c.value)


def build_report(engine):
    """End-of-run goodput report: registry aggregates + per-request
    verdicts and phase decompositions (when the engine ran with a
    flight recorder).  JSON-serializable."""
    snap = engine.metrics.snapshot()
    verdicts = getattr(engine, "slo_verdicts", {})
    recorder = getattr(engine, "recorder", NULL_RECORDER)
    blame = {p: int(snap.get(f"slo.blame.{p}", 0))
             for p in BLAME_PHASES}
    blame["unattributed"] = int(snap.get("slo.blame.unattributed", 0))
    totals = {}
    per_request = []
    for rid in sorted(verdicts):
        v = verdicts[rid]
        ph = recorder.phases(rid) if recorder.enabled else {}
        for k, s in ph.items():
            if isinstance(s, (int, float)) and k not in (
                    "ttft_s", "e2e_s", "complete"):
                totals[k] = totals.get(k, 0.0) + s
        per_request.append({**v, "phases": ph})
    return {
        "requests": int(snap.get("slo.requests", 0)),
        "met": int(snap.get("slo.met", 0)),
        "goodput": float(snap.get("slo.goodput", 0.0)),
        "ttft_misses": int(snap.get("slo.ttft_misses", 0)),
        "itl_misses": int(snap.get("slo.itl_misses", 0)),
        "blame": blame,
        "phase_totals_s": totals,
        "per_request": per_request,
    }
