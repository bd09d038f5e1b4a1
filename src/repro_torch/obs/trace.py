"""Low-overhead trace recorder: a tree of spans and instants, on the
profiler's clock, → Chrome trace JSON and windowed span lists.

Design constraints:

* **No locks on the hot path.**  Each thread records into its own
  preallocated ring buffer (a NumPy structured array plus a parallel
  ``args`` slot list); the only lock is taken once per thread at ring
  registration and once per *new* event name at interning.  Ring slots
  wrap: when a ring fills, the oldest events are overwritten and counted
  in ``dropped`` — recording never blocks and never grows memory.
* **Recording when asked for, or under a profiler.**  Events are recorded
  after :func:`enable`, or while a ``torch.profiler`` session is collecting
  in the process (one attribute read finds out), so a profile of the
  program carries the program's own spans.  A profiler session gets a
  fresh recorder at its first span, provided a span, an instant or
  :func:`enabled` saw the previous session end.  Off,
  :func:`span` returns a shared no-op singleton (zero allocation) and
  :func:`instant` returns at once.  :func:`timed` is the one variant that
  *always* measures (``time.perf_counter_ns``) because callers feed its
  duration into their own statistics (the pipeline's Eq. 1, the serving
  engine's prefill and decode seconds); it records an event only while
  recording, and reuses spans from a per-thread freelist so the steady
  state allocates nothing in either mode.  No ``record_function`` range is
  emitted: Kineto would put each on the device's timeline.
* **A tree.**  Every event gets an id and the id of the span open around
  it on the same thread (0 at the top); callers put a request's id in
  ``args`` to join the spans of one request.
* **Two clocks, one mapping.**  Durations come from
  ``time.perf_counter_ns`` — the clock the callers' statistics use.
  Timestamps leave the recorder on the profiler's clock (Kineto's host
  and device events: ns since the Unix epoch): the recorder pairs
  ``time.time_ns`` with ``perf_counter_ns`` when it is made and again
  whenever it is read, and maps stamps linearly between the two pairs,
  so a slew of the wall clock over a run does not skew them.

Export is the Chrome trace-event format (``{"traceEvents": [...]}``),
with ``ts`` in microseconds since the epoch as Kineto writes it: open the
file in https://ui.perfetto.dev beside a ``torch.profiler`` trace.  Spans
are complete events (``ph: "X"``) carrying ``id`` and ``parent``;
instants are ``ph: "i"``; thread names are emitted as ``M`` metadata so
producer/consumer/prefetcher/peer lanes are labeled in the timeline.

Usage::

    from repro_torch.obs import trace

    trace.enable()                       # or: with trace.tracing():
    with trace.span("storage/read_batch", "storage"):
        ...
    trace.instant("storage/retry", "storage", args={"attempt": 2})
    trace.get_recorder().export_chrome("trace.json")
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch.autograd.profiler as _autograd_profiler

# Event record: interned name/cat ids, phase, perf_counter ns start +
# duration, the event's id and the id of the span open around it.
_EVENT_DTYPE = np.dtype(
    [
        ("name", np.uint32),
        ("cat", np.uint32),
        ("ph", np.uint8),
        ("ts", np.int64),
        ("dur", np.int64),
        ("id", np.int64),
        ("parent", np.int64),
    ]
)
_PH_COMPLETE = 0  # Chrome "X"
_PH_INSTANT = 1  # Chrome "i"
_PH_CHARS = {_PH_COMPLETE: "X", _PH_INSTANT: "i"}

DEFAULT_RING_CAPACITY = 65536


def _clock_pair() -> Tuple[int, int]:
    """(``time.time_ns()``, the ``perf_counter_ns`` it was read at): the
    wall clock between two monotonic reads, paired with their midpoint."""
    p0 = time.perf_counter_ns()
    wall = time.time_ns()
    return wall, (p0 + time.perf_counter_ns()) // 2


class SpanRecord(NamedTuple):
    """A complete span on the profiler's clock (ns since the epoch)."""

    name: str
    start: int
    end: int
    id: int
    parent: int
    args: Optional[dict]


class _ThreadRing:
    """One thread's preallocated event ring.  Only the owning thread
    writes; readers (drain/export/spans) read from any thread and are
    *nearly* consistent — read at quiesce points for exact traces."""

    __slots__ = ("events_buf", "args_buf", "capacity", "idx", "tid", "tname")

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.events_buf = np.empty(capacity, dtype=_EVENT_DTYPE)  # read only once written
        self.args_buf: List[Optional[dict]] = [None] * capacity
        self.idx = 0  # monotonically increasing write position
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.tname = t.name

    def push(self, nid: int, cid: int, ph: int, ts: int, dur: int, eid: int,
             parent: int, args):
        i = self.idx % self.capacity
        self.events_buf[i] = (nid, cid, ph, ts, dur, eid, parent)
        self.args_buf[i] = args
        self.idx += 1

    @property
    def dropped(self) -> int:
        return max(0, self.idx - self.capacity)

    def ordered(self) -> Tuple[np.ndarray, np.ndarray]:
        """(slot indices, events) oldest→newest (handles wraparound)."""
        lo = max(0, self.idx - self.capacity)
        slots = np.arange(lo, self.idx) % self.capacity
        return slots, self.events_buf[slots]


class TraceRecorder:
    """Process-wide recorder: interning tables + the set of thread rings."""

    def __init__(self, capacity_per_thread: int = DEFAULT_RING_CAPACITY):
        self.capacity_per_thread = capacity_per_thread
        self.anchor = _clock_pair()
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._rings: List[_ThreadRing] = []
        # interning: plain dict gets are GIL-atomic; writes happen under
        # the lock, so a racing reader at worst re-misses and re-locks.
        self._name_ids: Dict[str, int] = {}
        self._names: List[str] = []
        self._cat_ids: Dict[str, int] = {}
        self._cats: List[str] = []

    # ------------------------------------------------------------ intern
    def _intern(self, table: Dict[str, int], rev: List[str], s: str) -> int:
        i = table.get(s)
        if i is not None:
            return i
        with self._lock:
            i = table.get(s)
            if i is None:
                i = len(rev)
                rev.append(s)
                table[s] = i
            return i

    def name_id(self, name: str) -> int:
        return self._intern(self._name_ids, self._names, name)

    def cat_id(self, cat: str) -> int:
        return self._intern(self._cat_ids, self._cats, cat)

    def register_ring(self) -> _ThreadRing:
        ring = _ThreadRing(self.capacity_per_thread)
        with self._lock:
            self._rings.append(ring)
        return ring

    def _snapshot_rings(self) -> List[_ThreadRing]:
        with self._lock:
            return list(self._rings)

    # ------------------------------------------------------------- clock
    def _to_wall(self):
        """A map of ``perf_counter_ns`` stamps (arrays) onto the profiler's
        clock: linear between the anchor taken when the recorder was made
        and one taken now."""
        w0, p0 = self.anchor
        w1, p1 = _clock_pair()
        rate = (w1 - w0) / (p1 - p0) if p1 > p0 else 1.0
        return lambda perf_ns: w0 + np.rint((perf_ns - p0) * rate).astype(np.int64)

    # ------------------------------------------------------------- drain
    @property
    def dropped(self) -> int:
        return sum(r.dropped for r in self._snapshot_rings())

    def lost(self, start_ns: int) -> int:
        """Events overwritten that may have ended at or after ``start_ns``
        (profiler clock): the drops of every ring whose oldest surviving
        event ended after it (a ring holds events in the order they
        ended, so its drops ended before that one)."""
        to_wall, n = self._to_wall(), 0
        for ring in self._snapshot_rings():
            if ring.dropped:
                _, ev = ring.ordered()
                if int(to_wall(ev["ts"][:1])[0] + ev["dur"][0]) > start_ns:
                    n += ring.dropped
        return n

    def spans(self, start_ns: int, end_ns: int) -> List[SpanRecord]:
        """Every complete span that overlaps ``[start_ns, end_ns)`` on the
        profiler's clock, clipped to it, ordered by start.  A span's
        length is its measured duration, as ``duration_s`` gives it."""
        to_wall, out = self._to_wall(), []
        for ring in self._snapshot_rings():
            slots, ev = ring.ordered()
            start = to_wall(ev["ts"])
            end = start + ev["dur"]
            keep = np.nonzero((ev["ph"] == _PH_COMPLETE) & (end > start_ns)
                              & (start < end_ns))[0]
            for k in keep:
                out.append(SpanRecord(
                    self._names[int(ev["name"][k])],
                    max(int(start[k]), start_ns), min(int(end[k]), end_ns),
                    int(ev["id"][k]), int(ev["parent"][k]),
                    ring.args_buf[int(slots[k])],
                ))
        out.sort(key=lambda s: s.start)
        return out

    def drain(self) -> List[dict]:
        """All recorded events as Chrome trace-event dicts, sorted by
        timestamp.  ``ts`` is microseconds since the Unix epoch on the
        profiler's clock, ``dur`` microseconds (Perfetto's native unit)."""
        to_wall, out = self._to_wall(), []
        for ring in self._snapshot_rings():
            slots, ev = ring.ordered()
            wall = to_wall(ev["ts"])
            for k, e in enumerate(ev):
                evt: Dict[str, Any] = {
                    "name": self._names[int(e["name"])],
                    "cat": self._cats[int(e["cat"])] or "default",
                    "ph": _PH_CHARS[int(e["ph"])],
                    "ts": int(wall[k]) / 1000.0,
                    "pid": self.pid,
                    "tid": ring.tid,
                    "id": int(e["id"]),
                    "parent": int(e["parent"]),
                }
                if evt["ph"] == "X":
                    evt["dur"] = int(e["dur"]) / 1000.0
                else:
                    evt["s"] = "t"  # thread-scoped instant
                a = ring.args_buf[int(slots[k])]
                if a is not None:
                    evt["args"] = dict(a)
                out.append(evt)
        out.sort(key=lambda e: e["ts"])
        return out

    def thread_metadata(self) -> List[dict]:
        return [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": self.pid,
                "tid": r.tid,
                "args": {"name": r.tname},
            }
            for r in self._snapshot_rings()
        ]

    def to_chrome(self) -> dict:
        return {
            "traceEvents": self.thread_metadata() + self.drain(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def export_chrome(self, path: str) -> dict:
        """Write the trace as Chrome trace-event JSON and return it."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


# ---------------------------------------------------------------- spans
class Span:
    """A reusable timed region.  ``duration_s`` is valid after exit in
    *both* modes — callers' statistics are fed from it — while the ring
    event is recorded only when recording at acquisition."""

    __slots__ = ("name", "cat", "args", "_record", "_t0", "_id", "_parent",
                 "duration_s")

    def __init__(self):
        self.name = ""
        self.cat = ""
        self.args: Optional[dict] = None
        self._record = False
        self._t0 = 0
        self._id = 0
        self._parent = 0
        self.duration_s = 0.0

    def __enter__(self) -> "Span":
        if self._record:
            self._id = next(_ids)
            self._parent = _tls.top
            _tls.top = self._id
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t0 = self._t0
        dur = time.perf_counter_ns() - t0
        self.duration_s = dur * 1e-9
        if self._record:
            _tls.top = self._parent
            if enabled():
                _ring().push(
                    _recorder.name_id(self.name),
                    _recorder.cat_id(self.cat),
                    _PH_COMPLETE,
                    t0,
                    dur,
                    self._id,
                    self._parent,
                    self.args,
                )
        _tls.pool.append(self)


class _NoopSpan:
    """Shared zero-cost stand-in returned by :func:`span` when not
    recording.  ``duration_s`` is always 0 — callers that need the
    measurement regardless use :func:`timed`."""

    __slots__ = ()
    duration_s = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NOOP = _NoopSpan()


class _Tls(threading.local):
    def __init__(self):
        self.pool: List[Span] = []
        self.ring: Optional[_ThreadRing] = None
        self.gen = -1
        self.top = 0  # id of the innermost open recorded span


_tls = _Tls()
_enabled = False
_session = False  # the recorder belongs to the running profiler session
_recorder: Optional[TraceRecorder] = None
_generation = 0
_state_lock = threading.Lock()
_ids = itertools.count(1)


def _begin_session() -> None:
    global _recorder, _generation, _session
    with _state_lock:
        if not _session:
            _recorder = TraceRecorder(DEFAULT_RING_CAPACITY)
            _generation += 1
            _session = True


def enabled() -> bool:
    """Whether events are recorded now (callers build ``args`` only
    then): after :func:`enable`, or while a ``torch.profiler`` session is
    collecting."""
    global _session
    if _enabled:
        return True
    if _autograd_profiler._is_profiler_enabled:
        if not _session:
            _begin_session()
        return True
    _session = False
    return False


def _ring() -> _ThreadRing:
    if _tls.gen != _generation or _tls.ring is None:
        _tls.ring = _recorder.register_ring()
        _tls.gen = _generation
    return _tls.ring


def _acquire(name: str, cat: str, args, record: bool) -> Span:
    pool = _tls.pool
    sp = pool.pop() if pool else Span()
    sp.name = name
    sp.cat = cat
    sp.args = args
    sp._record = record
    return sp


def span(name: str, cat: str = "", args: Optional[dict] = None):
    """Trace a region.  No-op singleton (zero allocation) when not
    recording — use where the duration is only needed for the trace."""
    if not enabled():
        return _NOOP
    return _acquire(name, cat, args, True)


def timed(name: str, cat: str = "", args: Optional[dict] = None) -> Span:
    """Trace a region whose ``duration_s`` the caller consumes.  Always
    measures on the monotonic clock; records a trace event only while
    recording.  Spans come from a per-thread freelist, so the steady
    state allocates nothing in either mode."""
    return _acquire(name, cat, args, enabled())


def instant(name: str, cat: str = "", args: Optional[dict] = None) -> None:
    """Record a point event (retry, hedge, fault injection, eviction
    burst...).  Free when not recording: a few flag reads."""
    if not enabled():
        return
    _ring().push(
        _recorder.name_id(name),
        _recorder.cat_id(cat),
        _PH_INSTANT,
        time.perf_counter_ns(),
        0,
        next(_ids),
        _tls.top,
        args,
    )


# ------------------------------------------------------------- control
def enable(capacity_per_thread: int = DEFAULT_RING_CAPACITY) -> TraceRecorder:
    """Start recording into a fresh :class:`TraceRecorder`."""
    global _enabled, _recorder, _generation
    with _state_lock:
        _recorder = TraceRecorder(capacity_per_thread)
        _generation += 1
        _enabled = True
    return _recorder


def disable() -> Optional[TraceRecorder]:
    """Stop recording.  The recorder (and its events) stay drainable."""
    global _enabled
    with _state_lock:
        _enabled = False
    return _recorder


def get_recorder() -> Optional[TraceRecorder]:
    return _recorder


def window_spans(start_ns: int, end_ns: int) -> Optional[List[SpanRecord]]:
    """The current recorder's spans in ``[start_ns, end_ns)`` on the
    profiler's clock (:meth:`TraceRecorder.spans`); None where there is
    no recorder, or where its rings overwrote events the window may have
    held."""
    rec = _recorder
    if rec is None or rec.lost(start_ns):
        return None
    return rec.spans(start_ns, end_ns)


class tracing:
    """``with trace.tracing() as rec:`` — enable for a scope (tests,
    benchmarks), disabling on exit with the recorder still drainable."""

    def __init__(self, capacity_per_thread: int = DEFAULT_RING_CAPACITY):
        self.capacity_per_thread = capacity_per_thread
        self.recorder: Optional[TraceRecorder] = None

    def __enter__(self) -> TraceRecorder:
        self.recorder = enable(self.capacity_per_thread)
        return self.recorder

    def __exit__(self, exc_type, exc, tb) -> None:
        disable()
