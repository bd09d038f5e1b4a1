"""Low-overhead trace recorder: spans + instants → Chrome trace JSON.

Design constraints:

* **No locks on the hot path.**  Each thread records into its own
  preallocated ring buffer (a NumPy structured array plus a parallel
  ``args`` slot list); the only lock is taken once per thread at ring
  registration and once per *new* event name at interning.  Ring slots
  wrap: when a ring fills, the oldest events are overwritten and counted
  in ``dropped`` — recording never blocks and never grows memory.
* **Compiled out when disabled.**  The module-level ``_enabled`` flag
  gates everything: :func:`span` returns a shared no-op singleton
  (zero allocation, two trivial method calls), :func:`instant` returns
  immediately.  :func:`timed` is the one variant that *always* measures
  (``time.perf_counter_ns``) because callers feed its duration into
  pipeline statistics — it still records an event only when enabled,
  and reuses spans from a per-thread freelist so the steady state
  allocates nothing in either mode.
* **Monotonic clocks.**  All timestamps come from
  ``time.perf_counter_ns`` — the same clock the pipeline's Eq. 1
  accounting uses, so traces and stats can never disagree.

Export is the Chrome trace-event format (``{"traceEvents": [...]}``):
open the file in https://ui.perfetto.dev or ``chrome://tracing``.
Spans are complete events (``ph: "X"``) with microsecond ``ts``/``dur``;
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

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

# Event record: interned name/cat ids, phase, ns timestamp + duration.
_EVENT_DTYPE = np.dtype(
    [
        ("name", np.uint32),
        ("cat", np.uint32),
        ("ph", np.uint8),
        ("ts", np.int64),
        ("dur", np.int64),
    ]
)
_PH_COMPLETE = 0  # Chrome "X"
_PH_INSTANT = 1  # Chrome "i"
_PH_CHARS = {_PH_COMPLETE: "X", _PH_INSTANT: "i"}

DEFAULT_RING_CAPACITY = 65536


class _ThreadRing:
    """One thread's preallocated event ring.  Only the owning thread
    writes; :meth:`events` (drain/export) reads from any thread and is
    *nearly* consistent — export at quiesce points for exact traces."""

    __slots__ = ("events_buf", "args_buf", "capacity", "idx", "tid", "tname")

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.events_buf = np.zeros(capacity, dtype=_EVENT_DTYPE)
        self.args_buf: List[Optional[dict]] = [None] * capacity
        self.idx = 0  # monotonically increasing write position
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.tname = t.name

    def push(self, nid: int, cid: int, ph: int, ts: int, dur: int, args):
        i = self.idx % self.capacity
        self.events_buf[i] = (nid, cid, ph, ts, dur)
        self.args_buf[i] = args
        self.idx += 1

    @property
    def dropped(self) -> int:
        return max(0, self.idx - self.capacity)

    def ordered_slots(self) -> range:
        """Slot positions oldest→newest (handles wraparound)."""
        if self.idx <= self.capacity:
            return range(self.idx)
        return range(self.idx - self.capacity, self.idx)


class TraceRecorder:
    """Process-wide recorder: interning tables + the set of thread rings."""

    def __init__(self, capacity_per_thread: int = DEFAULT_RING_CAPACITY):
        self.capacity_per_thread = capacity_per_thread
        self.t0_ns = time.perf_counter_ns()
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

    # ------------------------------------------------------------- drain
    @property
    def dropped(self) -> int:
        with self._lock:
            rings = list(self._rings)
        return sum(r.dropped for r in rings)

    def drain(self) -> List[dict]:
        """All recorded events as Chrome trace-event dicts, sorted by
        timestamp.  ``ts``/``dur`` are microseconds relative to
        :func:`enable` time (Perfetto's native unit)."""
        with self._lock:
            rings = list(self._rings)
        out: List[dict] = []
        for ring in rings:
            buf, args = ring.events_buf, ring.args_buf
            for pos in ring.ordered_slots():
                i = pos % ring.capacity
                e = buf[i]
                evt = {
                    "name": self._names[int(e["name"])],
                    "cat": self._cats[int(e["cat"])] or "default",
                    "ph": _PH_CHARS[int(e["ph"])],
                    "ts": (int(e["ts"]) - self.t0_ns) / 1000.0,
                    "pid": self.pid,
                    "tid": ring.tid,
                }
                if evt["ph"] == "X":
                    evt["dur"] = int(e["dur"]) / 1000.0
                else:
                    evt["s"] = "t"  # thread-scoped instant
                a = args[i]
                if a is not None:
                    evt["args"] = dict(a)
                out.append(evt)
        out.sort(key=lambda e: e["ts"])
        return out

    def thread_metadata(self) -> List[dict]:
        with self._lock:
            rings = list(self._rings)
        return [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": self.pid,
                "tid": r.tid,
                "args": {"name": r.tname},
            }
            for r in rings
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
    *both* modes — pipeline stats are fed from it — while the ring event
    is recorded only when tracing was enabled at acquisition."""

    __slots__ = ("name", "cat", "args", "_record", "_t0", "duration_s")

    def __init__(self):
        self.name = ""
        self.cat = ""
        self.args: Optional[dict] = None
        self._record = False
        self._t0 = 0
        self.duration_s = 0.0

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t0 = self._t0
        dur = time.perf_counter_ns() - t0
        self.duration_s = dur * 1e-9
        if self._record and _enabled:
            _ring().push(
                _recorder.name_id(self.name),
                _recorder.cat_id(self.cat),
                _PH_COMPLETE,
                t0,
                dur,
                self.args,
            )
        _tls.pool.append(self)


class _NoopSpan:
    """Shared zero-cost stand-in returned by :func:`span` when tracing
    is disabled.  ``duration_s`` is always 0 — callers that need the
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


_tls = _Tls()
_enabled = False
_recorder: Optional[TraceRecorder] = None
_generation = 0
_state_lock = threading.Lock()


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
    """Trace a region.  No-op singleton (zero allocation) when tracing
    is disabled — use where the duration is only needed for the trace."""
    if not _enabled:
        return _NOOP
    return _acquire(name, cat, args, True)


def timed(name: str, cat: str = "", args: Optional[dict] = None) -> Span:
    """Trace a region whose ``duration_s`` the caller consumes (pipeline
    Eq. 1 accounting).  Always measures on the monotonic clock; records
    a trace event only when enabled.  Spans come from a per-thread
    freelist, so the steady state allocates nothing in either mode."""
    return _acquire(name, cat, args, _enabled)


def instant(name: str, cat: str = "", args: Optional[dict] = None) -> None:
    """Record a point event (retry, hedge, fault injection, eviction
    burst...).  Free when disabled: one global flag check."""
    if not _enabled:
        return
    _ring().push(
        _recorder.name_id(name),
        _recorder.cat_id(cat),
        _PH_INSTANT,
        time.perf_counter_ns(),
        0,
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


def resume() -> TraceRecorder:
    """Re-enable recording into the *existing* recorder (fresh one only
    if none exists yet).  Unlike :func:`enable` this keeps every
    thread's already-faulted ring, so toggling around a measured region
    costs a flag flip, not a ring reallocation."""
    global _enabled, _recorder, _generation
    with _state_lock:
        if _recorder is None:
            _recorder = TraceRecorder(DEFAULT_RING_CAPACITY)
            _generation += 1
        _enabled = True
    return _recorder


def enabled() -> bool:
    return _enabled


def get_recorder() -> Optional[TraceRecorder]:
    return _recorder


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
