"""Metrics registry: counters and log-bucketed latency histograms.

One registry absorbs the stack's scattered counter structs — ``IOStats``
(storage), ``TieredCache`` / ``LookaheadScheduler`` /
``PrefetchingFetcher`` (DRAM tier), ``FaultLog`` (injection),
``RemoteFetcher`` / ``Cluster`` (cross-host tier), ``PipelineStats``
(Eq. 1) — behind a single snapshot/delta API:

* **Own metrics**: :meth:`MetricsRegistry.counter` /
  ``histogram`` create-or-get named instruments.  Histograms are
  log₂-bucketed from 1 µs (bucket *k* holds observations under
  ``1 µs · 2^k``) — wide enough for a DRAM gather and an HDD seek on the
  same axis, 30 buckets, fixed memory.
* **Collectors**: :meth:`register_collector` attaches a pull-time
  closure returning ``{name: value}``; the ``bind_*`` helpers wrap the
  existing structs (via ``IOStats.snapshot()`` for torn-read-free
  storage counters).  Collected values appear in every snapshot under
  the collector's prefix, so the five structs read as one namespace.
* **Snapshot/delta**: :meth:`snapshot` is a point-in-time dict;
  :func:`delta` subtracts two snapshots (counters and histogram buckets
  difference) — steady-state rates without resetting any counter
  mid-run.  Snapshots are plain JSON-serializable dicts.

The hot path is one lock acquisition per observation at batch
granularity (the repo-wide discipline: no per-record Python), so the
registry's cost is unmeasurable next to a batch read —
``benchmarks/obs_overhead.py`` gates exactly that claim.
"""
from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List

import numpy as np

# Histogram buckets: upper bounds 1us * 2^k.  30 buckets reach ~9 min.
HIST_BASE_S = 1e-6
HIST_BUCKETS = 30


class Counter:
    """Monotonic float counter."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Log₂-bucketed latency histogram (seconds).

    ``observe(dt)`` lands in the bucket whose upper bound is the first
    power-of-two multiple of 1 µs above ``dt``; the last bucket is
    +Inf.  Bucketing is a ``bit_length`` — no search, no allocation."""

    __slots__ = ("name", "help", "_lock", "counts", "sum", "count")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self.counts = np.zeros(HIST_BUCKETS, dtype=np.int64)
        self.sum = 0.0
        self.count = 0

    @staticmethod
    def bucket_index(seconds: float) -> int:
        if seconds <= HIST_BASE_S:
            return 0
        # relative epsilon: exact boundary values (k µs · 2^j) must land
        # in bucket j even when the division picks up half-ulp error
        return min(
            HIST_BUCKETS - 1,
            int(seconds / HIST_BASE_S * (1.0 - 1e-12)).bit_length(),
        )

    def observe(self, seconds: float) -> None:
        i = self.bucket_index(seconds)
        with self._lock:
            self.counts[i] += 1
            self.sum += seconds
            self.count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": int(self.count),
                "sum": float(self.sum),
                "buckets": [int(c) for c in self.counts],
            }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._collectors: List[tuple] = []  # (prefix, fn)

    # --------------------------------------------------- create-or-get
    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, help)
            return c

    def histogram(self, name: str, help: str = "") -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, help)
            return h

    def register_collector(
        self, prefix: str, fn: Callable[[], Dict[str, float]]
    ) -> None:
        """``fn()`` is called at snapshot time; its ``{name: value}``
        result appears under ``{prefix}/``.  Collectors make the
        existing counter structs (IOStats, TieredCache, ...) part of
        the registry without moving a single hot-path increment."""
        with self._lock:
            self._collectors.append((prefix, fn))

    # ------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._histograms)
            collectors = list(self._collectors)
        snap = {
            "counters": {n: c.value for n, c in counters.items()},
            "histograms": {n: h.snapshot() for n, h in hists.items()},
        }
        for prefix, fn in collectors:
            for k, v in fn().items():
                snap["counters"][f"{prefix}/{k}"] = float(v)
        return snap

    def to_json(self, **dump_kw) -> str:
        return json.dumps(self.snapshot(), **dump_kw)


def delta(new: dict, old: dict) -> dict:
    """Snapshot difference: counters and histogram buckets subtract.
    Gives steady-state windows (e.g. the
    warm epochs of a run) without resetting live counters."""
    out = {
        "counters": {
            k: v - old.get("counters", {}).get(k, 0.0)
            for k, v in new.get("counters", {}).items()
        },
        "histograms": {},
    }
    for name, h in new.get("histograms", {}).items():
        o = old.get("histograms", {}).get(
            name, {"count": 0, "sum": 0.0, "buckets": [0] * len(h["buckets"])}
        )
        out["histograms"][name] = {
            "count": h["count"] - o["count"],
            "sum": h["sum"] - o["sum"],
            "buckets": [a - b for a, b in zip(h["buckets"], o["buckets"])],
        }
    return out


# ------------------------------------------------------------ binders
# Duck-typed: each takes the live struct and registers a pull-time
# collector, so the registry absorbs the existing counters without any
# import cycle (obs imports nothing from storage/prefetch) and without
# touching a hot-path increment.

def _num_fields(obj, names) -> Dict[str, float]:
    return {n: float(getattr(obj, n)) for n in names if hasattr(obj, n)}


def bind_store(registry: MetricsRegistry, store, prefix: str = "storage") -> None:
    """Absorb ``RecordStore.stats`` (an ``IOStats``) via its atomic
    ``snapshot()`` — the registry never sees a torn multi-field view."""
    stats = getattr(store, "stats", store)
    registry.register_collector(
        prefix, lambda: {k: float(v) for k, v in stats.snapshot().items()}
    )


def bind_cache(registry: MetricsRegistry, cache, prefix: str = "cache") -> None:
    fields = (
        "hits", "misses", "hit_bytes", "insertions", "evictions",
        "rejected", "planned_skips", "planned_skip_bytes", "stray_unpins",
        "invalidations", "scratch_copies", "scratch_copy_bytes",
        "remote_served", "remote_served_bytes", "remote_released",
        "used_bytes", "budget_bytes",
    )
    registry.register_collector(prefix, lambda: _num_fields(cache, fields))


def bind_scheduler(
    registry: MetricsRegistry, scheduler, prefix: str = "scheduler"
) -> None:
    fields = (
        "admitted_records", "window_hits", "window_hit_bytes",
        "planned_records", "planned_bytes", "doomed_records", "doomed_bytes",
    )
    registry.register_collector(prefix, lambda: _num_fields(scheduler, fields))


def bind_fetcher(
    registry: MetricsRegistry, fetcher, prefix: str = "prefetch"
) -> None:
    """Absorb a ``PrefetchingFetcher`` and its cache + scheduler."""
    fields = (
        "prefetch_batches", "prefetch_records", "prefetch_remote_records",
        "demand_remote_records", "probe_skips", "probe_skip_bytes",
        "plans_failed", "worker_restarts", "plan_waits_timed_out",
    )
    registry.register_collector(prefix, lambda: _num_fields(fetcher, fields))
    if getattr(fetcher, "cache", None) is not None:
        bind_cache(registry, fetcher.cache, f"{prefix}/cache")
    if getattr(fetcher, "scheduler", None) is not None:
        bind_scheduler(registry, fetcher.scheduler, f"{prefix}/scheduler")


def bind_fault_log(
    registry: MetricsRegistry, log, prefix: str = "faults"
) -> None:
    fields = (
        "transients", "zero_reads", "short_reads", "bitflips", "stalls",
        "eio_hits",
    )
    registry.register_collector(prefix, lambda: _num_fields(log, fields))


def bind_pipeline(
    registry: MetricsRegistry, pipeline, prefix: str = "pipeline"
) -> None:
    stats = getattr(pipeline, "stats", pipeline)

    def collect() -> Dict[str, float]:
        return {
            "t_load_s": stats.t_load,
            "t_comp_s": stats.t_comp,
            "t_wait_s": stats.t_wait,
            "t_overlap_s": stats.t_overlap,
            "batches": float(stats.batches),
        }

    registry.register_collector(prefix, collect)


def bind_cluster(
    registry: MetricsRegistry, cluster, prefix: str = "cluster"
) -> None:
    """Fleet-wide aggregates from a ``repro_torch.prefetch.distributed``
    cluster (uses its own ``aggregate_io()`` roll-up)."""
    registry.register_collector(
        prefix,
        lambda: {
            k: float(v)
            for k, v in cluster.aggregate_io().items()
            if isinstance(v, (int, float))
        },
    )


# --------------------------------------------------- default registry
_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry the built-in instrumentation
    (pread latency, peer RTT, batch assembly histograms) records into."""
    return _default


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh default registry (tests, benchmark isolation)."""
    global _default
    _default = MetricsRegistry()
    return _default


def observe(name: str, seconds: float) -> None:
    """Observe into histogram ``name`` of the *current* default registry
    (resolved per call, so :func:`reset_registry` takes effect
    everywhere).  This is the one helper instrumented hot paths call —
    at batch granularity only."""
    _default.histogram(name).observe(seconds)
