"""The device trace of a traced run, from ``torch.profiler``.

``Traced`` profiles the card and the host from the start of the measured
window for ``seconds`` (the mix's ``trace_seconds``), then stops collecting
the host's operations (the device's go on, and are cut off at the span's
end when read: pausing the device's collection loses its events); the
profile is read after the window has closed.  The traced span is the range of the
``bench/traced`` marker on the host's clock, which the profiler shares
with the device's events.  The raw Kineto events are read directly: the
profiler's own event tree costs about 0.1 ms an event to build.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

MARK = "bench/traced"


class Traced:
    """Profile while ``active``; ``pause()`` ends the traced span."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled, self.seconds = enabled, seconds
        self.prof = None
        self._mark = None
        self.t0 = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._mark = torch.profiler.record_function(MARK)
            self._mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    @property
    def active(self) -> bool:
        return self._mark is not None

    def due(self) -> bool:
        """Whether the traced span has lasted its ``seconds``."""
        return self.active and time.perf_counter() - self.t0 >= self.seconds

    def pause(self) -> None:
        if not self.active:
            return
        from torch.profiler import ProfilerActivity

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._mark = None
        self.prof.toggle_collection_dynamic(False, [ProfilerActivity.CPU])

    def __exit__(self, *exc):
        if self.prof is not None:
            self.pause()
            self.prof.__exit__(*exc)
        return False

    def events(self) -> "Trace":
        return Trace.read(self.prof)


class Trace:
    """Device and host events of the traced span (ns on one clock)."""

    def __init__(self, device: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]],
                 start: int, end: int):
        self.device, self.host, self.start, self.end = device, host, start, end

    @classmethod
    def read(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        device, host, span = [], [], None
        for e in prof.profiler.kineto_results.events():
            item = (e.name(), e.start_ns(), e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                if item[0] != MARK:  # the marker's own range on the device's timeline
                    device.append(item)
            else:
                host.append(item)
                if item[0] == MARK:
                    span = item
        if span is None:
            raise RuntimeError(f"the trace holds no {MARK!r} range")
        start, end = span[1], span[1] + span[2]
        device = sorted(((n, max(s, start), min(s + d, end) - max(s, start))
                         for n, s, d in device if s < end and s + d > start), key=lambda x: x[1])
        return cls(device, host, start, end)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, d in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_s(self, fragment: str) -> Optional[float]:
        """Device seconds of the kernels whose name holds ``fragment``;
        None where none ran."""
        ts = [d for n, _, d in self.device if fragment in n]
        return sum(ts) / 1e9 if ts else None

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, int] = {}
        for name, _, d in self.device:
            tot[name] = tot.get(name, 0) + d
        return [[k[:160], v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest spans with nothing on the device, each named
        by the innermost host operation running at its middle."""
        edges = [self.start] + [x for iv in self.busy_intervals() for x in iv] + [self.end]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for length, at in gaps:
            mid = at + length // 2
            best = None
            for name, s, d in self.host:
                if name != MARK and s <= mid <= s + d and (best is None or s > best[1]):
                    best = (name, s)
            out.append([best[0][:160] if best else "host: no operation", length / 1e9])
        return out
