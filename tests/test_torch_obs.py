"""The port's trace recorder (``repro_torch.obs.trace``): its spans lie on
the profiler's clock, it records after ``enable()`` or under a
``torch.profiler`` session and not otherwise, it puts nothing on
Kineto's timeline, and its spans form a tree that a request's id joins.
"""
import threading
import time

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.obs import trace

WIDE = (0, 2 ** 63 - 1)  # a window holding every span


@pytest.fixture(autouse=True)
def _off():
    trace.disable()
    yield
    trace.disable()


def _kineto(prof):
    """(name, start ns, end ns) of every event of a finished profile."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _probe():
    """A program span inside a ``record_function`` range around a 5 ms
    sleep: (the probe's Kineto range, the program span).  A span before
    it makes the session's ring, so the probe's edges time the clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test/first"):
            pass
        with record_function("probe"):
            with trace.span("test/probe", "test"):
                time.sleep(0.005)
    assert not trace.enabled()  # and the recorder has seen the session end
    (probe,) = [e for e in _kineto(prof) if e[0] == "probe"]
    (mine,) = [s for s in trace.get_recorder().spans(*WIDE) if s.name == "test/probe"]
    return probe, mine


def test_spans_lie_on_the_profilers_clock():
    """Each edge of the program span lies inside the probe's range, on
    every trial, and within 0.5 ms of it on one of three (a preempted
    thread only widens the gap; the clock the recorder replaced, the
    monotonic one, is ~1.8e9 s out)."""
    _probe()  # warm-up: the first profile of a process starts late
    gaps = []
    for _ in range(3):
        (_, p0, p1), mine = _probe()
        assert p0 <= mine.start < mine.end <= p1
        gaps.append(max(mine.start - p0, p1 - mine.end))
    assert min(gaps) < 500_000, gaps


def test_records_only_when_enabled_or_under_a_profiler():
    before = trace.get_recorder()
    assert not trace.enabled()
    assert trace.span("test/off") is trace.span("test/other")  # the shared no-op
    with trace.span("test/off"):
        pass
    trace.instant("test/off_instant")
    assert trace.get_recorder() is before
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.enabled()
        with trace.span("test/on", "test", args={"k": 1}):
            trace.instant("test/on_instant")
    rec = trace.get_recorder()
    assert rec is not before
    assert {e["name"] for e in rec.drain()} == {"test/on", "test/on_instant"}
    with trace.span("test/after"):  # the session is over
        pass
    assert not trace.enabled()
    assert {e["name"] for e in rec.drain()} == {"test/on", "test/on_instant"}


def test_each_profiler_session_gets_a_fresh_recorder():
    recs = []
    for name in ("test/first", "test/second"):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span(name):
                pass
        recs.append(trace.get_recorder())
        with trace.span("test/between"):  # off: the session's end is seen
            pass
    assert recs[0] is not recs[1]
    assert [s.name for s in recs[1].spans(*WIDE)] == ["test/second"]


def test_program_spans_put_nothing_on_kinetos_timeline():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test/outer"):
            with trace.timed("test/inner"):
                time.sleep(0.001)
    names = {e[0] for e in _kineto(prof)}
    assert not names & {"test/outer", "test/inner"}
    assert {s.name for s in trace.get_recorder().spans(*WIDE)} == {"test/outer", "test/inner"}


def test_timed_measures_when_off_and_records_its_own_duration_when_on():
    with trace.timed("test/t") as sp:
        time.sleep(0.002)
    assert sp.duration_s >= 0.002
    rec = trace.enable()
    with trace.timed("test/t") as sp:
        time.sleep(0.002)
    (got,) = rec.spans(*WIDE)
    assert got.end - got.start == round(sp.duration_s * 1e9)
    (evt,) = [e for e in rec.drain() if e["name"] == "test/t"]
    assert abs(evt["ts"] / 1e6 - time.time()) < 60  # epoch microseconds


def test_parents_follow_nesting_per_thread_and_rid_joins_a_request():
    rec = trace.enable()

    def request(rid):
        with trace.span("test/request", args={"rid": rid}):
            with trace.span("test/step", args={"rid": rid}):
                with trace.span("test/sync"):
                    time.sleep(0.001)
            trace.instant("test/mark", args={"rid": rid})

    threads = [threading.Thread(target=request, args=(rid,)) for rid in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    spans = rec.spans(*WIDE)
    by_id = {s.id: s for s in spans}
    assert len(by_id) == 6
    for rid in (1, 2):
        (top,) = [s for s in spans if s.name == "test/request" and s.args["rid"] == rid]
        (step,) = [s for s in spans if s.parent == top.id]
        (sync,) = [s for s in spans if s.parent == step.id]
        assert top.parent == 0 and step.name == "test/step" and step.args["rid"] == rid
        assert sync.name == "test/sync" and top.start <= step.start <= sync.start
        assert sync.end <= step.end <= top.end
    marks = [e for e in rec.drain() if e["name"] == "test/mark"]
    assert sorted(by_id[m["parent"]].args["rid"] for m in marks) == [1, 2]
    assert all(by_id[m["parent"]].name == "test/request" for m in marks)


def test_spans_are_clipped_to_the_window():
    rec = trace.enable()
    with trace.span("test/long"):
        time.sleep(0.004)
    (whole,) = rec.spans(*WIDE)
    mid = (whole.start + whole.end) // 2
    (clipped,) = rec.spans(mid, mid + 1_000)
    assert (clipped.start, clipped.end) == (mid, mid + 1_000)
    assert rec.spans(whole.end, whole.end + 10) == []


def test_a_window_whose_events_were_overwritten_has_no_reading():
    rec = trace.enable(capacity_per_thread=4)
    for _ in range(10):
        with trace.span("test/s"):
            time.sleep(0.001)
    assert rec.dropped == 6
    kept = rec.spans(*WIDE)
    assert len(kept) == 4
    assert trace.window_spans(*WIDE) is None
    after = kept[0].end + 100_000  # the drops all ended before the oldest kept span
    assert [s.id for s in trace.window_spans(after, WIDE[1])] == [s.id for s in kept[1:]]
