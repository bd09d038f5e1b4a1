"""The share of the traced span of a serving window in which nothing ran
on the device while the host was inside an engine step (the program's
``serve/step`` spans, on the profiler's clock), %.  The rest of
``device_idle_share.serve`` is the loop with no step running: waiting for
arrivals, and the harness between steps."""
from repro_torch.obs import trace


def read(run):
    tr = run.get("trace")
    window_spans = getattr(trace, "window_spans", None)
    if run["kind"] != "serve" or tr is None or window_spans is None or tr.end <= tr.start:
        return None
    spans = window_spans(tr.start, tr.end)
    if spans is None:
        return None
    steps = []  # the union of the steps, ordered
    for s in spans:
        if s.name != "serve/step":
            continue
        if steps and s.start <= steps[-1][1]:
            steps[-1][1] = max(steps[-1][1], s.end)
        else:
            steps.append([s.start, s.end])
    if not steps:
        return None
    busy, j, idle = tr.busy_intervals(), 0, 0
    for a, b in steps:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        idle += (b - a) - covered
    return 100.0 * idle / (tr.end - tr.start)
