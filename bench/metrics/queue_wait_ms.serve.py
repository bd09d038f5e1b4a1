"""Milliseconds a request waited in the engine's queue: the mean of the
``queued_s`` the engine stamps on each admission (``serve/admit``: its
clock when the admission starts less the request's arrival) over the
admissions that start in the traced span."""
from repro_torch.obs import trace


def read(run):
    tr = run.get("trace")
    window_spans = getattr(trace, "window_spans", None)
    if run["kind"] != "serve" or tr is None or window_spans is None:
        return None
    spans = window_spans(tr.start, tr.end)
    if spans is None:
        return None
    waits = [s.args["queued_s"] for s in spans
             if s.name == "serve/admit" and s.start > tr.start and s.args]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
