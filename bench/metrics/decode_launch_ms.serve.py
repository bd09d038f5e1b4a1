"""Milliseconds the host took to enqueue a decode step: the mean self time
of the engine's ``serve/decode`` spans (their duration less their
``serve/decode/sync`` child's, the next tokens' argmax and copy to the
host) over the decode steps wholly inside the traced span."""
from repro_torch.obs import trace


def read(run):
    tr = run.get("trace")
    window_spans = getattr(trace, "window_spans", None)
    if run["kind"] != "serve" or tr is None or window_spans is None:
        return None
    spans = window_spans(tr.start, tr.end)
    if spans is None:
        return None
    decodes = {s.id: s.end - s.start for s in spans
               if s.name == "serve/decode" and tr.start < s.start and s.end < tr.end}
    for s in spans:
        if s.name == "serve/decode/sync" and s.parent in decodes:
            decodes[s.parent] -= s.end - s.start
    if not decodes:
        return None
    return 1e-6 * sum(decodes.values()) / len(decodes)
