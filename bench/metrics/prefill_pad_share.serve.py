"""The share of the prefills' positions that were padding: the sum of
``padded - tokens`` over the sum of ``padded``, from the counts the engine
puts on its ``serve/prefill`` spans (the prompt's length and the capacity
the prefill ran at), over the prefills wholly inside the traced span, %."""
from repro_torch.obs import trace


def read(run):
    tr = run.get("trace")
    window_spans = getattr(trace, "window_spans", None)
    if run["kind"] != "serve" or tr is None or window_spans is None:
        return None
    spans = window_spans(tr.start, tr.end)
    if spans is None:
        return None
    counts = [(s.args["padded"], s.args["tokens"]) for s in spans
              if s.name == "serve/prefill" and tr.start < s.start and s.end < tr.end and s.args]
    padded = sum(p for p, _ in counts)
    if not padded:
        return None
    return 100.0 * sum(p - t for p, t in counts) / padded
