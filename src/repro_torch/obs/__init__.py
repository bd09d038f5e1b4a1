"""Observability of the port: the trace recorder, the metrics registry
and the model-vs-measured drift report (``repro.obs.metrics`` and
``repro.obs.drift`` copied, less what the port never reads; the recorder
is ``repro.obs.trace``'s, on the profiler's clock, recording under a
``torch.profiler`` session too, with a span tree).  The serve engine
emits spans and instants, the record store's and the tier's I/O counters
feed the registry, and the training launcher builds the drift report."""
