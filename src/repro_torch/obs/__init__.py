"""Observability of the port: the trace recorder, the metrics registry
and the model-vs-measured drift report (copies of ``repro.obs.trace``,
``repro.obs.metrics`` and ``repro.obs.drift``; the serve engine emits
spans and instants, the record store's and the tier's I/O counters feed
the registry, and the training launcher builds the drift report)."""
