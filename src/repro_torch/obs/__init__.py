"""Observability of the port: the trace recorder and the metrics
registry (copies of ``repro.obs.trace`` and ``repro.obs.metrics``; the
serve engine emits spans and instants, the record store's I/O counters
feed the registry)."""
