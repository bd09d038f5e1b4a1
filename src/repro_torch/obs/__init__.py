"""Observability of the port: the trace recorder (a copy of
``repro.obs.trace``; the serve engine emits its spans and instants)."""
