"""Server-side telemetry. This slice has the metric primitives and the
store's series (metrics.py); the REST server, watch mux and /metrics
endpoint come with ROADMAP.md queue 1 item 7g. Import from the modules."""
