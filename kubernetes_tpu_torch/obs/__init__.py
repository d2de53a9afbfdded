"""Observability hooks. This slice has the trace-event ring (tracebuf.py) that
the rebalancer and the fault injector tap; the flight recorder, time series
and resource sampler of the JAX package's `obs/` come with ROADMAP.md queue 1
item 7. Import from the modules."""
