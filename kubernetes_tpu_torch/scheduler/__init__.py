"""L4 — the scheduler: store-event loop, cache, queue, batch scheduler, gang
directory, gang preemption and the background rebalancer.

Import the schedulers from their modules (`scheduler.batch.BatchScheduler`);
this package init stays import-free so `snapshot/` can import the framework
types without a cycle (the JAX package exports no rebalancer name here
either: `scheduler.rebalance.Rebalancer`).
"""
