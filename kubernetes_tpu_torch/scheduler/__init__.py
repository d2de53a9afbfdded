"""L4 — the scheduler: store-event loop, cache, queue, batch scheduler, gang
directory and gang preemption.

Import the schedulers from their modules (`scheduler.batch.BatchScheduler`);
this package init stays import-free so `snapshot/` can import the framework
types without a cycle.
"""
