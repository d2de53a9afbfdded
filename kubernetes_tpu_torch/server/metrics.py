"""Prometheus-style metric primitives and the store's series.

The counterpart of `kubernetes_tpu/server/metrics.py`: the primitives
(Counter, Gauge, Histogram, LabeledHistogram, GaugeFunc, Registry,
global_registry), the scheduler's series (attempts, batch solve and stage
latency, retries, the breaker state, queue depth and age, submit-to-bound
latency, constraint repair, the partitioned scheduler's conflicts, reroutes
and deaths, gangs, controllers, resource sampling), and the
series the API store records into — the bind_many commit latency, dropped
watch deliveries by reason, the commit-to-dequeue watch propagation
histogram, and the per-subscriber queue-length and delivered-RV-lag gauges
read from live stores at render time. server/rest.py serves the text
exposition at GET /metrics.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple


def escape_label_value(value) -> str:
    """Prometheus text-format label escaping (backslash, double-quote,
    newline — exposition format spec). Pod names and failure messages flow
    into label values, so unescaped quotes/backslashes would corrupt the
    exposition for any real scraper."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(key: Tuple) -> str:
    return ",".join(f'{k}="{escape_label_value(v)}"' for k, v in key)


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                lbl = _render_labels(key)
                out.append(f"{self.name}{{{lbl}}} {v}" if lbl else f"{self.name} {v}")
        return out


class Gauge(Counter):
    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def render(self) -> List[str]:
        out = super().render()
        out[1] = f"# TYPE {self.name} gauge"
        return out


class Histogram:
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 30)

    def __init__(self, name: str, help_: str = "", buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        self._bucket_arr = None  # lazy numpy mirror for bucket_counts
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._total += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def observe_n(self, value: float, n: int) -> None:
        """n observations of ONE value under a single lock acquisition — the
        coalesced-event shape: a CoalescedEvent delivery carries
        len(events) objects that all share the batch's commit stamp, so the
        propagation histogram takes one bucket probe for the whole batch."""
        if n <= 0:
            return
        with self._lock:
            self._sum += value * n
            self._total += n
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += n
                    return
            self._counts[-1] += n

    def counts_snapshot(self) -> Tuple[List[int], float, int]:
        """(bucket counts incl. +Inf, sum, total) under the lock — lets a
        reader merge several same-layout histograms (the per-kind propagation
        children) into one distribution via observe_counts."""
        with self._lock:
            return list(self._counts), self._sum, self._total

    def bucket_counts(self, values):
        """One numpy bucket pass over a chunk of samples WITHOUT mutating
        this histogram: (counts, sum, n) for observe_counts(), so a single
        pass can feed several histograms with identical bucket layouts (the
        tracer's private latency histogram + the process-wide Prometheus
        series — the 100k-pod window must not pay the bucket pass twice).
        Bucket semantics identical to observe(): value <= bound counts into
        that bucket, overflow into +Inf. None for an empty chunk."""
        import numpy as np

        arr = np.asarray(values, dtype=np.float64)
        if arr.size == 0:
            return None
        ba = self._bucket_arr
        if ba is None:
            ba = self._bucket_arr = np.asarray(self.buckets,
                                               dtype=np.float64)
        idx = np.searchsorted(ba, arr, side="left")
        counts = np.bincount(idx, minlength=len(self.buckets) + 1).tolist()
        return counts, float(arr.sum()), int(arr.size)

    def observe_counts(self, counts, total_sum: float, n: int) -> None:
        """Merge a bucket_counts() result — ONE lock acquisition per chunk.
        The caller guarantees the bucket layout matches."""
        with self._lock:
            for i, c in enumerate(counts):
                if c:
                    self._counts[i] += c
            self._sum += total_sum
            self._total += n

    def observe_many(self, values) -> None:
        """Bulk observation: one numpy bucket pass + ONE lock acquisition
        for a whole chunk of samples."""
        res = self.bucket_counts(values)
        if res is not None:
            self.observe_counts(*res)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (the histogram_quantile()
        formula: find the bucket holding rank q*count, interpolate linearly
        inside it). Error is bounded by the bucket width — pick log-spaced
        buckets sized to the tolerance the consumer needs. Values landing in
        the +Inf bucket clamp to the highest finite bound (the PromQL
        convention). None when empty."""
        with self._lock:
            counts = list(self._counts)
            total = self._total
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            cum += c
            if cum >= rank:
                if i >= len(self.buckets):
                    return float(self.buckets[-1]) if self.buckets else 0.0
                lo = float(self.buckets[i - 1]) if i else 0.0
                hi = float(self.buckets[i])
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
        return float(self.buckets[-1]) if self.buckets else 0.0

    def render(self, label: str = "") -> List[str]:
        """Sample lines; `label` is a pre-rendered 'k="v"' prefix merged into
        each line's label set (LabeledHistogram children)."""
        out = ([] if label else
               [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"])
        sep = f"{label}," if label else ""
        suffix = f"{{{label}}}" if label else ""
        with self._lock:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[i]
                out.append(f'{self.name}_bucket{{{sep}le="{b}"}} {cum}')
            out.append(f'{self.name}_bucket{{{sep}le="+Inf"}} {self._total}')
            out.append(f"{self.name}_sum{suffix} {self._sum}")
            out.append(f"{self.name}_count{suffix} {self._total}")
        return out

    def snapshot(self) -> Tuple[float, int]:
        """(sum, count) under the lock — the stats surfaces read these."""
        with self._lock:
            return self._sum, self._total


class LabeledHistogram:
    """A histogram family keyed by ONE label (the reference's HistogramVec
    restricted to the single-label shape every call site here uses). Children
    are created on first observe; exposition merges the label into each
    bucket/sum/count line."""

    def __init__(self, name: str, help_: str = "", label: str = "le_label",
                 buckets: Sequence[float] = Histogram.DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.label = label
        self.buckets = tuple(buckets)
        self._children: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def child(self, value: str) -> Histogram:
        with self._lock:
            got = self._children.get(value)
            if got is None:
                got = self._children[value] = Histogram(
                    self.name, self.help, self.buckets)
            return got

    def observe(self, value: float, label_value: str) -> None:
        self.child(label_value).observe(value)

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        with self._lock:
            children = dict(self._children)
        return {k: h.snapshot() for k, h in children.items()}

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            children = sorted(self._children.items())
        for v, h in children:
            out.extend(h.render(
                label=f'{self.label}="{escape_label_value(v)}"'))
        return out


class GaugeFunc:
    """A gauge whose samples come from a callback at read/render time (the
    reference's GaugeFunc / custom collector shape) — for state that lives in
    another component and would be stale or hot-path-expensive to push (the
    per-subscriber watch queue lengths). The callback returns
    [(labels dict, value), ...]; a raising callback renders nothing rather
    than corrupting the whole /metrics page."""

    def __init__(self, name: str, help_: str = "", fn=None):
        self.name = name
        self.help = help_
        self._fn = fn

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        if self._fn is None:
            return []
        try:
            return list(self._fn())
        except Exception:
            return []

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        for labels, v in self.samples():
            lbl = _render_labels(tuple(sorted(labels.items())))
            out.append(f"{self.name}{{{lbl}}} {v}" if lbl
                       else f"{self.name} {v}")
        return out


class Registry:
    def __init__(self):
        self._metrics: List = []
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._add(Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._add(Gauge(name, help_))

    def gauge_func(self, name: str, help_: str = "", fn=None) -> GaugeFunc:
        return self._add(GaugeFunc(name, help_, fn))

    def histogram(self, name: str, help_: str = "", buckets=Histogram.DEFAULT_BUCKETS) -> Histogram:
        return self._add(Histogram(name, help_, buckets))

    def labeled_histogram(self, name: str, help_: str = "", label: str = "label",
                          buckets=Histogram.DEFAULT_BUCKETS) -> LabeledHistogram:
        return self._add(LabeledHistogram(name, help_, label, buckets))

    def _add(self, m):
        with self._lock:
            self._metrics.append(m)
        return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


global_registry = Registry()

# the scheduler's key series (metrics/metrics.go)
scheduling_attempts = global_registry.counter(
    "scheduler_schedule_attempts_total", "Scheduling attempts by result")
scheduling_attempt_duration = global_registry.histogram(
    "scheduler_scheduling_attempt_duration_seconds", "Scheduling attempt latency")
pending_pods = global_registry.gauge(
    "scheduler_pending_pods", "Pending pods by queue")
batch_solve_duration = global_registry.labeled_histogram(
    "scheduler_batch_solve_duration_seconds",
    "Batch solve latency by outcome", label="outcome")
batch_size_gauge = global_registry.gauge(
    "scheduler_batch_size", "Pods in the last solved batch")

# per-stage timing of the batched schedule->bind->confirm loop (the
# extension-point histograms of framework_duration_seconds, reframed for the
# pipeline stages). Buckets reach down to 100us: most stages of a small
# batch land well under the serial path's 1ms floor.
STAGE_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10)
batch_stage_duration = global_registry.labeled_histogram(
    "scheduler_batch_stage_duration_seconds",
    "Batched pipeline stage latency", label="stage", buckets=STAGE_BUCKETS)

# failure-domain observability: the solver circuit breaker's live state and
# the pipeline's transient-retry volume by stage
solver_breaker_state = global_registry.gauge(
    "scheduler_solver_breaker_state",
    "Solver circuit breaker state (0 closed, 1 half-open, 2 open)")
batch_retries_total = global_registry.counter(
    "scheduler_batch_retries_total",
    "Pods requeued (stage=solve/assume/dispatch/worker) or chunks retried "
    "(stage=bind) on transient pipeline failures, by stage and reason")

# pod-latency observability: queue depth per tier + oldest-pending age
# (updated per pump, never per pod — scheduler/batch.py throttles the depth
# scan), and the aggregate submit->bound latency of EVERY pod, observed in
# bulk per bind chunk from batch-boundary timestamps (scheduler/podtrace.py)
queue_depth = global_registry.gauge(
    "scheduler_queue_depth",
    "Queued pods by tier (active / backoff / unschedulable / gang_staged)")
queue_oldest_age = global_registry.gauge(
    "scheduler_queue_oldest_pending_age_seconds",
    "Age of the oldest pod still waiting in any queue tier")
# log-spaced out to 5 minutes: submit->bound spans queue wait + solve + bind,
# and a chaos/backoff excursion must land in a finite bucket, not +Inf
E2E_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                       0.5, 1, 2.5, 5, 10, 30, 60, 120, 300)
pod_e2e_latency = global_registry.histogram(
    "scheduler_pod_submit_to_bound_seconds",
    "Pod latency from queue admission to committed bind",
    buckets=E2E_LATENCY_BUCKETS)

# store commit latency: one observation per bind_many call (a bind chunk)
# around the two-phase commit
store_bind_many_duration = global_registry.histogram(
    "store_bind_many_duration_seconds",
    "store.bind_many two-phase commit latency per chunk",
    buckets=STAGE_BUCKETS)

# watch-bus telemetry: a chaos watch.deliver drop, a ring overflow or a
# slow-watcher overflow eviction is counted by reason; queue lengths come
# from live stores at render time
store_watch_dropped = global_registry.counter(
    "store_watch_dropped_deliveries_total",
    "Watch deliveries dropped, by reason (chaos injection / overflow "
    "eviction) and kind")

# watch-propagation tracing: commit->delivery latency per kind —
# every event carries its store-commit stamp (shared per batched write) and
# the subscriber's dequeue tap settles the distribution at render time.
# Buckets reach from 100us (in-process same-tick delivery) out to 5 minutes
# (a backlogged subscriber's worst honest lag must land in a finite bucket)
PROPAGATION_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25,
                       0.5, 1, 2.5, 5, 10, 30, 60, 120, 300)
store_watch_propagation = global_registry.labeled_histogram(
    "store_watch_propagation_seconds",
    "Watch event latency from store commit to subscriber dequeue, by kind",
    label="kind", buckets=PROPAGATION_BUCKETS)

_watch_sources: List = []  # weakrefs to APIStores with live watchers
_watch_sources_lock = threading.Lock()


def register_watch_source(ref) -> None:
    """Register a weakref to an APIStore so the subscriber-queue-length
    GaugeFunc can read its watcher list at render time (store/store.py calls
    this on the first watch() subscription)."""
    with _watch_sources_lock:
        if len(_watch_sources) > 64:  # prune dead stores opportunistically
            _watch_sources[:] = [r for r in _watch_sources if r() is not None]
        _watch_sources.append(ref)


def _watch_subscriber_rows():
    """Subscriber rows from every live store — the shared feed of the two
    watch GaugeFuncs below. Uses the subscribers-only telemetry read: one
    scrape must not pay the merged propagation-summary construction twice
    per store just to list subscribers."""
    rows = []
    with _watch_sources_lock:
        refs = list(_watch_sources)
    for ref in refs:
        store = ref()
        if store is None:
            continue
        try:
            rows.extend(store.watch_subscriber_telemetry())
        except Exception:
            continue
    return rows


def _watch_queue_samples():
    return [({"subscriber": sub["id"]}, float(sub["queue_length"]))
            for sub in _watch_subscriber_rows()]


store_watch_queue_length = global_registry.gauge_func(
    "store_watch_subscriber_queue_length",
    "Buffered events per live watch subscriber (read at scrape time)",
    fn=_watch_queue_samples)


def _watch_rv_lag_samples():
    """Delivered-RV lag per live subscriber: how many store
    commits behind each watcher's last DEQUEUED event is — the leading
    indicator of a backlogged informer, read from live stores at render
    time like the queue-length gauge."""
    return [({"subscriber": sub["id"]}, float(sub.get("rv_lag", 0)))
            for sub in _watch_subscriber_rows()]


store_watch_rv_lag = global_registry.gauge_func(
    "store_watch_delivered_rv_lag",
    "Store commits not yet dequeued per live watch subscriber",
    fn=_watch_rv_lag_samples)

# reconcile-loop telemetry: every controller observes ONE duration per
# process() loop (never per key) into this family; workqueue depth comes
# from the live controller registry at render time (obs/reconcile.py)
controller_reconcile_duration = global_registry.labeled_histogram(
    "controller_reconcile_duration_seconds",
    "Reconcile loop latency per controller (one observation per loop)",
    label="controller", buckets=STAGE_BUCKETS)
controller_sync_errors = global_registry.counter(
    "controller_sync_errors_total",
    "sync(key) exceptions per controller (each one also requeues its key)")


def _controller_depth_samples():
    from ..obs.reconcile import workqueue_depth_samples

    return workqueue_depth_samples()


controller_workqueue_depth = global_registry.gauge_func(
    "controller_workqueue_depth",
    "Dirty keys awaiting reconcile per live controller (read at render time)",
    fn=_controller_depth_samples)

# steady-state resource telemetry: read from live obs/resource.py samplers
# at render time (the GaugeFunc pattern — the sampler thread owns the
# cadence, a scrape just reads the latest sample)


def _resource_samples(field):
    from ..obs.resource import live_samplers

    out = []
    for s in live_samplers():
        last = s.latest()
        if last is not None and last.get(field) is not None:
            # the sampler label keeps concurrent samplers' series distinct
            # (duplicate identical label sets are invalid exposition)
            out.append(({"sampler": s.id}, float(last[field])))
    return out


process_rss_mb = global_registry.gauge_func(
    "process_resident_memory_megabytes",
    "Resident set size from the resource sampler's latest sample",
    fn=lambda: _resource_samples("rss_mb"))
process_alloc_blocks = global_registry.gauge_func(
    "process_allocated_blocks",
    "sys.getallocatedblocks() from the resource sampler's latest sample "
    "(the deterministic live-object leak signal)",
    fn=lambda: _resource_samples("alloc_blocks"))


def _thread_cpu_samples():
    from ..obs.resource import live_samplers

    out = []
    for s in live_samplers():
        last = s.latest()
        if last is None:
            continue
        for name, t in last.get("threads", {}).items():
            out.append(({"sampler": s.id, "thread": name},
                        float(t["cpu_s"])))
    return out


scheduler_thread_cpu = global_registry.gauge_func(
    "scheduler_thread_cpu_seconds",
    "Per-registered-thread CPU seconds (sched/bind threads; clock source "
    "published by the sampler's honesty flag)",
    fn=_thread_cpu_samples)

# constraint propose-and-repair observability: repair-round count per
# constrained batch (a distribution pinned at the round bound means the
# repair loop is thrashing and the residual scan is doing the real work) and
# final-state violations found by the repair check, by kind — both observed
# ONCE per batch from RepairStats, never per pod
constraint_repair_rounds = global_registry.histogram(
    "scheduler_constraint_repair_rounds",
    "Rip-and-repropose rounds per constrained batch (models/repair.py)",
    buckets=(0, 1, 2, 3, 4, 8, 16))
constraint_violations_total = global_registry.counter(
    "scheduler_constraint_violations_total",
    "Constraint violations found by the repair path's final-state check, "
    "by kind (anti_affinity / existing_anti_affinity / affinity / "
    "topology_spread)")

# the partitioned scheduler (scheduler/partition.py) and gang scheduling
partition_conflicts_total = global_registry.counter(
    "scheduler_partition_conflicts_total",
    "Cross-partition bind races LOST by a partition (the pod was already "
    "bound — an absorbed fact, not an error), by partition")
partition_reroutes_total = global_registry.counter(
    "scheduler_partition_reroutes_total",
    "Pods the dispatch layer re-routed out of a shard that declined them, "
    "by source partition and target (a partition index or 'residual')")
partition_deaths_total = global_registry.counter(
    "scheduler_partition_deaths_total",
    "Hard partition deaths absorbed by the surviving pipelines")
gang_staged = global_registry.gauge(
    "scheduler_gang_staged", "Gang members parked in queue staging")
gang_vetoed_total = global_registry.counter(
    "scheduler_gang_vetoed_total", "Gangs stripped post-solve by reason")
gang_orphan_released_total = global_registry.counter(
    "scheduler_gang_orphan_released_total",
    "Staged gang members released as ordinary pods (PodGroup gone)")
gang_preempted_total = global_registry.counter(
    "scheduler_gang_preempted_total",
    "Gangs admitted by preemption, by reason (victim_cover = a min-cost "
    "victim set on one ICI slice was evicted for the whole quorum)")
gang_quorum_expired_assumes = global_registry.gauge(
    "scheduler_gang_quorum_expired_assumes",
    "Placed gang members still counted toward quorum whose cache entry "
    "expired (the not-yet-fixed quorum leak, now measurable)")
