"""Pipeline flight recorder: per-batch stage timing for the batched solver.

The counterpart of `kubernetes_tpu/scheduler/flightrec.py`. A stage table
answers where the milliseconds of a 100k-pod schedule->bind->confirm window go? kube-scheduler
answers this with per-extension-point histograms and utiltrace steps
(schedule_one.go:411); placement-quality work (Tesserae, CvxCluster —
PAPERS.md) additionally needs per-decision attribution. Three pieces:

  StageClock     — cheap per-BATCH wall-clock marks (one perf_counter read per
                   stage boundary, never per pod; a 100k-pod batch pays ~10
                   reads total, so the <2% overhead budget holds by
                   construction).
  FlightRecorder — bounded ring of per-batch records: pod/node counts,
                   per-stage ms, outcome, gang veto/release counts,
                   preemption victims, unschedulable-reason attribution, and
                   the async bind failures drained from the bind worker.
                   Work that runs OUTSIDE a batch (self-bind confirm re-ingest
                   on a later pump, the overlapped bind worker, flush waits)
                   accumulates into per-stage "outside" buckets so the
                   aggregate stage table still sums to ~wall time.
  registry       — weak registry of live BatchSchedulers so the API server's
                   /debug/schedstats (server/rest.py) and `ktl sched stats`
                   (ROADMAP.md queue 1 item 7g2) can read the stage table of an in-process
                   scheduler without new plumbing (the configz
                   register/snapshot pattern, utils/tracing.py). The
                   snapshot functions below are those surfaces' payloads.

The generic ring/stage machinery (bounded ring, per-stage totals +
windowed histograms, exact-while-complete p50/p99, self-time accounting)
lives in obs/recorder.py — the reconcile-loop
recorder every controller inherits is built on the SAME base, so the whole
control plane shares one proven implementation. This module keeps the
scheduler-specific record schema and the outside-bucket stage table.

Everything is O(1) per batch and allocation-light; `enabled=False` skips the
ring-buffer append (placement parity with the recorder on is pinned by the
recorder on/off tests). chip_smoke.py prints the stage table of its main
path from this recorder.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Optional

from ..obs.recorder import (  # noqa: F401  (re-exported: public surface)
    STAGE_P_BUCKETS,
    RingRecorder,
    StageClock,
    nearest_rank as _nearest_rank,
)

# Serial-thread stages of one schedule_batch call, in pipeline order.
# "ingest" is the watch pump residual (decode + cache ingest) with the
# separately-attributed sub-stage (queue_add) subtracted out, so the serial
# stages stay disjoint and sum cleanly.
BATCH_STAGES = ("ingest", "pop", "tensorize", "build_pod_batch", "solve",
                "assume", "dispatch", "reject", "fallback")
# Stages accumulated outside the per-batch window: bulk queue admission
# (inside the pump), the bind worker's store.bind_many wall (overlapped with
# the next solve), and the scheduling thread's wait for in-flight binds
# (flush_binds). The old "confirm" stage is gone: the bind worker confirms
# its own assumes on the commit chunk, so self-bind events carry no work.
OUTSIDE_STAGES = ("queue_add", "bind", "bind_wait")
# Overlapped with the serial thread — excluded from "does the serial stage
# sum explain the wall clock" checks.
OVERLAPPED_STAGES = ("bind",)


class FlightRecorder(RingRecorder):
    """Bounded ring of per-batch trace records (last N batches)."""

    def __init__(self, capacity: int = RingRecorder.DEFAULT_CAPACITY,
                 enabled: bool = True):
        super().__init__(capacity=capacity, enabled=enabled)
        # async bind failures observed since the last record (attached to it)
        self._pending_bind_failures: List = []

    # -- ingest ----------------------------------------------------------------

    def note_bind_failures(self, failures: List) -> None:
        """Bind-worker failures surfaced at drain time; attached to the next
        batch record (take_bind_failures keeps its own drain semantics)."""
        if not self.enabled or not failures:
            return
        with self._lock:
            self._pending_bind_failures.extend(failures)
            del self._pending_bind_failures[:-200]  # bounded if batches stop

    def record(self, *, pods: int, nodes: int, outcome: str, solver: str,
               stages: Dict[str, float], total_s: float, scheduled: int = 0,
               unschedulable: int = 0, fallback: int = 0, preempted: int = 0,
               reasons: Optional[Dict[str, int]] = None,
               gang: Optional[Dict[str, int]] = None,
               repair: Optional[Dict] = None,
               solver_iterations: Optional[int] = None,
               breaker: Optional[str] = None,
               error: Optional[str] = None) -> Optional[Dict]:
        """Append one batch record (stage values in SECONDS; stored as ms).
        Returns the record, or None when disabled."""
        if not self.enabled:
            return None
        with self._lock:
            rec = {
                "pods": pods,
                "nodes": nodes,
                "outcome": outcome,
                "solver": solver,
                "total_ms": round(total_s * 1000, 3),
                "scheduled": scheduled,
                "unschedulable": unschedulable,
                "fallback": fallback,
                "preempted": preempted,
                "reasons": dict(reasons or {}),
                "gang": gang,
                # constraint propose-and-repair: the batch's
                # RepairStats dict when the repair path ran, else None
                "repair": repair,
                "solver_iterations": solver_iterations,
                # failure domains: non-closed breaker state and
                # the batch's handled pipeline error, when present
                "breaker": breaker,
                "error": error,
                "bind_failures": list(self._pending_bind_failures),
            }
            self._pending_bind_failures.clear()
            return self._append_record(rec, stages)

    # -- read side -------------------------------------------------------------

    def stage_table(self) -> Dict[str, Dict]:
        """Aggregate per-stage view across every batch since clear() plus the
        outside buckets (see RingRecorder.stage_table). The non-overlapped
        rows sum to ~the window's serial wall time — the machine-generated
        successor of ROADMAP's hand-maintained table."""
        return super().stage_table(
            order=list(BATCH_STAGES) + list(OUTSIDE_STAGES),
            overlapped=frozenset(OVERLAPPED_STAGES))

    def _clear_extra(self) -> None:
        self._pending_bind_failures.clear()


# -- live-scheduler registry (the configz pattern) ------------------------------

_registry_lock = threading.Lock()
_schedulers: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()


def register_scheduler(name: str, sched) -> None:
    """Register a live scheduler for /debug/schedstats. Weak: a stopped and
    collected scheduler drops out without an unregister call."""
    with _registry_lock:
        _schedulers[name] = sched


def schedstats_snapshot() -> Dict[str, Dict]:
    """{scheduler name: sched_stats()} over every live registered scheduler —
    what GET /debug/schedstats and `ktl sched stats` serve."""
    with _registry_lock:
        live = dict(_schedulers)
    out = {}
    for name, sched in live.items():
        stats: Callable = getattr(sched, "sched_stats", None)
        if stats is None:
            continue
        try:
            out[name] = stats()
        except Exception as e:  # a wedged scheduler must not 500 the endpoint
            out[name] = {"error": str(e)}
    return out


def timeseries_snapshot() -> Dict[str, Dict]:
    """{scheduler name: windowed time-series + resource summary} over every
    live registered scheduler — what GET /debug/timeseries and `ktl sched
    top` serve (obs/timeseries.py)."""
    with _registry_lock:
        live = dict(_schedulers)
    out = {}
    for name, sched in live.items():
        ts = getattr(sched, "timeseries", None)
        if ts is None:
            continue
        try:
            sampler = getattr(sched, "resource_sampler", None)
            out[name] = {
                "window_s": ts.window_s,
                "capacity": ts.capacity,
                "windows_closed": ts.windows_closed,
                "windows": ts.windows(),
                "resource": (sampler.summary()
                             if sampler is not None else None),
            }
        except Exception as e:  # same wedge-tolerance as schedstats
            out[name] = {"error": str(e)}
    return out


def schedtrace_snapshot() -> Dict[str, Dict]:
    """{scheduler name: podtrace snapshot} over every live registered
    scheduler — the sampled pod lifecycle spans GET /debug/schedtrace and
    `ktl sched trace` serve (scheduler/podtrace.py). Each snapshot carries
    the trace-buffer arm/drop counters (`tracebuf`) so a full trace ring is
    observable without exporting it."""
    from ..obs import tracebuf

    with _registry_lock:
        live = dict(_schedulers)
    tb = tracebuf.status()
    out = {}
    for name, sched in live.items():
        tracer = getattr(sched, "podtrace", None)
        if tracer is None:
            continue
        try:
            out[name] = dict(tracer.snapshot(), tracebuf=tb)
        except Exception as e:  # same wedge-tolerance as schedstats
            out[name] = {"error": str(e)}
    return out


def _all_spans() -> List[Dict]:
    """Sampled spans pooled across every live registered scheduler (the
    partitioned scheduler registers one tracer per pipeline)."""
    with _registry_lock:
        live = dict(_schedulers)
    spans: List[Dict] = []
    for _name, sched in live.items():
        tracer = getattr(sched, "podtrace", None)
        if tracer is None:
            continue
        try:
            spans.extend(tracer.snapshot().get("spans") or [])
        except Exception:
            continue
    return spans


def trace_export() -> Dict:
    """The armed (or last-disarmed) trace buffer as Chrome trace-event JSON
    plus podtrace-derived evict→replace flow arrows — what GET /debug/trace
    and `ktl sched trace --export` serve (obs/tracebuf.py)."""
    from ..obs import tracebuf

    buf = tracebuf.current()
    if buf is None:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "error": "trace buffer never armed"}
    try:
        return buf.export(spans=_all_spans())
    except Exception as e:  # same wedge-tolerance as schedstats
        return {"traceEvents": [], "displayTimeUnit": "ms", "error": str(e)}


def critpath_snapshot() -> Dict[str, Dict]:
    """{scheduler name: critical-path analysis} over every live registered
    scheduler: podtrace spans decomposed into additive submit→bound
    components with the flight recorder's stage table supplying the
    build/solve split — what GET /debug/critpath and `ktl sched why` serve
    (obs/critpath.py)."""
    from ..obs import critpath

    with _registry_lock:
        live = dict(_schedulers)
    out = {}
    for name, sched in live.items():
        tracer = getattr(sched, "podtrace", None)
        if tracer is None:
            continue
        try:
            fr = getattr(sched, "flightrec", None)
            table = fr.stage_table() if fr is not None else None
            out[name] = critpath.analyze(
                tracer.snapshot().get("spans") or [], stage_table=table)
        except Exception as e:  # same wedge-tolerance as schedstats
            out[name] = {"error": str(e)}
    return out
