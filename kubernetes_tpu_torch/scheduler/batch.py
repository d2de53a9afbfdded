"""Batch scheduler — drains whole pending-pod batches and solves them jointly.

The counterpart of `kubernetes_tpu/scheduler/batch.py` in its exact, fast
and auto modes: pods are popped in queue (priority) order, tensorized
against the cache snapshot on the host (snapshot/tensorizer.py), the node
mirrors on the device are updated by kernel B, `make_inputs` builds the
solver inputs, and the solver places the batch:
  exact       kernel A, the greedy scan (ops/solver.py greedy_scan_solve)
  fast, auto  constraint-free batches: waterfill (models/waterfill.py,
              kernel C); constrained batches: propose-and-repair
              (models/repair.py, kernels C and D, kernel A for the residual);
              a declined shape runs the scan
  native      constraint-free, gang-free batches: the sequential greedy
              placement on the host in C (native/hostsched.cpp
              greedy_assign, the scan's placements; an explicit host mode
              that launches no kernel); other batches run the scan
  auction,    constraint-free, gang-free batches: the group transportation
  sinkhorn    problem (models/transport.py: rows by kernel J, the auction's
              phases by kernel E or the Sinkhorn iterations by kernel F,
              host rounding and repair), warm-started from the duals of the
              previous batch (`transport_state`, remapped by node name); a
              batch whose classes declare host ports is declined and runs
              the scan, as do constrained and gang batches
The assignments are assumed into the cache and bound through the store. A
solver exception requeues the batch's device pods with backoff and feeds the
circuit breaker (scheduler/breaker.py), which degrades every mode but exact
to the scan after `breaker_threshold` consecutive failures.

The host commit (JAX batch.py :525-700, :1054, :1676-2160), the JAX
defaults: with columnar=True a gang-free, constraint-free, port-free device
batch lands in the cache as columnar ROWS (Cache.assume_pods_columnar, no
per-pod object; scheduler/cachecols.py) and any other batch through the
structural assume of pod_bind_clone clones; either way the resource totals
follow as ONE scatter-add over the batch (_columnar_account: the g++
commit_deltas, outside every lock), which also feeds TensorCache's
generation diff (apply_assume_deltas), so kernel B scatters exactly the
touched rows into the device mirrors. columnar=False is the per-pod oracle
(structural clones, Cache.assume_pods, per-object watch ingest). With
pipeline_binds=True the bind_many writes run on a supervised worker thread
in chunks of bind_chunk pods, overlapped with the next batch's tensorize and
solve; the worker only writes to the store and the cache (no kernel, no
CUDA tensor). A bind_many exception is retried bind_retries times with
jittered exponential backoff (_bind_chunk_with_retry); pods still failing
are forgotten, requeued and logged (take_bind_failures). An exception that
escapes the worker is counted and its chunk retried once; a dead worker's
chunks are recovered by the liveness check. finish_binding (or the bulk
self-confirm) starts each assume's TTL, and sweep_expired_assumes expires
the unconfirmed ones. run_until_idle flushes the binds before it declares
idle; flush_binds waits for them. The columnar rows collapse into PodInfos
before a constrained batch's snapshot, before device-reject preemption and
before the per-pod cycle, whose walks need object rows.

Gangs (scheduler/gang.py, JAX batch.py :393-720, :914-1060), in every mode:
the queue stages a PodGroup's members until quorum and admits them
together; the solvers add the slice-packing bonus; after the solve a gang
whose placements miss its quorum is vetoed whole BEFORE any assume, and a
gang that loses a member at assume time releases every assumed sibling;
ranked members are permuted onto ring order (kernel H, models/gangcover.py
rank_align); a solver-vetoed gang tries a victim cover on one slice (kernel
G, scheduler/gangpreempt.py), evicts through the store and parks until its
victims are gone; otherwise it requeues as a unit with one shared backoff.

The background rebalancer (scheduler/rebalance.py, kernel I) attaches with
enable_rebalancer(); run_until_idle paces it from its idle path and
rebalance_stats() publishes its totals. The `solver.solve` FaultInject site
fires in _solve_device once the path is routed, before any device work.

Device rejects (assignment -1, JAX batch.py :1095-1371): a constraint-free
batch runs tiered batch preemption (_batch_preempt): per priority tier,
numpy tensors of the capacity each node frees by evicting every lower-
priority pod pick candidate nodes in pick_one_node_for_preemption's order,
and only the chosen node runs DefaultPreemption's serial dry run (minimal
victims, PDB-aware reprieve); its victims update the tier tensors so later
pods of the batch see the freed room. A constrained batch builds the
per-node failure map and runs the profile's PostFilter (_maybe_preempt).
A preemptor is nominated to its node and waits unschedulable, attributed to
NodeResourcesFit, until its victims' deletions move it back (QueueingHints).
Fallback classes (JAX batch.py :393-432, :727-739, _serial_one :2093-2101):
a pod whose class the tensorizer marks fallback_class (DRA claims,
scheduling-relevant volumes, non-default topology-spread inclusion
policies) is not encoded for the solvers. After the device pods' commit and
reject handling, such pods run the per-pod cycle one by one, in the batch's
priority order: schedule_pod, then on failure _maybe_preempt and
_handle_failure (the plugin's own status and reason), on success the full
commit chain _commit_cycle (Reserve, Permit, PreBind, Bind, PostBind),
whose Reserve and PreBind the volume and DRA plugins need. `fallback_pods`
and `serial_scheduled` count them (the JAX batch's out["fallback"] and
out["serial_scheduled"]); `stage_seconds["fallback"]` is their clock. A gang
with a fallback-class member is vetoed whole (_strip_fallback_gangs): the
per-pod route cannot place it all-or-nothing.
The scheduling profile is a port Framework (scheduler/runtime.py) or one
per scheduler name (`profiles=`, `from_config`): PreEnqueue, QueueSort,
PostFilter and InterPodAffinity's hardPodAffinityWeight come from it. The
solvers encode the default profile's PreFilter, Filter, PreScore and Score
plugins, arguments and weights, so a profile that changes them raises
(_encoded_view). The JAX batch path ignores such a profile and solves with
the default encoding; the port refuses it (ROADMAP.md queue 3, deliberate
differences).

Observability (JAX batch.py :70-112, :223-340, :1373-1627, :1826-2031), on
by default (flight_recorder=True) as in the JAX package: schedule_batch
marks each stage on a StageClock under the JAX stage names (ingest, pop,
tensorize, build_pod_batch, solve, assume, dispatch, reject, fallback),
observes them into the stage histograms, logs a `Trace("ScheduleBatch")`
past trace_threshold, and appends ONE flight record a batch
(scheduler/flightrec.py: counts, outcome, solver, reasons, gang and repair
dicts, breaker, error); the bind worker's writes, flush_binds' wait and the
queue's bulk admission accrue to the recorder's outside buckets. The pod
tracer (scheduler/podtrace.py) samples sample_k pods a window at admission
and stamps them at pop, solve, assume, dispatch and bind; the time series
(obs/timeseries.py) windows every batch; an armed trace ring
(obs/tracebuf.py) gets the batch envelope, the bind chunks and the
gang-preemption instants. The server's series (server/metrics.py) count
retries by stage (batch_retries_total), gang vetoes and covers, repair
rounds and violations, the breaker state and the queue depth. A solver
failure narrates one SchedulerError Warning event. sched_stats() is the
whole read surface. Recording changes no placement, RV, event or bind:
flight_recorder=False gives the same outputs. The port's own
`stage_seconds`, `bind_seconds` and `retry_counts` stay beside them.

Partitioned dispatch (JAX batch.py :189-202, :1376-1400, :1490-1497,
:1586-1591, :1978-1987): a PartitionedScheduler (scheduler/partition.py)
sets partition_index, the serial loop's node filter and pod gate, and two
hooks on each shard pipeline. reroute_hook(qp, status) takes a plain
UNSCHEDULABLE verdict of a pipeline that sees one node shard and hands the
pod to another partition or the global residual pass (no event, no status
patch, no failed_count; partition_reroutes counts it); conflict_sink(qp,
msg) takes a LOST cross-partition bind race (store.is_bind_conflict: the
pod IS bound, so the pipeline drops it instead of requeueing;
partition_conflicts counts it). sched_stats()["partition"] and the
"partition" window probe publish them, and the bind worker's trace track
and thread name carry the partition (p<i>-bind). Standalone, all are inert.

Not in this slice (each raises or is named where it would act):
  transport over a node-axis mesh (several cards), extenders
                                              queue 1 item 6
  the background start() loop, the /debug routes and `ktl sched`
                                              queue 1 item 7g
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue as _queue
import random as _random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..chaos import faultinject
from ..chaos.faultinject import FaultKill
from ..models.gangcover import alignment_groups, mean_neighbor_distance, rank_align
from ..models.repair import repair_solve
from ..models.transport import transport_solve
from ..models.waterfill import make_groups, waterfill_solve
from ..native import hostcommit
from ..native.hostsched import commit_deltas_plain, native_commit_deltas, native_greedy_solve
from ..obs import tracebuf as _tracebuf
from ..obs.timeseries import TimeSeriesRecorder
from ..ops.solver import greedy_scan_solve, make_inputs, resolve_device
from ..server import metrics
from ..snapshot.tensorizer import TensorCache, build_pod_batch
from ..store import (MODIFIED, APIStore, NotFoundError, is_bind_conflict, pod_bind_clone,
                     pod_structural_clone)
from ..utils.tracing import Trace
from . import cachecols
from .breaker import REPRESENTATIVE, SolverCircuitBreaker
from .flightrec import FlightRecorder, StageClock, register_scheduler
from .framework import Code, CycleState, PodInfo, Status
from .gang import GangDirectory, gang_veto_mask, node_slice_positions, ring_lengths
from .gangpreempt import GangPreemptor, flatten_snapshot_victims
from .plugins import default_plugins
from .plugins.default_preemption import DefaultPreemption
from .podtrace import PodTracer
from .queue import QueuedPodInfo
from .runtime import Framework
from .serial import ScheduleResult, Scheduler

SOLVERS = ("exact", "fast", "auto", "native", "auction", "sinkhorn")

log = logging.getLogger(__name__)


class _RequeuedChunk(list):
    """A bind chunk getting its ONE supervised retry after an escaped
    bind-worker exception (or a dead-worker recovery). A second escape fails
    its pods through the normal bind-error path instead of requeueing again:
    no livelock on a deterministic fault."""


class BatchScheduler(Scheduler):
    """Batched scheduler on one device.

    solver: "exact" (default: the scan, bit-parity with the serial
    scheduler), "fast" (waterfill for constraint-free batches,
    propose-and-repair for constrained ones), "auto" (the same routing), or
    "auction" / "sinkhorn" (the transport solvers for constraint-free,
    gang-free batches without host ports; the scan for the others), or
    "native" (constraint-free, gang-free batches placed by the host C
    engine; the scan for the others).
    device: "cuda" (default) runs the kernels on the card and raises where
    torch.cuda.is_available() is false; "cpu" runs their plain versions.
    framework: a port Framework (scheduler/runtime.py), or profiles= (in
    **kw): one per scheduler name; with neither, Framework(default_plugins()).
    A profile whose PreFilter, Filter, PreScore or Score plugins, plugin
    arguments or Score weights differ from the default's raises: the solvers
    encode the default's. columnar, pipeline_binds, bind_retries and
    bind_retry_base_s select the host commit (module docstring; the JAX
    defaults). rank_align gates the rank-to-ring permutation of
    ranked gang members; gang_preemption installs the gang victim cover;
    flight_recorder (default True, as in the JAX package) switches the
    flight recorder of flight_capacity records, the time series of
    ts_window_s windows and, unless pod_trace says otherwise, the pod
    tracer sampling trace_sample_k pods a window; the other keyword
    arguments (clock, profiles, pod_initial_backoff, pod_max_backoff,
    percentage_of_nodes_to_score) pass to Scheduler."""

    BIND_FAILURE_LOG_CAP = 10_000  # take_bind_failures log bound

    def __init__(self, store: APIStore, framework: Optional[Framework] = None, *,
                 device="cuda", batch_size: int = 4096, solver: str = "exact",
                 columnar: bool = True, pipeline_binds: bool = True,
                 bind_retries: int = 3, bind_retry_base_s: float = 0.05,
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 30.0,
                 rank_align: bool = True, gang_preemption: bool = True,
                 flight_recorder: bool = True,
                 flight_capacity: int = FlightRecorder.DEFAULT_CAPACITY,
                 pod_trace: Optional[bool] = None,
                 trace_sample_k: int = PodTracer.DEFAULT_SAMPLE_K,
                 ts_window_s: float = 5.0, **kw):
        self.device = resolve_device(device)
        if framework is not None and not isinstance(framework, Framework):
            raise TypeError("framework must be a kubernetes_tpu_torch Framework, got "
                            + type(framework).__name__)
        if framework is None and kw.get("profiles") is None:
            framework = Framework(default_plugins())
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
        super().__init__(store, framework, **kw)
        encoded = _encoded_view(Framework(default_plugins()))
        for name, fw in self.profiles.items():
            if _encoded_view(fw) != encoded:
                raise NotImplementedError(
                    f"profile {name!r} changes the PreFilter, Filter, PreScore or Score "
                    "plugins, their arguments or weights, which the batch solvers encode "
                    "as the default profile's; the batch scheduler refuses such a profile "
                    "(ROADMAP.md queue 3, deliberate differences)")
        self.batch_size = batch_size
        self.solver = solver
        # flight recorder (scheduler/flightrec.py): per-batch stage timing
        # and a bounded record ring. Stage marks are per BATCH (a handful of
        # perf_counter reads), so the recorder changes no placement and its
        # self-time stays inside the <2% budget.
        self.flightrec = FlightRecorder(capacity=flight_capacity, enabled=flight_recorder)
        self.queue.stat_sink = self.flightrec
        # sampled pod lifecycle tracer (scheduler/podtrace.py): reservoir-
        # samples sample_k pods a window at queue admission, stamps the
        # pipeline edges with SHARED per-batch / per-chunk timestamps, and
        # feeds the all-pods submit->bound histogram. Follows the recorder's
        # switch unless pod_trace says otherwise.
        self.podtrace = PodTracer(
            clock=self.clock, sample_k=trace_sample_k,
            enabled=flight_recorder if pod_trace is None else pod_trace,
            stat_sink=self.flightrec)
        self.queue.trace_sink = self.podtrace
        # windowed time series (obs/timeseries.py): ONE note_batch tap a
        # batch; the recorder forwards its outside buckets (bind, bind_wait,
        # queue_add) so the overlapped stages window too. No stat_sink: its
        # taps run inside the callers' measured self-time windows already.
        self.timeseries = TimeSeriesRecorder(window_s=ts_window_s, enabled=flight_recorder)
        self.flightrec.timeseries = self.timeseries
        # an obs/resource.py ResourceSampler (attach_resource_sampler): RSS,
        # GC, live-object and per-thread CPU columns in every window
        self.resource_sampler = None
        # queue-depth gauge refresh throttle: the telemetry scan is
        # O(queue), so the gauges update at most once a second
        self._q_telemetry_next = 0.0
        self._q_telemetry_last: Optional[Dict] = None
        self._q_telemetry_lock = threading.Lock()
        # per-batch unschedulable-reason attribution (set during
        # schedule_batch; _handle_failure taps Status.plugin into it)
        self._batch_reasons: Optional[Dict[str, int]] = None
        self.trace_threshold = 1.0  # ScheduleBatch Trace log threshold (s)
        # columnar=True is the batched host pipeline: coalesced watch ingest,
        # the structural assume + one scatter-add, the bulk self-confirm;
        # False restores the per-pod paths (the parity oracle)
        self.columnar = columnar
        self.watch_coalesce = columnar
        # cache-row mode: eligible device batches land as columnar cache
        # rows, resolved once here (STORE_COLUMNAR=0 sweeps the whole
        # pipeline to its object-path oracle)
        self._cache_columnar = columnar and cachecols.env_enabled()
        # bind pipelining (schedule_one.go bindingCycle in a goroutine): the
        # assume runs synchronously so the next solve's snapshot sees the
        # capacity; the bind_many writes run on a worker thread in chunks of
        # bind_chunk pods, overlapped with the next batch
        self.pipeline_binds = pipeline_binds
        self.bind_chunk = 4096
        self._bind_q: _queue.Queue = _queue.Queue()
        self._bind_worker: Optional[threading.Thread] = None
        self._bind_err_lock = threading.Lock()
        self._bind_errors: List = []
        self._bind_successes = 0  # folded into scheduled_count on this thread
        # assumed pods whose worker-side confirm missed (expired assume or a
        # foreign write): re-ingested on the scheduling thread at the drain
        self._bind_confirm_leftovers: List = []
        # in-flight bind chunks (each owing one task_done), recorded by the
        # worker before the commit and cleared after it: non-empty with a
        # DEAD worker means a hard kill stranded them
        self._bind_inflight: List = []
        self.bind_worker_restarts = 0  # escapes counted + dead workers replaced
        # (pod key, message) of asynchronous bind failures, drained by
        # take_bind_failures(); bounded, evictions counted
        self.bind_failures: deque = deque(maxlen=self.BIND_FAILURE_LOG_CAP)
        self.bind_failures_dropped = 0
        self.bind_retries = bind_retries
        self.bind_retry_base_s = bind_retry_base_s
        # pods (or, for "bind", attempts) retried per stage: the increments
        # of batch_retries_total at those stages (solve retries are counted
        # by the series alone, as in the JAX package)
        self.retry_counts = {"bind": 0, "worker": 0, "dispatch": 0}
        # host seconds of the bind writes (the worker's, when pipelined) and
        # of flush_binds' wait for them (JAX flightrec's outside buckets)
        self.bind_seconds = {"bind": 0.0, "bind_wait": 0.0}
        self._tensor_cache = TensorCache()
        self.batches_solved = 0
        # fallback-class pods routed through the per-pod cycle, and those it
        # bound (the JAX batch's out["fallback"] / out["serial_scheduled"])
        self.fallback_pods = 0
        self.serial_scheduled = 0
        # solver failure domain: the breaker trips the fast modes to the scan
        # after breaker_threshold consecutive solver exceptions
        self.breaker = SolverCircuitBreaker(clock=self.clock, threshold=breaker_threshold,
                                            cooldown_s=breaker_cooldown_s)
        # the solver path the last _solve_device call executed (or was
        # executing when it raised): what the breaker is fed
        self._solve_path = "exact"
        self.last_solver_error: Optional[str] = None
        self.transport_state = None  # warm duals carried across batches
        # propose-and-repair: the last batch's RepairStats + running totals
        self._last_repair = None
        self.repair_totals = {"batches": 0, "rounds": 0, "proposed": 0, "repaired": 0,
                              "residual": 0, "full_scan": 0, "violations": 0}
        # host seconds per stage, summed over batches (the solve stage ends
        # with the assignment's copy to the host, so it includes device time)
        self.stage_seconds = {"tensorize": 0.0, "solve": 0.0, "commit": 0.0,
                              "fallback": 0.0}
        self.solve_seconds: deque = deque(maxlen=1024)  # per batch
        # gang scheduling: PodGroup quorums and placed members, fed by the
        # watch plumbing in serial.py; the queue stages members until quorum
        # and schedule_batch enforces the all-or-nothing veto. Inactive (one
        # attribute read) until a PodGroup exists.
        self.gangs = GangDirectory()
        self.queue.set_gang_hooks(self.gangs.group_of, self.gangs.quorum_ready,
                                  lambda: self.gangs.active)
        self.gang_vetoes = 0  # gangs stripped before assume
        # the gang dict of the last batch with gang members (the JAX flight
        # record's "gang" entry: staged/vetoed/assume_vetoed/released/
        # hopeless, cover stats, adjacency before and after rank alignment)
        self.last_gang: Optional[Dict] = None
        self.rank_align = rank_align
        # the default profile's DefaultPreemption (None when the profile has
        # none): per-pod preemption of device rejects runs its dry run, and
        # the gang victim cover executes through its victim half
        self.preemption = self._preemption_plugin(self.framework)
        # gang preemption: a solver-vetoed gang tries a min-cost victim cover
        # on one slice
        self.gangpreempt = GangPreemptor(self) if gang_preemption else None
        self.preempt_victims_total = 0  # victims chosen by _batch_preempt
        # partitioned scheduling (scheduler/partition.py): installed by
        # PartitionedScheduler on its pipelines, all inert on a standalone
        # scheduler (module docstring). partition_index is the shard (-1
        # the global residual pass); None sees the whole cluster.
        self.partition_index: Optional[int] = None
        self.reroute_hook = None
        self.conflict_sink = None
        self.partition_conflicts = 0  # bind conflicts this pipeline LOST
        self.partition_reroutes = 0  # pods handed to another partition
        # background rebalancer (scheduler/rebalance.py): installed by
        # enable_rebalancer(); run_until_idle's idle path paces it
        self.rebalancer = None
        self._register_window_probes()
        register_scheduler(self._bind_origin, self)

    def schedule_cycle(self) -> int:
        return self.schedule_batch()

    def schedule_batch(self) -> int:
        """Drain up to batch_size pods, solve jointly, bind. Returns #pods handled.

        Instrumented per BATCH, never per pod: a StageClock marks each stage
        boundary, the marks feed the stage histograms and a
        Trace("ScheduleBatch") (logged past trace_threshold), and ONE flight
        record captures the batch's outcome, counts and unschedulable-reason
        attribution; batch_solve_duration is observed with the outcome on
        every path that pops a batch. An empty pop records nothing (its pump
        folds into the outside buckets)."""
        fr = self.flightrec
        clock = StageClock()
        # queue_add accrues into the recorder's outside bucket inside this
        # pump: difference it out so "ingest" stays disjoint from it
        sub0 = fr.outside_seconds("queue_add")
        # pump until the watch drains (bounded: sustained arrival must not
        # starve scheduling)
        for _ in range(8):
            if self.pump_events(max_events=self.batch_size) < self.batch_size:
                break
        clock.mark("ingest")
        clock.sub("ingest", fr.outside_seconds("queue_add") - sub0)
        qps = self.queue.pop_batch(self.batch_size)
        clock.mark("pop")
        if not qps:
            for name, sec in clock.stages.items():
                fr.add_outside(name, sec)
            return 0
        self.batches_solved += 1
        metrics.batch_size_gauge.set(len(qps))
        # ONE full-batch pass finds the sampled pods; later stage stamps
        # touch only the <= sample_k hits
        self.podtrace.batch_popped(qps)
        trace = Trace("ScheduleBatch", pods=len(qps))
        failed0 = self.failed_count
        victims0 = self.preempt_victims_total
        self._batch_reasons = reasons = {}
        outcome = "error"  # overwritten unless the body raises
        # circuit breaker: the configured solver while CLOSED, the scan while
        # OPEN, a single probe of the configured one when HALF_OPEN
        out: Dict = {"solver": self.breaker.effective_solver(self.solver)}
        self._last_repair = None
        metrics.solver_breaker_state.set(self.breaker.code)
        try:
            self._schedule_batch_inner(qps, clock, trace, out)
            outcome = ("scheduled" if out.get("dispatched", 0) + out.get("serial_scheduled", 0)
                       else "error" if "batch_error" in out else "unschedulable")
            return len(qps)
        finally:
            self._batch_reasons = None
            t_fin = time.perf_counter()
            total = clock.total()
            for name, sec in clock.stages.items():
                metrics.batch_stage_duration.observe(sec, name)
            metrics.batch_solve_duration.observe(total, outcome)
            if self.gangs.active:
                metrics.gang_staged.set(self.queue.gang_staged_count())
            scheduled = out.get("dispatched", 0) + out.get("serial_scheduled", 0)
            fr.record(
                pods=len(qps), nodes=out.get("nodes", 0), outcome=outcome,
                solver=out["solver"], stages=clock.stages, total_s=total,
                scheduled=scheduled, unschedulable=self.failed_count - failed0,
                fallback=out.get("fallback", 0),
                preempted=self.preempt_victims_total - victims0,
                reasons=reasons, gang=out.get("gang"),
                repair=(self._last_repair.as_dict()
                        if self._last_repair is not None else None),
                solver_iterations=getattr(self.transport_state, "iterations", None),
                breaker=self.breaker.state if self.breaker.state != "closed" else None,
                error=out.get("batch_error"))
            # ONE time-series tap a batch, inside the self-time window
            self.timeseries.note_batch(clock.stages, pods=len(qps), scheduled=scheduled,
                                       failed=self.failed_count - failed0)
            # an armed trace ring gets the batch envelope and its stage
            # slices on this pipeline's track
            if _tracebuf.ACTIVE is not None:
                tb = _tracebuf.ACTIVE
                tb.attach_clock(self.clock)
                tb.note_batch(self._thread_label("sched"), t_end=t_fin, stages=clock.stages,
                              pods=len(qps), scheduled=scheduled, outcome=outcome,
                              solver=out["solver"], breaker=self.breaker.state)
            trace.log_if_long(self.trace_threshold)
            self._update_queue_telemetry()
            fr.note_self_time(time.perf_counter() - t_fin)

    def _schedule_batch_inner(self, qps, clock, trace, out: Dict) -> None:
        """The batch pipeline body (schedule_batch owns the bookkeeping
        around it). Fills `out` with nodes, dispatched, fallback,
        serial_scheduled, gang and batch_error for the flight record."""
        solver = out["solver"]
        t0 = time.perf_counter()
        if self.cache.columnar_rows():
            # a CONSTRAINED batch walks the snapshot's pod lists (spread
            # selector counts, inter-pod affinity terms): collapse the
            # columnar cache rows first (a superset of has_constraints, early
            # exit); the constraint-free batch never materializes
            for qp in qps:
                spec = qp.pod.spec
                if spec.affinity is not None or spec.topology_spread_constraints:
                    self.cache.materialize_columnar_rows()
                    break
        snapshot = self.cache.update_snapshot()
        out["nodes"] = len(snapshot)
        if len(snapshot) == 0:
            clock.mark("tensorize")
            for qp in qps:
                self._handle_failure(qp, Status.unschedulable(
                    "no nodes available to schedule pods"))
            return
        cluster, changed_nodes = self._tensor_cache.cluster_tensors(snapshot)
        clock.mark("tensorize")
        trace.step("Tensorized cluster", nodes=len(snapshot))
        pods = [qp.pod for qp in qps]
        # the store's columnar pod view (None on a dict store) re-seeds the
        # pods' signature memos; the batch build primes them, and ONE
        # batched capture writes the refs back into the store's sig column
        # so rows re-synced by later status/relist writes stay seedable
        store_cols = self.store.pod_columns()
        batch = build_pod_batch(
            pods, snapshot, cluster, ns_labels=self._ns_labels,
            hard_pod_affinity_weight=self._hard_pod_affinity_weight(),
            reuse=self._tensor_cache, changed_nodes=changed_nodes, gangs=self.gangs,
            store_cols=store_cols)
        if store_cols is not None:
            self.store.capture_sig_memos(pods)
        fallback_mask = batch.fallback_class[batch.class_of_pod]
        keep = ~self._strip_fallback_gangs(qps, batch, fallback_mask)
        device_idx = np.nonzero(~fallback_mask & keep)[0]
        fallback_idx = np.nonzero(fallback_mask & keep)[0]
        out["fallback"] = int(fallback_idx.size)
        clock.mark("build_pod_batch")
        trace.step("Built pod batch", device=int(device_idx.size),
                   fallback=int(fallback_idx.size))
        t1 = time.perf_counter()
        self.stage_seconds["tensorize"] += t1 - t0

        if device_idx.size:
            sub = _subset_batch(batch, device_idx)
            has_gang = sub.gang_of_pod is not None and bool((sub.gang_of_pod >= 0).any())
            try:
                assignment = self._solve_device(solver, cluster, batch, sub, has_gang)
            except Exception as e:
                # nothing is assumed yet: the device pods requeue as a unit
                self._handle_solver_error(e, qps, device_idx, solver, out)
                clock.mark("solve")
                trace.step("Solver failed; batch requeued", error=type(e).__name__)
                assignment = None
            else:
                self.breaker.record_success(self._solve_path, self.solver)
            gang = None
            if assignment is not None and has_gang:
                assignment, gang = self._gang_veto(cluster, sub, assignment)
                out["gang"] = gang["info"]
            t2 = time.perf_counter()
            self.stage_seconds["solve"] += t2 - t1
            self.solve_seconds.append(t2 - t1)
            if assignment is not None:
                clock.mark("solve")
                trace.step("Device solve done", solver=solver)
                self.podtrace.batch_stage("solve")  # shared per-batch stamp
                self._commit(qps, device_idx, assignment, snapshot, cluster, batch, sub, gang,
                             clock, trace, out)
                self.stage_seconds["commit"] += time.perf_counter() - t2
        if fallback_idx.size:
            # the per-pod route, after the device commit and its rejects, in
            # the batch's priority order (gang members never reach here)
            t3 = time.perf_counter()
            fb0 = self.scheduled_count
            for pi in fallback_idx.tolist():
                self._serial_one(qps[pi])
            out["serial_scheduled"] = self.scheduled_count - fb0
            self.fallback_pods += int(fallback_idx.size)
            self.serial_scheduled += out["serial_scheduled"]
            self.stage_seconds["fallback"] += time.perf_counter() - t3
            clock.mark("fallback")
            trace.step("Serial fallback done", pods=int(fallback_idx.size))

    def _serial_one(self, qp: QueuedPodInfo) -> None:
        """One fallback-class pod through the per-pod cycle: on failure the
        PostFilter (preemption) and the failure handling, on success the
        full commit chain (Reserve/Permit/PreBind/Bind/PostBind)."""
        result = self.schedule_pod(qp.pod)
        if not result.suggested_host:
            self._maybe_preempt(qp, result)
            self._handle_failure(qp, result.status, result.failed_nodes)
            return
        self._commit_cycle(qp, result)

    def _strip_fallback_gangs(self, qps, batch, fallback_mask) -> np.ndarray:
        """A gang with a member whose class needs the serial fallback path
        would not be placed all-or-nothing: every in-batch member of such a
        gang fails unschedulable, with ONE Warning event naming the gangs.
        Returns the stripped rows as a [P] bool mask."""
        strip = np.zeros(len(qps), dtype=bool)
        if batch.gang_of_pod is None:
            return strip
        gof = np.asarray(batch.gang_of_pod)
        bad = np.unique(gof[(gof >= 0) & fallback_mask])
        if not bad.size:
            return strip
        strip = np.isin(gof, bad)
        names = ", ".join(batch.gang_keys[g] for g in bad.tolist())
        self.gang_vetoes += int(bad.size)
        metrics.gang_vetoed_total.inc(int(bad.size), reason="serial_fallback")
        rows = np.nonzero(strip)[0].tolist()
        self.recorder.event(
            qps[rows[0]].pod, "Warning", "GangVetoed",
            f"gang(s) {names} vetoed: a member class requires serial-fallback "
            "scheduling (volumes/DRA), where all-or-nothing placement cannot be enforced")
        for pi in rows:
            self._handle_failure(qps[pi], Status.unschedulable(
                "gang member class requires serial-fallback scheduling; all-or-nothing "
                "placement is only enforced on the batched path (gang vetoed)"))
        return strip

    def _gang_veto(self, cluster, sub, assignment):
        """The all-or-nothing veto BEFORE any assume: a gang whose in-batch
        placements plus members already placed miss min_member has every row
        unplaced. Then the rank alignment of ranked members. Returns the new
        assignment and the batch's gang state."""
        gang_info = {"staged": self.queue.gang_staged_count(), "vetoed": 0,
                     "assume_vetoed": 0, "released": 0, "hopeless": 0}
        need = np.array([max(0, (self.gangs.min_member(k) or 0) - self.gangs.placed_count(k))
                         for k in sub.gang_keys], dtype=np.int64)
        veto, _satisfied = gang_veto_mask(assignment, np.asarray(sub.gang_of_pod), need)
        # a gang needing more members than one solve can see is unsatisfiable
        # by this configuration: park it with a diagnostic, never livelock
        hopeless = set(np.nonzero(need > self.batch_size)[0].tolist())
        solver_vetoed = set()
        if veto.any():
            # solver-vetoed gangs are the preemption candidates (an
            # assume-time veto means the gang FIT: a race, not a room problem)
            solver_vetoed = set(np.unique(sub.gang_of_pod[veto]).tolist())
            self.gang_vetoes += len(solver_vetoed)
            gang_info["vetoed"] = len(solver_vetoed)
            metrics.gang_vetoed_total.inc(len(solver_vetoed), reason="solver")
            assignment = np.where(veto, -1, assignment)
        if (self.rank_align and sub.gang_rank is not None
                and bool((np.asarray(sub.gang_rank) >= 0).any())):
            assignment = self._rank_align_assignment(cluster, sub, assignment, gang_info)
        self.last_gang = gang_info
        return assignment, {"info": gang_info, "need": need, "veto": veto,
                            "hopeless": hopeless, "solver_vetoed": solver_vetoed}

    def _solve_device(self, solver, cluster, batch, sub, has_gang: bool) -> np.ndarray:
        """One device-batch solve under the (possibly breaker-degraded)
        solver mode. Returns the assignment [P] as host int32. Any exception
        propagates to the failure domain in schedule_batch.

        _solve_path tracks the path executing at every point, so both the
        success and an exception anywhere in here are attributed to the
        right solver (the breaker never credits a scan outcome to the fast
        path, or the reverse)."""
        self._solve_path = REPRESENTATIVE.get(solver, solver)
        constraint_free = not batch.has_constraints
        use_fast = solver in ("fast", "auto") and constraint_free
        use_repair = solver in ("fast", "auto") and not constraint_free
        use_transport = solver in ("auction", "sinkhorn") and constraint_free and not has_gang
        if use_repair:
            self._solve_path = "repair"
        elif not constraint_free:
            self._solve_path = "exact"  # the scan owns constrained batches
        # routed BEFORE the injected fire, so a fault attributes to the path
        # the batch would have run (a constrained fast-mode batch: repair)
        if faultinject.ACTIVE is not None:
            faultinject.ACTIVE.fire("solver.solve")
        assignment = None
        if solver == "native" and constraint_free and not has_gang:
            # the explicit host mode: the C engine places the batch, no
            # device upload (the dirty rows stay pending for the next
            # device_views)
            self._solve_path = "native"
            assignment, _ = native_greedy_solve(cluster, sub)
            return np.asarray(assignment, dtype=np.int32)
        # cluster tensors ride the device mirrors (kernel B)
        views = self._tensor_cache.device_views(cluster, self.device)
        inputs, d_max = make_inputs(cluster, sub, self.device, views=views)
        if use_transport:
            self._solve_path = solver
            solved = transport_solve(inputs, make_groups(sub), method=solver,
                                     state=self.transport_state,
                                     node_names=cluster.node_names)
            if solved is not None:
                assignment, self.transport_state = solved
            else:
                self._solve_path = "exact"  # declined (host ports): the scan takes it
        if use_fast:
            self._solve_path = "fast"
            assignment = waterfill_solve(inputs, make_groups(sub))
        gang = has_gang and sub.gang_bonus is not None
        if use_repair:
            solved = repair_solve(inputs, sub, d_max, has_gang=gang)
            if solved is not None:
                assignment, rstats = solved
                self._note_repair(rstats)
            else:
                self._solve_path = "exact"  # past the sort-key range: the scan
        if assignment is None:
            self._solve_path = "exact"
            scan, _, _ = greedy_scan_solve(
                inputs, d_max, has_ipa=bool(batch.ipa.has_any),
                has_ct=bool(batch.ct_class.size), has_st=bool(batch.st_class.size),
                has_gang=gang)
            assignment = scan.cpu().numpy()
        return np.asarray(assignment, dtype=np.int32)

    def _note_repair(self, rstats) -> None:
        """Fold one constrained batch's RepairStats into the metrics and the
        running totals (ONE call a batch, never per pod)."""
        self._last_repair = rstats
        t = self.repair_totals
        t["batches"] += 1
        t["rounds"] += rstats.rounds
        t["proposed"] += rstats.proposed
        t["repaired"] += rstats.repaired
        t["residual"] += rstats.residual
        t["full_scan"] += int(rstats.full_scan)
        metrics.constraint_repair_rounds.observe(rstats.rounds)
        for kind, v in rstats.violations.items():
            if v:
                t["violations"] += v
                metrics.constraint_violations_total.inc(v, kind=kind)

    def _handle_solver_error(self, e, qps, device_idx, solver, out: Dict) -> None:
        """Solver failure domain: requeue the device pods with backoff (the
        pods are fine, so no cluster event is needed before the retry), feed
        the circuit breaker, count the retries and narrate ONCE a batch (a
        100k-pod batch must not write 100k events)."""
        qps_dev = [qps[pi] for pi in device_idx.tolist()]
        tripped = self.breaker.record_failure(self._solve_path, self.solver)
        metrics.solver_breaker_state.set(self.breaker.code)
        metrics.batch_retries_total.inc(len(qps_dev), stage="solve", reason=type(e).__name__)
        self.queue.add_backoff(qps_dev)
        sink = self._batch_reasons
        if sink is not None:
            sink["SolverError"] = sink.get("SolverError", 0) + len(qps_dev)
        self.last_solver_error = out["batch_error"] = f"{type(e).__name__}: {e}"[:200]
        log.warning("solver %s failed on path %s; %d pod(s) requeued with backoff%s",
                    self.solver, self._solve_path, len(qps_dev),
                    "; circuit breaker OPEN" if tripped else "", exc_info=e)
        msg = (f"solver {solver} failed ({type(e).__name__}: {str(e)[:120]});"
               f" {len(qps_dev)} pod(s) requeued with backoff")
        if tripped:
            msg += (f"; circuit breaker OPEN — degrading to "
                    f"{self.breaker.effective_solver(self.solver)} for "
                    f"{self.breaker.cooldown_s:g}s")
        self.recorder.event(qps_dev[0].pod, "Warning", "SchedulerError", msg)

    def _commit(self, qps, device_idx, assignment, snapshot, cluster, batch, sub,
                gang, clock, trace, out: Dict) -> None:
        """Assume every placement first, then dispatch the binds, then handle
        the rejects (preemption or failure; handling them mid-loop would see
        capacity promised to not-yet-bound pods), then requeue the vetoed
        gangs. The assume takes one of three forms (module docstring):
        columnar rows, the structural assume + one scatter-add, or the
        per-pod oracle. Marks the assume, dispatch and reject stages."""
        node_names = cluster.node_names
        n = len(node_names)
        has_gang = gang is not None
        use_columnar = self.columnar and batch.raw_req is not None
        # zero-object dispatch: a gang-free, constraint-free, port-free
        # batch hands the bind path the ORIGINAL pod refs (it reads only key
        # and target node) and lands in the cache as columnar rows
        cols_rows_ok = (use_columnar and self._cache_columnar and not has_gang
                        and not batch.has_constraints
                        and batch.class_has_host_ports is not None
                        and not bool(batch.class_has_host_ports[
                            batch.class_of_pod[device_idx]].any()))
        clone = pod_bind_clone if use_columnar else pod_structural_clone
        assign_list = np.asarray(assignment).tolist()
        sub_gang = np.asarray(sub.gang_of_pod).tolist() if has_gang else None
        veto_list = gang["veto"].tolist() if has_gang else None
        gang_requeue: Dict[int, List[QueuedPodInfo]] = {}
        to_bind = []
        bind_rows: List[int] = []  # full-batch pod row per to_bind entry
        bind_nodes: List[int] = []  # cluster node index per to_bind entry
        bind_gang: List[int] = []  # gang id per to_bind entry (gang batches only)
        rejected = []
        for j, pi in enumerate(device_idx.tolist()):
            gid = sub_gang[j] if sub_gang is not None else -1
            if veto_list is not None and veto_list[j]:
                gang_requeue.setdefault(gid, []).append(qps[pi])
                continue
            nidx = assign_list[j]
            if nidx < 0:
                if gid >= 0:
                    # unplaced extra of a SATISFIED gang: it fails alone, and
                    # no preemption is ever tried for part of a gang
                    self._handle_failure(qps[pi], Status.unschedulable(
                        f"0/{n} nodes are available (gang member; preemption skipped)",
                        plugin="NodeResourcesFit"))
                else:
                    rejected.append((j, qps[pi]))
            else:
                qp = qps[pi]
                to_bind.append((qp, node_names[nidx],
                                qp.pod if cols_rows_ok else clone(qp.pod)))
                bind_rows.append(pi)
                bind_nodes.append(nidx)
                if sub_gang is not None:
                    bind_gang.append(gid)
        if to_bind:
            pairs = [(assumed, node) for _qp, node, assumed in to_bind]
            batch_has_ports = True
            if cols_rows_ok:
                batch_has_ports = False  # port-free by the dispatch gate
            elif use_columnar:
                batch_has_ports = bool(
                    batch.class_has_host_ports is None
                    or batch.class_has_host_ports[batch.class_of_pod[bind_rows]].any())
            # assume/dispatch failure domain: an exception in this window
            # rolls back every entry whose chunk has NOT reached the bind
            # path and requeues it with backoff; dispatched chunks belong to
            # the bind path's own retry and error handling
            accounted = False
            dispatched_hi = 0
            sync_bind_s = 0.0
            try:
                if cols_rows_ok:
                    bad = self.cache.assume_pods_columnar(pairs)
                elif use_columnar:
                    bad = self.cache.assume_pods_structural(pairs, check_ports=batch_has_ports)
                else:
                    bad = self.cache.assume_pods(pairs)
            except FaultKill:
                raise
            except Exception as e:
                self._rollback_undispatched(e, to_bind, bind_gang, 0, use_columnar, False,
                                            batch_has_ports, out)
                to_bind = []
                bad = []
            bad_gangs = set()
            for i, msg in sorted(bad, reverse=True):
                qp, _node, _assumed = to_bind.pop(i)
                bind_rows.pop(i)
                bind_nodes.pop(i)
                gid = bind_gang.pop(i) if bind_gang else -1
                if gid >= 0:
                    bad_gangs.add(gid)
                    gang_requeue.setdefault(gid, []).append(qp)
                else:
                    self._handle_failure(qp, Status.error(msg))
            if bad_gangs:
                # all-or-nothing at assume time: a gang that lost a member
                # releases every assumed sibling BEFORE any bind. Before the
                # scatter-add the release is the structural inverse
                # (forget_pod would subtract totals never added)
                released = []
                for i in range(len(to_bind) - 1, -1, -1):
                    gid = bind_gang[i]
                    if gid in bad_gangs:
                        qp, _node, assumed = to_bind.pop(i)
                        bind_rows.pop(i)
                        bind_nodes.pop(i)
                        bind_gang.pop(i)
                        released.append(assumed)
                        gang_requeue.setdefault(gid, []).append(qp)
                if use_columnar:
                    self.cache.forget_pods_structural(released, check_ports=batch_has_ports)
                else:
                    for assumed in released:
                        self.cache.forget_pod(assumed)
                gang["info"]["assume_vetoed"] = len(bad_gangs)
                gang["info"]["released"] = len(released)
                metrics.gang_vetoed_total.inc(len(bad_gangs), reason="assume")
            if bind_gang:
                # surviving members count toward quorum from assume on (our
                # own bind confirmations bypass the event stream)
                for i, (_qp, _node, assumed) in enumerate(to_bind):
                    if bind_gang[i] >= 0:
                        self.gangs.note_assumed(assumed)
            try:
                if use_columnar and to_bind:
                    self._columnar_account(batch, cluster, snapshot, bind_rows, bind_nodes,
                                           batch_has_ports)
                    accounted = True
                clock.mark("assume")
                trace.step("Assumed placements", bound=len(to_bind))
                self.podtrace.batch_stage("assume")
                out["dispatched"] = len(to_bind)
                # the dispatch edge is the hand-over to the bind path,
                # stamped BEFORE the chunk loop so the synchronous-bind mode
                # (which completes spans inside the loop) records it too
                self.podtrace.batch_stage("dispatch")
                for lo in range(0, len(to_bind), self.bind_chunk):
                    chunk = to_bind[lo:lo + self.bind_chunk]
                    if self.pipeline_binds:
                        self._ensure_bind_worker()
                        self._bind_q.put(chunk)
                    else:
                        tb0 = time.perf_counter()
                        self._bind_batch(chunk)
                        sync_bind_s += time.perf_counter() - tb0
                    dispatched_hi = lo + len(chunk)
                if not self.pipeline_binds:
                    self._drain_bind_results()
            except FaultKill:
                raise
            except Exception as e:
                self._rollback_undispatched(e, to_bind, bind_gang, dispatched_hi, use_columnar,
                                            accounted, batch_has_ports, out)
                out["dispatched"] = dispatched_hi
            clock.mark("dispatch")
            # synchronous binds ran inside the dispatch span AND are observed
            # as the "bind" stage by _bind_batch: keep the stages disjoint
            clock.sub("dispatch", sync_bind_s)
            trace.step("Dispatched binds")
        if rejected:
            self._handle_device_rejects(rejected, snapshot, cluster, sub, assignment)
        if gang_requeue:
            info = gang["info"]
            info["hopeless"] = sum(1 for g in gang_requeue if g in gang["hopeless"])
            # gang preemption: solver-vetoed gangs get ONE victim-cover
            # attempt; the context is built only when such a gang exists
            ctx = None
            if self.gangpreempt is not None and any(
                    g in gang["solver_vetoed"] and g not in gang["hopeless"]
                    for g in gang_requeue):
                ctx = self.gangpreempt.build_ctx(snapshot, cluster, sub, assignment,
                                                 gang["need"])
            self._requeue_gangs(gang_requeue, sub.gang_keys or [], gang["hopeless"],
                                gang["solver_vetoed"], ctx, info)
        if rejected or gang_requeue:
            clock.mark("reject")
            trace.step("Handled rejects", rejected=len(rejected))
        else:
            clock.skip()

    def _rollback_undispatched(self, e, to_bind, bind_gang, dispatched, use_columnar,
                               accounted, batch_has_ports, out: Dict) -> int:
        """Assume/dispatch failure domain: roll back every to_bind entry at
        index >= `dispatched` (its chunk never reached the bind path) and
        requeue it with backoff. Before _columnar_account ran, the rollback
        is the STRUCTURAL inverse (the scatter-add never added the totals);
        after it, forget_pod is the exact inverse. A failure INSIDE
        _columnar_account leaves the few already-poked nodes over-counted
        (the safe direction) until the diff path requantizes or
        resync_from_store rebuilds."""
        stranded = to_bind[dispatched:]
        if not stranded:
            return 0
        released = [assumed for _qp, _node, assumed in stranded]
        if use_columnar and not accounted:
            self.cache.forget_pods_structural(released, check_ports=batch_has_ports)
        else:
            for assumed in released:
                self.cache.forget_pod(assumed)
        if bind_gang:
            for i in range(dispatched, len(to_bind)):
                if bind_gang[i] >= 0:
                    self.gangs.note_forgotten(to_bind[i][2])
        self.queue.add_backoff([qp for qp, _node, _assumed in stranded])
        self.retry_counts["dispatch"] += len(stranded)
        metrics.batch_retries_total.inc(len(stranded), stage="dispatch", reason=type(e).__name__)
        sink = self._batch_reasons
        if sink is not None:
            sink["DispatchError"] = sink.get("DispatchError", 0) + len(stranded)
        out["batch_error"] = f"{type(e).__name__}: {e}"[:200]
        self.recorder.event(
            stranded[0][0].pod, "Warning", "SchedulerError",
            f"assume/dispatch failed ({type(e).__name__}: {str(e)[:120]}); "
            f"{len(stranded)} assumed pod(s) rolled back and requeued")
        return len(stranded)

    def _columnar_account(self, batch, cluster, snapshot, bind_rows, bind_nodes,
                          has_ports: bool = True) -> None:
        """Phase 2 of the columnar assume: the per-node requested-resource
        deltas of the whole solved batch as ONE scatter-add keyed by the
        tensorizer's node index (the g++ commit_deltas, which releases the
        GIL, so NO lock is held here; HOSTSCHED_NATIVE_COMMIT=0 selects the
        numpy version), one Resource poke a touched node in the cache, and,
        when nothing foreign intervened and no host ports are in play, a
        direct feed of TensorCache's generation diff: the next batch skips
        the per-node requantize walk and kernel B scatters exactly the
        touched rows."""
        rows = np.asarray(bind_rows, dtype=np.int64)
        nodes = np.asarray(bind_nodes, dtype=np.int64)
        deltas = native_commit_deltas if hostcommit.selected() else commit_deltas_plain
        d_used, d_used_nz, d_count, touched = deltas(rows, nodes, batch.raw_req,
                                                     batch.raw_req_nz, cluster.n)
        final_gen = self.cache.apply_node_resource_deltas(
            cluster.resource_dims,
            [(cluster.node_names[i], d_used[i], d_used_nz[i]) for i in touched],
            expected_gen=snapshot.generation)
        if final_gen is not None and not has_ports:
            self._tensor_cache.apply_assume_deltas(
                touched, d_used[touched], d_used_nz[touched], d_count[touched],
                tensorized_gen=snapshot.generation, assume_gen=final_gen)

    def _requeue_gangs(self, groups: Dict[int, List[QueuedPodInfo]], keys: List[str],
                       hopeless, preempt_gids, preempt_ctx, gang_info: Dict) -> None:
        """A vetoed (or assume-rolled-back) gang re-enters the queue AS A
        UNIT, with one shared backoff expiry (add_gang_backoff) and one
        FailedScheduling event per gang. A hopeless gang (min_member beyond
        what one solve can see) parks unschedulable with a diagnostic. A
        SOLVER-vetoed gang first tries a victim cover: a fired cover PARKS
        the gang (not a failure); a veto or an inapplicable attempt falls
        through to the unit requeue."""
        for gid, members in groups.items():
            key = keys[gid] if 0 <= gid < len(keys) else "<unknown>"
            if gid in hopeless:
                status = Status.unschedulable(
                    f"pod group {key} needs more members than the solver batch size "
                    f"({self.batch_size}) can place together; raise batch_size or lower "
                    "minMember", plugin="GangScheduling")
                for m in members:
                    self._handle_failure(m, status)
                continue
            if preempt_ctx is not None and gid in preempt_gids:
                got = self.gangpreempt.try_preempt(key, gid, members, preempt_ctx)
                # trace timeline: one instant an ATTEMPT (a gang, never a
                # member)
                if _tracebuf.ACTIVE is not None:
                    fired = got is not None and not got.get("vetoed")
                    _tracebuf.ACTIVE.instant(
                        self._thread_label("sched"),
                        "gang_preempt:%s" % ("fired" if fired else "vetoed"), cat="gang",
                        args={"gang": key, "victims": (got or {}).get("victims", 0)})
                if got is not None and not got.get("vetoed"):
                    gang_info["preempted"] = gang_info.get("preempted", 0) + 1
                    gang_info["preempt_victims"] = (gang_info.get("preempt_victims", 0)
                                                    + got["victims"])
                    gang_info["cover_cost"] = gang_info.get("cover_cost", 0) + got["cost"]
                    if self._batch_reasons is not None:
                        self._batch_reasons["GangPreemption"] = (
                            self._batch_reasons.get("GangPreemption", 0) + len(members))
                    continue
                if got is not None:
                    gang_info["preempt_vetoed_partial"] = (
                        gang_info.get("preempt_vetoed_partial", 0) + 1)
            self.failed_count += len(members)
            if self._batch_reasons is not None:
                self._batch_reasons["GangScheduling"] = (
                    self._batch_reasons.get("GangScheduling", 0) + len(members))
            for m in members:
                m.unschedulable_plugins = ("GangScheduling",)
            self.recorder.event(
                members[0].pod, "Warning", "FailedScheduling",
                f"pod group {key}: {len(members)} member(s) cannot be placed together "
                "(all-or-nothing); gang requeued")
            self.queue.add_gang_backoff(members)

    def _rank_align_assignment(self, cluster, sub, assignment, gang_info: Dict) -> np.ndarray:
        """Within each (gang, class, request) group, where members are
        interchangeable, permute WHICH member gets WHICH node so rank order
        follows ring position (kernel H). The node multiset is untouched:
        feasibility, capacity and the veto see the same placements. Records
        the mean neighbor distance before and after in gang_info: that
        telemetry is pure-Python per member, so like every non-essential
        measurement it rides the flight recorder's switch."""
        slice_ids, pos = node_slice_positions(cluster)
        if slice_ids is None:
            return assignment  # no slice topology: adjacency is moot
        a = np.asarray(assignment, dtype=np.int64)
        gop = np.asarray(sub.gang_of_pod)
        ranks = np.asarray(sub.gang_rank, dtype=np.int64)
        groups = alignment_groups(gop, np.asarray(sub.class_of_pod), np.asarray(sub.req),
                                  np.asarray(sub.req_nz))
        # rank-less members order AFTER ranked siblings, by row
        eff_rank = np.where(ranks >= 0, ranks, 1_000_000 + np.arange(len(ranks)))
        # position key: slice-major ring position of the assigned node;
        # unlabeled nodes after every labeled one, unplaced last
        stride = cluster.n + 1
        node_key = np.where(slice_ids >= 0, slice_ids * stride + np.maximum(pos, 0),
                            2**28 + np.arange(cluster.n))
        pos_key = np.where(a >= 0, node_key[np.maximum(a, 0)], 2**30)
        aligned = rank_align(a, groups, eff_rank, pos_key, device=self.device)
        if not self.flightrec.enabled:
            return aligned.astype(np.int32)
        ranked = ranks >= 0
        ring_len = ring_lengths(slice_ids, pos)

        def dist(assign):
            ok = ranked & (assign >= 0)
            sl = np.where(ok, slice_ids[np.maximum(assign, 0)], -1)
            pp = np.where(ok, pos[np.maximum(assign, 0)], -1)
            return mean_neighbor_distance(np.where(ranked, gop, -1).tolist(), ranks.tolist(),
                                          sl.tolist(), pp.tolist(), ring_len)

        pre, post = dist(a), dist(aligned)
        if pre is not None:
            gang_info["adjacency_pre"] = round(pre, 3)
        if post is not None:
            gang_info["adjacency_post"] = round(post, 3)
        gang_info["rank_aligned"] = int((aligned != a).sum())
        return aligned.astype(np.int32)

    # -- the bind pipeline (JAX batch.py :1676-2031) ---------------------------

    def _ensure_bind_worker(self) -> None:
        if self._bind_worker is not None and not self._bind_worker.is_alive():
            # a hard-dead worker's in-flight chunks and task_done debt are
            # recovered BEFORE a replacement starts: its first cycle would
            # overwrite the shared _bind_inflight record
            self._recover_dead_worker()
        if self._bind_worker is None:
            # the queue is BOUND at thread start: a resync swaps self._bind_q
            # for a fresh queue, and the old worker keeps draining (and
            # exits on) the queue it was born with
            self._bind_worker = threading.Thread(
                target=self._bind_loop, args=(self._bind_q,), daemon=True,
                name=f"{self._bind_origin}-bind")
            self._bind_worker.start()
            if self.resource_sampler is not None:
                # re-registering the label points the CPU column at the
                # replacement worker (a restart keeps one column)
                self.resource_sampler.register_thread(self._thread_label("bind"),
                                                      self._bind_worker)

    def _bind_loop(self, q: _queue.Queue) -> None:
        """The SUPERVISED bind worker: an exception that escapes a cycle
        (past _bind_batch's own error handling) is counted and the loop
        continues, after _bind_cycle requeued the in-flight chunk for ONE
        retry. An injected FaultKill is a hard thread death, recovered by the
        liveness check in _drain_bind_results."""
        while True:
            try:
                if self._bind_cycle(q):
                    return
            except FaultKill:
                # hard death by design: the in-flight chunk stays recorded,
                # its task_done debt unsettled, as a real thread-killing
                # failure leaves them; the liveness check recovers both
                return
            except Exception:
                with self._bind_err_lock:
                    self.bind_worker_restarts += 1

    def _bind_cycle(self, q: _queue.Queue) -> bool:
        """One drain cycle: the items queued at wake-up are merged up to
        bind_chunk pods a bind_many + confirm, so commit(N) runs while the
        scheduling thread works on batch N+1. Returns True on the shutdown
        sentinel. The merged chunks are recorded in _bind_inflight BEFORE the
        commit and cleared, their task_done debt settled, on every handled
        path; only a hard kill leaves them recorded."""
        item = q.get()
        if item is None:
            q.task_done()
            return True
        batches = [item]  # each queue item is a LIST of (qp, node, assumed)
        merged = len(item)
        while merged < self.bind_chunk:
            try:
                nxt = q.get_nowait()
            except _queue.Empty:
                break
            if nxt is None:
                # shutdown mid-merge: put the sentinel back for the NEXT
                # cycle so this cycle's chunk commits normally
                q.put(None)
                q.task_done()
                break
            batches.append(nxt)
            merged += len(nxt)
        with self._bind_err_lock:
            self._bind_inflight = batches
        handled = False
        try:
            if faultinject.ACTIVE is not None:
                faultinject.ACTIVE.fire("bind.worker")
            self._bind_batch([t for b in batches for t in b])
            handled = True
        except Exception:
            self._requeue_inflight(batches, q)
            handled = True
            raise  # the supervisor counts the escape
        finally:
            if handled:
                with self._bind_err_lock:
                    self._bind_inflight = []
                for _ in batches:
                    q.task_done()
        return False

    def _requeue_inflight(self, batches, q: _queue.Queue) -> None:
        """Give each escaped in-flight chunk ONE more trip through the bind
        queue; a chunk that already retried fails its pods through the
        normal bind-error path (requeued by _drain_bind_results)."""
        for b in batches:
            if isinstance(b, _RequeuedChunk):
                with self._bind_err_lock:
                    for qp, _node, assumed in b:
                        self.cache.forget_pod(assumed)
                        self.gangs.note_forgotten(assumed)
                        self._bind_errors.append((qp, Status.error(
                            "bind worker failed twice on this chunk")))
            else:
                q.put(_RequeuedChunk(b))
        n = sum(len(b) for b in batches)
        with self._bind_err_lock:
            self.retry_counts["worker"] += n
        # pods, not chunks: the series' unit at every requeue stage
        metrics.batch_retries_total.inc(n, stage="worker", reason="escaped")

    def _check_bind_worker_alive(self) -> None:
        """Dead-worker liveness check, run every drain: recover a hard-dead
        worker's stranded chunks and task_done debt, and restart the worker
        if work remains."""
        w = self._bind_worker
        if w is None or w.is_alive():
            return
        self._recover_dead_worker()
        if self._bind_q.unfinished_tasks:
            self._ensure_bind_worker()

    def _recover_dead_worker(self) -> None:
        """Settle a hard-dead worker's estate (on the scheduling thread, by
        whichever of the liveness drain and the enqueue path sees the death
        first): requeue its in-flight chunks for the supervised retry, settle
        their task_done debt, count the restart, and clear the worker so
        _ensure_bind_worker starts a replacement."""
        with self._bind_err_lock:
            inflight, self._bind_inflight = self._bind_inflight, []
            self.bind_worker_restarts += 1
        self._bind_worker = None
        if inflight:
            self._requeue_inflight(inflight, self._bind_q)
            for _ in inflight:
                self._bind_q.task_done()  # the dead worker's unmatched gets

    def _bind_batch(self, items) -> None:
        """One bind sub-batch, timed into `bind_seconds["bind"]`, the flight
        recorder's "bind" outside bucket and the stage histogram; an armed
        trace ring gets one slice on the bind track."""
        t0 = time.perf_counter()
        try:
            self._bind_batch_inner(items)
        finally:
            t1 = time.perf_counter()
            self.bind_seconds["bind"] += t1 - t0
            self.flightrec.add_outside("bind", t1 - t0)
            metrics.batch_stage_duration.observe(t1 - t0, "bind")
            if _tracebuf.ACTIVE is not None:
                _tracebuf.ACTIVE.note_span(self._thread_label("bind"), "bind_chunk", t0, t1,
                                           cat="bind", args={"pods": len(items)})
            self.flightrec.note_self_time(time.perf_counter() - t1)

    def _bind_batch_inner(self, items) -> None:
        """bind_many in chunks of bind_chunk (each holds the store locks
        once); a chunk whose retries are exhausted fails ONLY its own pods.
        Then the confirm: on the coalesced pipeline the bulk self-confirm
        (our own origin-tagged events are skipped on ingest), on the per-pod
        oracle finish_binding_bulk (the TTL; the events confirm)."""
        triples = [(qp.pod.metadata.namespace, qp.pod.metadata.name, node)
                   for qp, node, _assumed in items]
        errors = []
        for lo in range(0, len(triples), self.bind_chunk):
            chunk = triples[lo:lo + self.bind_chunk]
            exc = self._bind_chunk_with_retry(chunk, errors)
            if exc is not None:
                errors.extend((f"{ns}/{name}", str(exc)) for ns, name, _node in chunk)
        # the pod tracer: ONE commit stamp for the whole chunk; the confirm
        # stamp is read after the assume-confirm settles below
        pt = self.podtrace
        t_commit = self.clock.now() if pt.enabled else 0.0
        if not errors:
            if self.watch_coalesce:
                pairs = [(qp.pod.key, node) for qp, node, _a in items]
                leftover = self.cache.confirm_assumed_bulk(pairs)
                with self._bind_err_lock:
                    self._bind_successes += len(items)
                    if leftover:
                        self._bind_confirm_leftovers.extend(items[i][2] for i in leftover)
            else:
                self.cache.finish_binding_bulk([a for _qp, _node, a in items])
                with self._bind_err_lock:
                    self._bind_successes += len(items)
            if pt.enabled:
                pt.chunk_bound(items, t_commit, self.clock.now())
            return
        errmap = dict(errors)
        confirm = []
        with self._bind_err_lock:
            for qp, node, assumed in items:
                msg = errmap.get(qp.pod.key)
                if msg is None:
                    if self.watch_coalesce:
                        confirm.append((qp.pod.key, node, assumed))
                    else:
                        self.cache.finish_binding(assumed)
                    self._bind_successes += 1
                else:
                    self.cache.forget_pod(assumed)
                    self.gangs.note_forgotten(assumed)
                    self._bind_errors.append((qp, Status.error(msg)))
            if confirm:
                leftover = self.cache.confirm_assumed_bulk([(k, nd) for k, nd, _a in confirm])
                self._bind_confirm_leftovers.extend(confirm[i][2] for i in leftover)
        if pt.enabled:
            # the failed pods stay out of the latency histogram and the
            # sampled stamps: they re-enter the queue and bind later
            pt.chunk_bound(items, t_commit, self.clock.now(), errkeys=frozenset(errmap))

    def _bind_chunk_with_retry(self, chunk, errors) -> Optional[Exception]:
        """One chunk's bind_many with transient-failure retry: an EXCEPTION
        from bind_many is infrastructure (per-pod conflicts come back in the
        error list and are never retried), so the chunk retries up to
        bind_retries times under exponential backoff with jitter before its
        pods are declared failed. Returns the last exception, or None. Runs
        with NO lock held: the sleeps stall only the bind path."""
        last: Optional[Exception] = None
        for attempt in range(self.bind_retries + 1):
            if attempt:
                with self._bind_err_lock:
                    self.retry_counts["bind"] += 1
                metrics.batch_retries_total.inc(stage="bind", reason="transient")
                time.sleep(self.bind_retry_base_s * (2 ** (attempt - 1))
                           * (1.0 + _random.random()))
            try:
                _bound, errs = self.store.bind_many(chunk, origin=self._bind_origin)
                errors.extend(errs)
                return None
            except Exception as e:
                last = e
        return last

    def _drain_bind_results(self) -> None:
        """Fold completed binds into the counters and re-handle failures on
        the scheduling thread (handleBindingCycleError -> requeue); also log
        them for take_bind_failures. Does not wait for in-flight binds. Runs
        the dead-worker liveness check."""
        if self.pipeline_binds:
            self._check_bind_worker_alive()
        with self._bind_err_lock:
            done, self._bind_successes = self._bind_successes, 0
            errs, self._bind_errors = self._bind_errors, []
            leftovers, self._bind_confirm_leftovers = self._bind_confirm_leftovers, []
        self.scheduled_count += done
        for pod in leftovers:
            # the worker-side confirm missed (expired assume, foreign write):
            # re-read the COMMITTED object (the assume-time object is stale,
            # and the pod may be gone) and ingest it like a foreign MODIFIED
            try:
                cur = self.store.get("pods", pod.key)
            except NotFoundError:
                continue
            self._handle_pod(MODIFIED, cur)
        if errs:
            self.flightrec.note_bind_failures(
                [(qp.pod.key, status.message()) for qp, status in errs])
        failures = self.bind_failures
        csink = self.conflict_sink
        for qp, status in errs:
            msg = status.message()
            if csink is not None and is_bind_conflict(msg):
                # a lost cross-partition bind race: the conflict is a FACT
                # (the pod is bound, the store decided the winner), so this
                # pipeline drops it (the assume was forgotten on the error
                # path) and the coordinator counts the absorbed race.
                # Requeueing would schedule a bound pod.
                self.partition_conflicts += 1
                csink(qp, msg)
                continue
            if len(failures) == failures.maxlen:
                self.bind_failures_dropped += 1
            failures.append((qp.pod.key, msg))
            self._handle_failure(qp, status)

    def take_bind_failures(self) -> List:
        """Drain the (pod key, error message) log of the bind failures seen
        since the last call (the pods were already requeued)."""
        out = list(self.bind_failures)
        self.bind_failures.clear()
        return out

    def flush_binds(self) -> None:
        """Wait for the queued bind writes, then drain their results. The wait
        (`bind_seconds["bind_wait"]`) wakes on task_done and re-checks the
        worker between naps, so a dead worker is replaced and its chunk
        requeued instead of wedging the flush."""
        t0 = time.perf_counter()
        if self._bind_worker is not None:
            q = self._bind_q
            while True:
                with q.all_tasks_done:
                    if not q.unfinished_tasks:
                        break
                    q.all_tasks_done.wait(timeout=0.05)
                self._check_bind_worker_alive()
        waited = time.perf_counter() - t0
        self.bind_seconds["bind_wait"] += waited
        self.flightrec.add_outside("bind_wait", waited)
        self._drain_bind_results()

    def stop(self) -> None:
        """Stop the watch like the base class, and release the bind worker
        (parked in q.get() it would pin this scheduler's object graph). Items
        queued before the sentinel still commit."""
        super().stop()
        if self._bind_worker is not None:
            self._bind_q.put(None)
            self._bind_q = _queue.Queue()
            self._bind_worker = None

    # -- idle loops, resync, stats --------------------------------------------

    def run_until_idle(self, max_cycles: int = 10_000) -> int:
        """Drive batches until the active queue drains; before declaring idle,
        flush the in-flight binds (which may requeue failures), pump events
        and sweep the expired assumes and parked gangs; at idle, let an
        attached rebalancer take a paced cycle; flush once more at the end."""
        n = 0
        while n < max_cycles:
            if self.schedule_batch() == 0:
                self.flush_binds()
                self.pump_events()
                self.sweep_expired_assumes()
                if self.schedule_batch() == 0:
                    # idle: migrations emit create/delete events, so loop
                    # once more to ingest them before declaring idle for real
                    if self.rebalancer is not None:
                        r = self.rebalancer.maybe_cycle()
                        if r is not None and r.get("migrations"):
                            n += 1
                            continue
                    break
            n += 1
        self.flush_binds()
        return n

    def enable_rebalancer(self, **kwargs):
        """Attach a background Rebalancer (scheduler/rebalance.py); kwargs
        pass through to its constructor. run_until_idle's idle path paces it
        through maybe_cycle(), and rebalance_stats() publishes its totals.
        Returns it."""
        from .rebalance import Rebalancer

        self.rebalancer = Rebalancer(self, **kwargs)
        return self.rebalancer

    def sweep_expired_assumes(self) -> List[str]:
        """The base sweep (the cache's expired assumes: gang quorums counted
        back out, pending pods requeued) plus the gang preemptor's deadline:
        a cover whose victim deletions stalled releases its parked gang to
        the normal retry ladder. Returns the expired pod keys."""
        expired = super().sweep_expired_assumes()
        if self.gangpreempt is not None:
            self.gangpreempt.sweep(self.clock.now())
        return expired

    def resync_from_store(self) -> Dict[str, int]:
        """Rebuild all scheduler state from the store, as a restarted
        scheduler would: the in-flight binds flushed (their pods are then
        either bound or pending in the store, which decides), the bind
        pipeline restarted empty, a fresh cache and queue from the LIST, the
        tensor cache and in-flight cover tracking dropped. Returns {nodes,
        bound, pending, dropped_assumes}."""
        self.flush_binds()
        dropped = self.cache.assumed_count()
        if self._bind_worker is not None:
            self._bind_q.put(None)  # the old worker exits on its own queue
        self._bind_q = _queue.Queue()
        self._bind_worker = None
        with self._bind_err_lock:
            self._bind_inflight = []
            self._bind_errors = []
            self._bind_successes = 0
            self._bind_confirm_leftovers = []
        self._tensor_cache = TensorCache()
        if self.gangpreempt is not None:
            self.gangpreempt.reset()
        self.queue.clear()
        counts = self._rebuild_from_store(preserve_queue=False)
        counts["dropped_assumes"] = dropped
        return counts

    def _preemption_plugin(self, fw: Framework) -> Optional[DefaultPreemption]:
        """The profile's DefaultPreemption: the per-pod dry run and the victim
        executor the gang preemptor fires through."""
        for p in fw.post_filter_plugins:
            if isinstance(p, DefaultPreemption):
                return p
        return None

    def _hard_pod_affinity_weight(self) -> int:
        """InterPodAffinity's hardPodAffinityWeight from the profiles (the
        tensorizer encodes one value for the batch, as the JAX package does)."""
        for fw in self.profiles.values():
            for p in fw.plugins:
                if p.name == "InterPodAffinity":
                    return getattr(p, "hard_pod_affinity_weight", 1)
        return 1

    # -- device rejects: preemption (JAX batch.py :1095-1371) ----------------

    def _handle_device_rejects(self, rejected, snapshot, cluster, sub, assignment) -> None:
        """Failure handling for the pods the device solver could not place,
        rejected = [(row in sub, qp)].

        When the batch is constraint-free (no PTS DoNotSchedule rows, no
        inter-pod affinity), preemption candidates come from dense
        priority-tier tensors (_batch_preempt), the vector analog of the
        reference's DryRunPreemption (preemption.go:680), and only the single
        chosen node per pod is verified with the serial filters. Constrained
        batches keep the serial PostFilter path, because evicting victims can
        change PTS/IPA feasibility in ways the tier math does not model."""
        if self.cache.columnar_rows():
            # placements of earlier batches held as columnar rows have no
            # PodInfo, so the victim walk below cannot see them: collapse
            # them and patch the local (pre-batch) snapshot clones in place.
            # Rows of THIS batch stay out of the patch: the dry run sees
            # those through placed_by_node, and the next update_snapshot
            # re-clones every touched node anyway.
            batch_keys = {p.key for p in sub.pods}
            mat: list = []
            self.cache.materialize_columnar_rows(mat)
            for node_name, pi in mat:
                if pi.pod.key in batch_keys:
                    continue
                ni = snapshot.node_info_map.get(node_name)
                if ni is not None:
                    # a raw append: the scatter-add already folded the
                    # resources into this clone; keep len(pods) + col_count
                    # exact
                    ni.pods.append(pi)
                    ni.col_count -= 1
        # post-batch capacity: fold every in-batch assignment into used state
        used = cluster.used.astype(np.int64).copy()
        pod_count = cluster.pod_count.astype(np.int64).copy()
        a = np.asarray(assignment)
        placed = a >= 0
        if placed.any():
            np.add.at(used, a[placed], sub.req[placed])
            np.add.at(pod_count, a[placed], 1)
        alloc = cluster.alloc.astype(np.int64)
        max_pods = cluster.max_pods.astype(np.int64)
        filter_ok = sub.tables.filter_ok
        node_names = cluster.node_names
        n = len(node_names)

        if sub.ct_class.size == 0 and not sub.ipa.has_any:
            # in-batch placements per node: the verify step must see them
            placed_by_node: Dict[int, List] = {}
            for jj in np.nonzero(placed)[0].tolist():
                placed_by_node.setdefault(int(a[jj]), []).append(sub.pods[jj])
            remaining = self._batch_preempt(rejected, snapshot, cluster, sub, alloc, used,
                                            pod_count, max_pods, placed_by_node)
            # the tier math is at least as permissive as the serial dry run
            # for constraint-free pods (it ignores port conflicts), so a pod
            # with no tier candidate has no serial candidate either
            for _j, qp in remaining:
                # attributed to Fit so the hints fire on node capacity and
                # assigned-pod-freed events
                self._handle_failure(qp, Status.unschedulable(
                    f"0/{n} nodes are available", plugin="NodeResourcesFit"))
            return

        # Constrained batch: the per-node failure map (shared Status
        # instances per category) and the serial PostFilter.
        unres = Status.unresolvable("node(s) didn't match the pod's static predicates")
        nofit = Status.unschedulable("Insufficient resources on the node")
        inbatch = Status.unschedulable("node rejected by in-batch constraints")
        names_arr = np.array(node_names)
        for j, qp in rejected:
            pod = qp.pod
            cls = int(sub.class_of_pod[j])
            req = sub.req[j].astype(np.int64)
            fits = np.all((req[None, :] == 0) | (req[None, :] <= alloc - used),
                          axis=1) & (pod_count + 1 <= max_pods)
            static_ok = filter_ok[cls]
            failed = {}
            failed.update(zip(names_arr[~static_ok].tolist(), itertools.repeat(unres)))
            failed.update(zip(names_arr[static_ok & ~fits].tolist(), itertools.repeat(nofit)))
            failed.update(zip(names_arr[static_ok & fits].tolist(), itertools.repeat(inbatch)))
            fw = self._fw(pod) or self.framework
            state = CycleState()
            fw.run_pre_filter(state, pod, snapshot)
            result = ScheduleResult(status=Status.unschedulable(f"0/{n} nodes are available"),
                                    failed_nodes=failed, state=state, evaluated_nodes=n)
            self._maybe_preempt(qp, result)
            self._handle_failure(qp, result.status, result.failed_nodes)

    def _batch_preempt(self, rejected, snapshot, cluster, sub, alloc, used, pod_count,
                       max_pods, placed_by_node):
        """Tiered batch preemption (reference: preemption.go DryRunPreemption
        :680 + SelectCandidate :396, reframed as numpy tensor math).

        For each rejected pod at priority p, the candidate nodes are those
        where the pod fits after evicting every pod with priority < p, from
        dense [N, R] freed-capacity tensors built once per distinct tier. The
        nodes are ranked in pick_one_node_for_preemption's order (fewest PDB
        violations, lowest max victim priority, smallest priority sum,
        fewest victims, index) and capped at
        max(MIN_CANDIDATE_NODES_ABSOLUTE, n * PERCENTAGE // 100). Only the
        chosen node runs the serial dry run (DefaultPreemption._dry_run_node:
        the MINIMAL victim set through the reprieve and exact PDB
        accounting); its victims update the tier tensors in place, so later
        pods in the batch see the new capacity.

        Returns the (j, qp) pairs that could not be preempted."""
        n = cluster.n
        r = len(cluster.resource_dims)
        # bound pods as victim arrays (one snapshot pass), shared with the
        # gang victim cover
        v_node, v_prio, v_req, v_pods, node_victims = flatten_snapshot_victims(
            snapshot, cluster.resource_dims)
        if not v_pods:
            return list(rejected)
        v_alive = np.ones(len(v_pods), dtype=bool)

        plugin_by_fw: Dict[int, tuple] = {}

        def plugin_for(pod):
            fw = self._fw(pod) or self.framework
            got = plugin_by_fw.get(id(fw))
            if got is None:
                got = (fw, self._preemption_plugin(fw))
                plugin_by_fw[id(fw)] = got
            return got

        # PDB exhaustion per victim (an approximate violation count for node
        # selection; the serial dry run on the chosen node is exact), listed
        # from the store: a profile without DefaultPreemption must not blind
        # the batch to budgets
        pdbs, _ = self.store.list("poddisruptionbudgets")
        v_pdb_blocked = np.zeros(len(v_pods), dtype=bool)
        if pdbs:
            for vi, p in enumerate(v_pods):
                v_pdb_blocked[vi] = any(
                    pd.metadata.namespace == p.metadata.namespace
                    and pd.selector is not None
                    and pd.selector.matches(p.metadata.labels)
                    and pd.disruptions_allowed <= 0
                    for pd in pdbs)

        tier_cache: Dict[int, list] = {}

        def tier(p):
            got = tier_cache.get(p)
            if got is None:
                mask = v_alive & (v_prio < p)
                freed = np.zeros((n, r), np.int64)
                np.add.at(freed, v_node[mask], v_req[mask])
                cnt = np.zeros(n, np.int64)
                np.add.at(cnt, v_node[mask], 1)
                psum = np.zeros(n, np.int64)
                np.add.at(psum, v_node[mask], v_prio[mask])
                viol = np.zeros(n, np.int64)
                if pdbs:
                    np.add.at(viol, v_node[mask & v_pdb_blocked], 1)
                pmax = np.full(n, -(2**31), np.int64)
                np.maximum.at(pmax, v_node[mask], v_prio[mask])
                got = [freed, cnt, psum, viol, pmax]
                tier_cache[p] = got
            return got

        filter_ok = sub.tables.filter_ok
        node_names = cluster.node_names
        remaining = []
        nominated_by_node: Dict[int, List] = {}
        for j, qp in rejected:
            pod = qp.pod
            fw, plugin = plugin_for(pod)
            if plugin is None or pod.spec.preemption_policy == "Never":
                remaining.append((j, qp))
                continue
            p = pod.spec.priority
            cls = int(sub.class_of_pod[j])
            req = sub.req[j].astype(np.int64)
            freed, cnt, psum, viol, pmax = tier(p)
            fits = np.all((req[None, :] == 0) | (req[None, :] <= alloc - used + freed), axis=1)
            fits &= pod_count + 1 - cnt <= max_pods
            cand_mask = fits & filter_ok[cls] & (cnt > 0)
            if not cand_mask.any():
                remaining.append((j, qp))
                continue
            idxs = np.nonzero(cand_mask)[0]
            order = np.lexsort((idxs, cnt[idxs], psum[idxs], pmax[idxs], viol[idxs]))
            # candidate cap mirrors GetOffsetAndNumCandidates (preemption.go:595)
            num_candidates = max(plugin.MIN_CANDIDATE_NODES_ABSOLUTE,
                                 n * plugin.MIN_CANDIDATE_NODES_PERCENTAGE // 100)
            state = CycleState()
            _, st = fw.run_pre_filter(state, pod, snapshot)
            chosen = None
            if st.is_success():
                for oi in order[:num_candidates]:  # best-ranked first
                    nn = int(idxs[oi])
                    ni = snapshot.node_info_list[nn]
                    # the snapshot NodeInfo is pre-batch: drop victims an
                    # earlier pod of this batch already claimed and add the
                    # in-batch placements and nominations, or the dry run
                    # re-selects dead victims and frees nothing
                    dead = [v_pods[vi] for vi in node_victims[nn] if not v_alive[vi]]
                    extra = list(placed_by_node.get(nn, ()))
                    extra += nominated_by_node.get(nn, [])
                    if dead or extra:
                        ni = ni.clone()
                        for dp in dead:
                            ni.remove_pod(dp)
                        for xp in extra:
                            ni.add_pod(PodInfo(xp))
                    got = plugin._dry_run_node(state, pod, ni, pdbs)
                    if got is not None:
                        chosen = (nn, got)
                        break
            if chosen is None:
                remaining.append((j, qp))
                continue
            nn, cand = chosen
            victims = cand.victims
            self.preempt_victims_total += len(victims)
            vkeys = {v.key for v in victims}
            freed_now = np.zeros(r, np.int64)
            for vi in node_victims[nn]:
                if v_alive[vi] and v_pods[vi].key in vkeys:
                    v_alive[vi] = False
                    freed_now += v_req[vi]
                    for tp, (tfreed, tcnt, tpsum, tviol, _tmax) in tier_cache.items():
                        if v_prio[vi] < tp:
                            tfreed[nn] -= v_req[vi]
                            tcnt[nn] -= 1
                            tpsum[nn] -= v_prio[vi]
                            if v_pdb_blocked[vi]:
                                tviol[nn] -= 1
            # the max victim priority can only be recomputed, not decremented
            for tp, arrs in tier_cache.items():
                alive = [int(v_prio[vi]) for vi in node_victims[nn]
                         if v_alive[vi] and v_prio[vi] < tp]
                arrs[4][nn] = max(alive) if alive else -(2**31)
            used[nn] += req - freed_now
            pod_count[nn] += 1 - len(victims)
            nominated_by_node.setdefault(nn, []).append(pod)
            plugin._prepare_candidate(cand, pod)
            qp.pod.status.nominated_node_name = node_names[nn]
            self.preemption_count += 1
            self._handle_failure(qp, Status.unschedulable(
                f"preempted {len(victims)} pod(s) on {node_names[nn]}; "
                "waiting for victims to terminate", plugin="NodeResourcesFit"))
        return remaining

    def gang_stats(self) -> Optional[Dict]:
        """sched_stats()["gang"]: None while no PodGroup exists. Sets the
        quorum-expired-assumes gauge."""
        if not self.gangs.active:
            return None
        expired = self.gangs.quorum_expired_count(self.cache.contains)
        metrics.gang_quorum_expired_assumes.set(expired)
        return {"staged": self.queue.gang_staged_count(),
                "parked": self.queue.gang_parked_count(),
                "vetoes": self.gang_vetoes,
                "quorum_expired_assumes": expired,
                "preemption": (self.gangpreempt.stats()
                               if self.gangpreempt is not None else None)}

    def rebalance_stats(self) -> Optional[Dict]:
        """sched_stats()["rebalance"]: the fragmentation score and the
        migration/wave/abort totals; None until enable_rebalancer()."""
        return self.rebalancer.stats() if self.rebalancer is not None else None

    # -- observability (JAX batch.py :1373-1645) -------------------------------

    def _handle_failure(self, qp: QueuedPodInfo, status: Status,
                        failed_nodes: Optional[Dict[str, Status]] = None) -> None:
        """Taps the failure's attribution (plugin, else the reason text) into
        the current batch's flight record, then the shared requeue path.

        Partitioned re-route: an UNSCHEDULABLE verdict from a pipeline that
        sees one node shard is not a cluster verdict — the reroute hook
        offers the pod to the next partition (or the global residual pass)
        instead of parking it, UNLESS preemption nominated a node here
        (victims are terminating on OUR shard; the pod waits locally). A
        re-routed pod is not a failure: no event, no status patch, no
        failed_count."""
        hook = self.reroute_hook
        if (hook is not None and status.code == Code.UNSCHEDULABLE
                and not qp.pod.status.nominated_node_name and hook(qp, status)):
            self.partition_reroutes += 1
            return
        sink = self._batch_reasons
        if sink is not None:
            key = status.plugin or (status.reasons[0][:80] if status.reasons
                                    else status.code.name.lower())
            sink[key] = sink.get(key, 0) + 1
        super()._handle_failure(qp, status, failed_nodes)

    def _update_queue_telemetry(self, want_dict: bool = False) -> Optional[Dict]:
        """Refresh the scheduler_queue_depth{tier} gauges and the oldest-
        pending-age gauge: once a pump (schedule_batch's bookkeeping),
        throttled to once a second of the scheduler clock, because the scan
        is O(queue) under the queue lock. A read (want_dict=True) inside the
        window gets the cached dict instead of a rescan."""
        with self._q_telemetry_lock:
            now = self.clock.now()
            if now < self._q_telemetry_next and self._q_telemetry_last is not None:
                return self._q_telemetry_last if want_dict else None
            self._q_telemetry_next = now + 1.0
        t0 = time.perf_counter()
        tel = self.queue.telemetry()
        for tier in ("active", "backoff", "unschedulable", "gang_staged", "gang_parked"):
            metrics.queue_depth.set(tel[tier], tier=tier)
        metrics.queue_oldest_age.set(tel["oldest_pending_age_s"])
        self.flightrec.note_self_time(time.perf_counter() - t0)
        self._q_telemetry_last = tel
        return tel

    def sched_stats(self) -> Dict:
        """The live counters, the flight recorder's stage table (p50/p99
        columns), the submit->bound latency distribution, the tracer's
        health, the recent time-series windows and the last batch record:
        the payload the JAX package serves at /debug/schedstats (its route
        comes with ROADMAP.md queue 1 item 7g)."""
        tel = self._update_queue_telemetry(want_dict=True)
        # read the windows FIRST: the read settles an expired open window,
        # and the counters below must describe the settled state
        windows = self.timeseries.windows(last=12)
        fr = self.flightrec
        pt = self.podtrace
        return {
            "solver": self.solver,
            "batch_size": self.batch_size,
            "batches_solved": self.batches_solved,
            "scheduled": self.scheduled_count,
            "failed": self.failed_count,
            "preemptions": self.preemption_count,
            "preempt_victims": self.preempt_victims_total,
            "queue": {"active": tel["active"], "backoff": tel["backoff"],
                      "unschedulable": tel["unschedulable"],
                      "gang_staged": tel["gang_staged"],
                      "gang_parked": tel.get("gang_parked", 0),
                      "oldest_pending_age_s": round(tel["oldest_pending_age_s"], 3)},
            "latency": pt.latency_stats(),
            "trace": {"enabled": pt.enabled, "sample_k": pt.sample_k,
                      "completed": pt.completed_total,
                      "live_incomplete": pt.live_incomplete,
                      "windows_rotated": pt.windows_rotated},
            "watch": self._watch_summary(),
            "gang": self.gang_stats(),
            "repair": (dict(self.repair_totals, last=self._last_repair.as_dict())
                       if self._last_repair is not None
                       else dict(self.repair_totals)
                       if self.repair_totals["batches"] else None),
            "breaker": self.breaker.describe(),
            # partitioned mode: this pipeline's shard identity and the
            # absorbed cross-partition races; None standalone
            "partition": ({"index": self.partition_index,
                           "nodes": self.cache.node_count(),
                           "conflicts": self.partition_conflicts,
                           "reroutes": self.partition_reroutes}
                          if self.partition_index is not None else None),
            "rebalance": self.rebalance_stats(),
            "bind_worker": {"restarts": self.bind_worker_restarts,
                            "failures_logged": len(self.bind_failures),
                            "failures_dropped": self.bind_failures_dropped},
            "store_columnar": self.store.columnar_stats(),
            "cache_columnar": self.cache.columnar_stats(),
            "recorder": {"enabled": fr.enabled, "capacity": fr.capacity,
                         "records": len(fr), "self_seconds": round(fr.self_seconds, 6)},
            "tracebuf": _tracebuf.status(),
            "stages": fr.stage_table(),
            "timeseries": {"enabled": self.timeseries.enabled,
                           "window_s": self.timeseries.window_s,
                           "capacity": self.timeseries.capacity,
                           "windows_closed": self.timeseries.windows_closed,
                           "self_seconds": round(self.timeseries.self_seconds, 6)},
            "windows": windows,
            "resource": (self.resource_sampler.summary()
                         if self.resource_sampler is not None else None),
            "last_batch": fr.last(),
        }

    def _register_window_probes(self) -> None:
        """Window-close probes (obs/timeseries.py), each run ONCE a closed
        window: queue depth (O(tiers)), breaker state, watch-bus lag, the
        partition's conflict/reroute counters, pod-object materializations
        and the resource sampler's latest columns. Each reads its attributes
        at fire time (partition_index is installed after __init__)."""
        ts = self.timeseries
        ts.add_probe("queue", lambda: self.queue.depths())
        ts.add_probe("breaker", lambda: {"state": self.breaker.state})
        ts.add_probe("watch", lambda: self.store.watch_lag())
        ts.add_probe("partition", self._partition_window_probe)
        ts.add_probe("resource", self._resource_window_probe)
        # the live zero-object gauge: per-window pod-object materializations
        # across the store's and the cache's columnar rows (0 at the
        # columnar steady state)
        self._alloc_probe_total: Optional[int] = None
        ts.add_probe("alloc", self._alloc_window_probe)

    def _alloc_window_probe(self) -> Dict:
        st = self.store.columnar_stats()
        total = int(self.cache.columnar_materialized()) + (
            int(st.get("materialized_total", 0)) if st is not None else 0)
        prev = self._alloc_probe_total
        self._alloc_probe_total = total
        return {"pod_obj_allocs": total - prev if prev is not None else total,
                "materialized_total": total}

    def _partition_window_probe(self) -> Optional[Dict]:
        if self.partition_index is None:
            return None
        return {"index": self.partition_index,
                "conflicts": self.partition_conflicts,
                "reroutes": self.partition_reroutes}

    def _resource_window_probe(self) -> Optional[Dict]:
        s = self.resource_sampler
        if s is None:
            return None
        last = s.latest()
        if last is None:
            return None
        return {"rss_mb": last["rss_mb"],
                "alloc_blocks": last["alloc_blocks"],
                "gc_collections": last["gc"]["collections"],
                "gc_pause_s": last["gc"]["pause_s"],
                # cumulative sampler self-time at window close (difference
                # consecutive windows for the per-window overhead)
                "sampler_self_s": round(s.self_seconds, 6),
                "threads": {k: v["cpu_s"] for k, v in last["threads"].items()}}

    def _thread_label(self, role: str) -> str:
        return (f"p{self.partition_index}-{role}"
                if self.partition_index is not None else role)

    def attach_resource_sampler(self, sampler) -> None:
        """Wire an obs/resource.py ResourceSampler: its latest columns join
        every closed window (the rss/alloc slope gates' feed), and the bind
        worker registers for per-thread CPU attribution, now if it runs and
        as it spawns. (The scheduling loop thread registers with start(),
        ROADMAP.md queue 1 item 7g.)"""
        self.resource_sampler = sampler
        if sampler is not None and self._bind_worker is not None:
            sampler.register_thread(self._thread_label("bind"), self._bind_worker)

    def _watch_summary(self) -> Dict:
        """The store watch bus seen from this scheduler: settled
        commit->dequeue propagation, subscriber counts and the worst
        delivered-RV lag (one watch_telemetry() call)."""
        try:
            tel = self.store.watch_telemetry()
        except Exception as e:  # a wedged store must not break the read
            return {"error": str(e)}
        subs = tel.get("subscribers") or []
        return {
            "subscribers": len(subs),
            "max_rv_lag": max((s.get("rv_lag", 0) for s in subs), default=0),
            "dropped": tel.get("dropped") or {},
            "propagation": tel.get("propagation") or {},
        }


# plugins that act only on fallback-class pods: for any other pod their
# PreFilter skips, their Filters pass and VolumeBinding scores 0 on every
# node, so the solvers need not encode them, and a profile may change them
# (the per-pod route runs the pod's own profile)
PER_POD_PLUGINS = frozenset(("VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding",
                             "VolumeZone", "DynamicResources"))


def _encoded_view(fw: Framework):
    """What the batch solvers take from a profile as the default profile's:
    the plugins at PreFilter, Filter, PreScore and Score (class and public
    arguments) and their Score weights, without PER_POD_PLUGINS.
    InterPodAffinity's hardPodAffinityWeight is left out: the tensorizer
    reads it from the profile (_hard_pod_affinity_weight)."""
    def plugin(p):
        args = sorted((k, repr(sorted(v) if isinstance(v, (set, frozenset)) else v))
                      for k, v in vars(p).items()
                      if not k.startswith("_") and k != "hard_pod_affinity_weight")
        return p.name, type(p), tuple(args)

    points = tuple(tuple(plugin(p) for p in ps if p.name not in PER_POD_PLUGINS) for ps in (
        fw.pre_filter_plugins, fw.filter_plugins, fw.pre_score_plugins, fw.score_plugins))
    return points, tuple(fw.weights.get(p.name) for p in fw.score_plugins
                         if p.name not in PER_POD_PLUGINS)


def _subset_batch(batch, idx):
    """View of a PodBatchTensors restricted to pod rows idx (class tables shared)."""
    return dataclasses.replace(
        batch,
        pods=[batch.pods[i] for i in idx],
        class_of_pod=batch.class_of_pod[idx],
        req=batch.req[idx],
        req_nz=batch.req_nz[idx],
        balanced_active=batch.balanced_active[idx],
        raw_req=None if batch.raw_req is None else batch.raw_req[idx],
        raw_req_nz=None if batch.raw_req_nz is None else batch.raw_req_nz[idx],
        gang_of_pod=None if batch.gang_of_pod is None else batch.gang_of_pod[idx],
        gang_rank=None if batch.gang_rank is None else batch.gang_rank[idx],
    )
