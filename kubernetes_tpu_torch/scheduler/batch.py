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
The assignments are assumed into the cache and bound through the store. A
solver exception requeues the batch's device pods with backoff and feeds the
circuit breaker (scheduler/breaker.py), which degrades the fast modes to the
scan after `breaker_threshold` consecutive failures.

Not in this slice (each raises or is named where it would act):
  serial fallback classes, preemption, plugins ROADMAP.md queue 1 item 2
  gangs                                       queue 1 item 3
  solver "auction"/"sinkhorn"                 queue 1 item 5
  flight recorder, pod traces, metrics, the solver's Warning event, the
  native commit and pipelined binds           queue 1 item 7
A pod whose class the tensorizer marks fallback_class (DRA claims,
scheduling-relevant volumes, non-default PTS inclusion policies) fails
unschedulable with a reason naming its ROADMAP item and is counted in
`fallback_refused`; it is never placed by another rule. Device rejects
(assignment -1) fail unschedulable with the device's reason and no
preemption, as the JAX package does when no preemption applies.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Optional

import numpy as np

from ..models.repair import repair_solve
from ..models.waterfill import make_groups, waterfill_solve
from ..ops.solver import greedy_scan_solve, make_inputs, resolve_device
from ..snapshot.tensorizer import TensorCache, build_pod_batch
from ..store import MODIFIED, APIStore, NotFoundError, pod_structural_clone
from ..utils import Clock
from .breaker import REPRESENTATIVE, SolverCircuitBreaker
from .framework import Status
from .serial import NOT_PORTED, Scheduler

SOLVERS = ("exact", "fast", "auto")
SOLVER_ROADMAP = {"auction": 5, "sinkhorn": 5, "native": 7}

# InterPodAffinity's hardPodAffinityWeight at its default (the plugin
# argument becomes configurable with the plugins, ROADMAP.md queue 1 item 2)
HARD_POD_AFFINITY_WEIGHT = 1

log = logging.getLogger(__name__)

FALLBACK_REASON = (
    "pod needs the serial fallback path (DRA claims, scheduling-relevant volumes "
    "or a non-default topology-spread inclusion policy), which is "
    + NOT_PORTED.format(2))


class BatchScheduler(Scheduler):
    """Batched scheduler on one device.

    solver: "exact" (default: the scan, bit-parity with the serial
    scheduler), "fast" (waterfill for constraint-free batches,
    propose-and-repair for constrained ones) or "auto" (the same routing).
    device: "cuda" (default) runs the kernels on the card and raises where
    torch.cuda.is_available() is false; "cpu" runs their plain versions.
    framework must be None: the scoring profile is the default plugin set
    that the solver encodes (custom profiles come with ROADMAP.md queue 1
    item 2)."""

    def __init__(self, store: APIStore, framework=None, *, device="cuda",
                 batch_size: int = 4096, solver: str = "exact",
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 30.0,
                 clock: Optional[Clock] = None):
        self.device = resolve_device(device)
        if framework is not None:
            raise NotImplementedError("custom scheduler frameworks are " + NOT_PORTED.format(2))
        if solver not in SOLVERS:
            item = SOLVER_ROADMAP.get(solver)
            if item is None:
                raise ValueError(f"unknown solver {solver!r}")
            raise NotImplementedError(f"solver {solver!r} is " + NOT_PORTED.format(item))
        super().__init__(store, clock=clock)
        self.batch_size = batch_size
        self.solver = solver
        self.bind_chunk = 4096
        self._tensor_cache = TensorCache()
        self.batches_solved = 0
        self.fallback_refused = 0  # fallback-class pods failed unschedulable
        # solver failure domain: the breaker trips the fast modes to the scan
        # after breaker_threshold consecutive solver exceptions
        self.breaker = SolverCircuitBreaker(clock=self.clock, threshold=breaker_threshold,
                                            cooldown_s=breaker_cooldown_s)
        # the solver path the last _solve_device call executed (or was
        # executing when it raised): what the breaker is fed
        self._solve_path = "exact"
        self.last_solver_error: Optional[str] = None
        # propose-and-repair: the last batch's RepairStats + running totals
        self._last_repair = None
        self.repair_totals = {"batches": 0, "rounds": 0, "proposed": 0, "repaired": 0,
                              "residual": 0, "full_scan": 0, "violations": 0}
        # host seconds per stage, summed over batches (the solve stage ends
        # with the assignment's copy to the host, so it includes device time)
        self.stage_seconds = {"tensorize": 0.0, "solve": 0.0, "commit": 0.0}
        self.solve_seconds: deque = deque(maxlen=1024)  # per batch

    def schedule_cycle(self) -> int:
        return self.schedule_batch()

    def schedule_batch(self) -> int:
        """Drain up to batch_size pods, solve jointly, bind. Returns #pods handled."""
        # pump until the watch drains (bounded: sustained arrival must not
        # starve scheduling)
        for _ in range(8):
            if self.pump_events(max_events=self.batch_size) < self.batch_size:
                break
        qps = self.queue.pop_batch(self.batch_size)
        if not qps:
            return 0
        self.batches_solved += 1
        # circuit breaker: the configured solver while CLOSED, the scan while
        # OPEN, a single probe of the configured one when HALF_OPEN
        solver = self.breaker.effective_solver(self.solver)
        self._last_repair = None
        t0 = time.perf_counter()
        snapshot = self.cache.update_snapshot()
        if len(snapshot) == 0:
            for qp in qps:
                self._handle_failure(qp, Status.unschedulable(
                    "no nodes available to schedule pods"))
            return len(qps)
        cluster, changed_nodes = self._tensor_cache.cluster_tensors(snapshot)
        batch = build_pod_batch(
            [qp.pod for qp in qps], snapshot, cluster, ns_labels=self._ns_labels,
            hard_pod_affinity_weight=HARD_POD_AFFINITY_WEIGHT,
            reuse=self._tensor_cache, changed_nodes=changed_nodes)
        fallback_mask = batch.fallback_class[batch.class_of_pod]
        device_idx = np.nonzero(~fallback_mask)[0]
        fallback_idx = np.nonzero(fallback_mask)[0]
        t1 = time.perf_counter()
        self.stage_seconds["tensorize"] += t1 - t0

        if device_idx.size:
            sub = _subset_batch(batch, device_idx)
            try:
                assignment = self._solve_device(solver, cluster, batch, sub)
            except Exception as e:
                # nothing is assumed yet: the device pods requeue as a unit
                self._handle_solver_error(e, qps, device_idx)
                assignment = None
            else:
                self.breaker.record_success(self._solve_path, self.solver)
            t2 = time.perf_counter()
            self.stage_seconds["solve"] += t2 - t1
            self.solve_seconds.append(t2 - t1)
            if assignment is not None:
                self._commit(qps, device_idx, assignment.tolist(), cluster.node_names)
                self.stage_seconds["commit"] += time.perf_counter() - t2
        for pi in fallback_idx.tolist():
            self.fallback_refused += 1
            self._handle_failure(qps[pi], Status.unschedulable(FALLBACK_REASON))
        return len(qps)

    def _solve_device(self, solver, cluster, batch, sub) -> np.ndarray:
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
        if use_repair:
            self._solve_path = "repair"
        elif not constraint_free:
            self._solve_path = "exact"  # the scan owns constrained batches
        # cluster tensors ride the device mirrors (kernel B)
        views = self._tensor_cache.device_views(cluster, self.device)
        inputs, d_max = make_inputs(cluster, sub, self.device, views=views)
        assignment = None
        if use_fast:
            self._solve_path = "fast"
            assignment = waterfill_solve(inputs, make_groups(sub))
        if use_repair:
            solved = repair_solve(inputs, sub, d_max, has_gang=sub.gang_bonus is not None)
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
                has_gang=sub.gang_bonus is not None)
            assignment = scan.cpu().numpy()
        return np.asarray(assignment, dtype=np.int32)

    def _note_repair(self, rstats) -> None:
        """Fold one constrained batch's RepairStats into the running totals
        (the repair metrics come with ROADMAP.md queue 1 item 7)."""
        self._last_repair = rstats
        t = self.repair_totals
        t["batches"] += 1
        t["rounds"] += rstats.rounds
        t["proposed"] += rstats.proposed
        t["repaired"] += rstats.repaired
        t["residual"] += rstats.residual
        t["full_scan"] += int(rstats.full_scan)
        for v in rstats.violations.values():
            t["violations"] += v

    def _handle_solver_error(self, e, qps, device_idx) -> None:
        """Solver failure domain: requeue the device pods with backoff (the
        pods are fine, so no cluster event is needed before the retry) and
        feed the circuit breaker."""
        qps_dev = [qps[pi] for pi in device_idx.tolist()]
        tripped = self.breaker.record_failure(self._solve_path, self.solver)
        self.queue.add_backoff(qps_dev)
        self.last_solver_error = f"{type(e).__name__}: {e}"[:200]
        log.warning("solver %s failed on path %s; %d pod(s) requeued with backoff%s",
                    self.solver, self._solve_path, len(qps_dev),
                    "; circuit breaker OPEN" if tripped else "", exc_info=e)

    def _commit(self, qps, device_idx, assign_list, node_names) -> None:
        """Assume every placement first, then bind, then fail the rejects
        (failing mid-loop would see capacity promised to not-yet-bound pods)."""
        to_bind = []
        rejected = []
        for j, pi in enumerate(device_idx.tolist()):
            nidx = assign_list[j]
            if nidx < 0:
                rejected.append(qps[pi])
            else:
                qp = qps[pi]
                to_bind.append((qp, node_names[nidx], pod_structural_clone(qp.pod)))
        if to_bind:
            bad = self.cache.assume_pods([(assumed, node) for _qp, node, assumed in to_bind])
            for i, msg in sorted(bad, reverse=True):
                qp, _node, _assumed = to_bind.pop(i)
                self._handle_failure(qp, Status.error(msg))
            for lo in range(0, len(to_bind), self.bind_chunk):
                self._bind_chunk(to_bind[lo:lo + self.bind_chunk])
        n = len(node_names)
        for qp in rejected:
            self._handle_failure(qp, Status.unschedulable(
                f"0/{n} nodes are available", plugin="NodeResourcesFit"))

    def _bind_chunk(self, items) -> None:
        """One bind_many for a chunk of assumed placements, then the assume
        confirmations our own (origin-tagged) bind events would have made."""
        triples = [(qp.pod.metadata.namespace, qp.pod.metadata.name, node)
                   for qp, node, _assumed in items]
        _bound, errors = self.store.bind_many(triples, origin=self._bind_origin)
        errmap = dict(errors)
        confirm = []
        for qp, node, assumed in items:
            msg = errmap.get(qp.pod.key)
            if msg is None:
                confirm.append((qp.pod.key, node))
                self.scheduled_count += 1
            else:
                self.cache.forget_pod(assumed)
                self._handle_failure(qp, Status.error(msg))
        for i in self.cache.confirm_assumed_bulk(confirm):
            # assume expired or a foreign write got in first: ingest the
            # committed object like any foreign MODIFIED
            try:
                cur = self.store.get("pods", confirm[i][0])
            except NotFoundError:
                continue
            self._handle_pod(MODIFIED, cur)

def _subset_batch(batch, idx):
    """View of a PodBatchTensors restricted to pod rows idx (class tables shared)."""
    return dataclasses.replace(
        batch,
        pods=[batch.pods[i] for i in idx],
        class_of_pod=batch.class_of_pod[idx],
        req=batch.req[idx],
        req_nz=batch.req_nz[idx],
        balanced_active=batch.balanced_active[idx],
    )
