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

Not in this slice (each raises or is named where it would act):
  serial fallback classes, per-pod preemption, plugins, QueueingHints
                                              ROADMAP.md queue 1 item 2
  transport over a node-axis mesh (several cards)
                                              queue 1 item 6
  flight recorder, pod traces, metrics, the solver's Warning event, the
  native commit, pipelined binds and assume expiry, sched_stats(), the
  partitioned scheduler (partition_index stays None)
                                              queue 1 item 7
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
from typing import Dict, List, Optional

import numpy as np

from ..chaos import faultinject
from ..models.gangcover import alignment_groups, mean_neighbor_distance, rank_align
from ..models.repair import repair_solve
from ..models.transport import transport_solve
from ..models.waterfill import make_groups, waterfill_solve
from ..ops.solver import greedy_scan_solve, make_inputs, resolve_device
from ..snapshot.tensorizer import TensorCache, build_pod_batch
from ..store import MODIFIED, APIStore, NotFoundError, pod_structural_clone
from ..utils import Clock
from .breaker import REPRESENTATIVE, SolverCircuitBreaker
from .framework import Status
from .gang import GangDirectory, gang_veto_mask, node_slice_positions, ring_lengths
from .gangpreempt import GangPreemptor
from .plugins.default_preemption import DefaultPreemption
from .queue import QueuedPodInfo
from .serial import NOT_PORTED, Scheduler

SOLVERS = ("exact", "fast", "auto", "auction", "sinkhorn")
SOLVER_ROADMAP = {"native": 7}

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
    propose-and-repair for constrained ones), "auto" (the same routing), or
    "auction" / "sinkhorn" (the transport solvers for constraint-free,
    gang-free batches without host ports; the scan for the others).
    "native" raises naming its ROADMAP item.
    device: "cuda" (default) runs the kernels on the card and raises where
    torch.cuda.is_available() is false; "cpu" runs their plain versions.
    framework must be None: the scoring profile is the default plugin set
    that the solver encodes (custom profiles come with ROADMAP.md queue 1
    item 2). rank_align gates the rank-to-ring permutation of ranked gang
    members; gang_preemption installs the gang victim cover;
    pod_initial_backoff / pod_max_backoff set the queue's backoff (seconds,
    the reference's defaults)."""

    def __init__(self, store: APIStore, framework=None, *, device="cuda",
                 batch_size: int = 4096, solver: str = "exact",
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 30.0,
                 rank_align: bool = True, gang_preemption: bool = True,
                 clock: Optional[Clock] = None, pod_initial_backoff: float = 1.0,
                 pod_max_backoff: float = 10.0):
        self.device = resolve_device(device)
        if framework is not None:
            raise NotImplementedError("custom scheduler frameworks are " + NOT_PORTED.format(2))
        if solver not in SOLVERS:
            item = SOLVER_ROADMAP.get(solver)
            if item is None:
                raise ValueError(f"unknown solver {solver!r}")
            raise NotImplementedError(f"solver {solver!r} is " + NOT_PORTED.format(item))
        super().__init__(store, clock=clock, pod_initial_backoff=pod_initial_backoff,
                         pod_max_backoff=pod_max_backoff)
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
        self.transport_state = None  # warm duals carried across batches
        # propose-and-repair: the last batch's RepairStats + running totals
        self._last_repair = None
        self.repair_totals = {"batches": 0, "rounds": 0, "proposed": 0, "repaired": 0,
                              "residual": 0, "full_scan": 0, "violations": 0}
        # host seconds per stage, summed over batches (the solve stage ends
        # with the assignment's copy to the host, so it includes device time)
        self.stage_seconds = {"tensorize": 0.0, "solve": 0.0, "commit": 0.0}
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
        # gang preemption: a solver-vetoed gang tries a min-cost victim cover
        # on one slice, executed by DefaultPreemption's victim half
        self.preemption = (DefaultPreemption(store=store, recorder=self.recorder)
                           if gang_preemption else None)
        self.gangpreempt = GangPreemptor(self) if gang_preemption else None
        self.preempt_victims_total = 0
        # a shard pipeline of a partitioned scheduler sets its index (item
        # 7); None is a standalone scheduler, which sees the whole cluster
        self.partition_index: Optional[int] = None
        # background rebalancer (scheduler/rebalance.py): installed by
        # enable_rebalancer(); run_until_idle's idle path paces it
        self.rebalancer = None

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
            reuse=self._tensor_cache, changed_nodes=changed_nodes, gangs=self.gangs)
        fallback_mask = batch.fallback_class[batch.class_of_pod]
        keep = ~self._strip_fallback_gangs(qps, batch, fallback_mask)
        device_idx = np.nonzero(~fallback_mask & keep)[0]
        fallback_idx = np.nonzero(fallback_mask & keep)[0]
        t1 = time.perf_counter()
        self.stage_seconds["tensorize"] += t1 - t0

        if device_idx.size:
            sub = _subset_batch(batch, device_idx)
            has_gang = sub.gang_of_pod is not None and bool((sub.gang_of_pod >= 0).any())
            try:
                assignment = self._solve_device(solver, cluster, batch, sub, has_gang)
            except Exception as e:
                # nothing is assumed yet: the device pods requeue as a unit
                self._handle_solver_error(e, qps, device_idx)
                assignment = None
            else:
                self.breaker.record_success(self._solve_path, self.solver)
            gang = None
            if assignment is not None and has_gang:
                assignment, gang = self._gang_veto(cluster, sub, assignment)
            t2 = time.perf_counter()
            self.stage_seconds["solve"] += t2 - t1
            self.solve_seconds.append(t2 - t1)
            if assignment is not None:
                self._commit(qps, device_idx, assignment, snapshot, cluster, sub, gang)
                self.stage_seconds["commit"] += time.perf_counter() - t2
        for pi in fallback_idx.tolist():
            self.fallback_refused += 1
            self._handle_failure(qps[pi], Status.unschedulable(FALLBACK_REASON))
        return len(qps)

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
        # cluster tensors ride the device mirrors (kernel B)
        views = self._tensor_cache.device_views(cluster, self.device)
        inputs, d_max = make_inputs(cluster, sub, self.device, views=views)
        assignment = None
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

    def _commit(self, qps, device_idx, assignment, snapshot, cluster, sub, gang) -> None:
        """Assume every placement first, then bind, then fail the rejects
        (failing mid-loop would see capacity promised to not-yet-bound pods),
        then requeue the vetoed gangs."""
        node_names = cluster.node_names
        n = len(node_names)
        assign_list = np.asarray(assignment).tolist()
        sub_gang = np.asarray(sub.gang_of_pod).tolist() if gang is not None else None
        veto_list = gang["veto"].tolist() if gang is not None else None
        gang_requeue: Dict[int, List[QueuedPodInfo]] = {}
        to_bind = []
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
                    rejected.append(qps[pi])
            else:
                qp = qps[pi]
                to_bind.append((qp, node_names[nidx], pod_structural_clone(qp.pod)))
                if sub_gang is not None:
                    bind_gang.append(gid)
        if to_bind:
            bad = self.cache.assume_pods([(assumed, node) for _qp, node, assumed in to_bind])
            bad_gangs = set()
            for i, msg in sorted(bad, reverse=True):
                qp, _node, _assumed = to_bind.pop(i)
                gid = bind_gang.pop(i) if bind_gang else -1
                if gid >= 0:
                    bad_gangs.add(gid)
                    gang_requeue.setdefault(gid, []).append(qp)
                else:
                    self._handle_failure(qp, Status.error(msg))
            if bad_gangs:
                # all-or-nothing at assume time: a gang that lost a member
                # releases every assumed sibling BEFORE any bind
                released = []
                for i in range(len(to_bind) - 1, -1, -1):
                    gid = bind_gang[i]
                    if gid in bad_gangs:
                        qp, _node, assumed = to_bind.pop(i)
                        bind_gang.pop(i)
                        released.append(assumed)
                        gang_requeue.setdefault(gid, []).append(qp)
                for assumed in released:
                    self.cache.forget_pod(assumed)
                gang["info"]["assume_vetoed"] = len(bad_gangs)
                gang["info"]["released"] = len(released)
            # surviving members count toward quorum from assume on (our own
            # bind confirmations bypass the event stream)
            for i, (_qp, _node, assumed) in enumerate(to_bind):
                if bind_gang and bind_gang[i] >= 0:
                    self.gangs.note_assumed(assumed)
            for lo in range(0, len(to_bind), self.bind_chunk):
                self._bind_chunk(to_bind[lo:lo + self.bind_chunk])
        for qp in rejected:
            self._handle_failure(qp, Status.unschedulable(
                f"0/{n} nodes are available", plugin="NodeResourcesFit"))
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
                if got is not None and not got.get("vetoed"):
                    gang_info["preempted"] = gang_info.get("preempted", 0) + 1
                    gang_info["preempt_victims"] = (gang_info.get("preempt_victims", 0)
                                                    + got["victims"])
                    gang_info["cover_cost"] = gang_info.get("cover_cost", 0) + got["cost"]
                    continue
                if got is not None:
                    gang_info["preempt_vetoed_partial"] = (
                        gang_info.get("preempt_vetoed_partial", 0) + 1)
            self.failed_count += len(members)
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
        the mean neighbor distance before and after in gang_info."""
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
                self.gangs.note_forgotten(assumed)
                self._handle_failure(qp, Status.error(msg))
        for i in self.cache.confirm_assumed_bulk(confirm):
            # assume expired or a foreign write got in first: ingest the
            # committed object like any foreign MODIFIED
            try:
                cur = self.store.get("pods", confirm[i][0])
            except NotFoundError:
                continue
            self._handle_pod(MODIFIED, cur)

    # -- idle loops, resync, stats --------------------------------------------

    def run_until_idle(self, max_cycles: int = 10_000) -> int:
        """Drive batches until the active queue drains; before declaring idle,
        pump events and run the parked-gang deadline sweep; at idle, let an
        attached rebalancer take a paced cycle."""
        n = 0
        while n < max_cycles:
            if self.schedule_batch() == 0:
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
        """The gang preemptor's deadline: a cover whose victim deletions
        stalled releases its parked gang to the normal retry ladder. The
        cache's assume expiry comes with pipelined binds (ROADMAP.md queue 1
        item 7); until then no assume expires and the list is empty."""
        if self.gangpreempt is not None:
            self.gangpreempt.sweep(self.clock.now())
        return []

    def resync_from_store(self) -> None:
        """Rebuild all scheduler state from the store, as a restarted
        scheduler would: a fresh cache and queue from the LIST, the tensor
        cache and in-flight cover tracking dropped."""
        self._tensor_cache = TensorCache()
        if self.gangpreempt is not None:
            self.gangpreempt.reset()
        self.queue.clear()
        self._rebuild_from_store(preserve_queue=False)

    def _preemption_plugin(self) -> Optional[DefaultPreemption]:
        """The victim executor the gang preemptor fires through."""
        return self.preemption

    def gang_stats(self) -> Optional[Dict]:
        """The gang part of the JAX sched_stats(): None while no PodGroup
        exists."""
        if not self.gangs.active:
            return None
        return {"staged": self.queue.gang_staged_count(),
                "parked": self.queue.gang_parked_count(),
                "vetoes": self.gang_vetoes,
                "quorum_expired_assumes": self.gangs.quorum_expired_count(self.cache.contains),
                "preemption": (self.gangpreempt.stats()
                               if self.gangpreempt is not None else None)}

    def rebalance_stats(self) -> Optional[Dict]:
        """The rebalance part of the JAX sched_stats(): the fragmentation
        score and the migration/wave/abort totals; None until
        enable_rebalancer()."""
        return self.rebalancer.stats() if self.rebalancer is not None else None


def _subset_batch(batch, idx):
    """View of a PodBatchTensors restricted to pod rows idx (class tables shared)."""
    return dataclasses.replace(
        batch,
        pods=[batch.pods[i] for i in idx],
        class_of_pod=batch.class_of_pod[idx],
        req=batch.req[idx],
        req_nz=batch.req_nz[idx],
        balanced_active=batch.balanced_active[idx],
        gang_of_pod=None if batch.gang_of_pod is None else batch.gang_of_pod[idx],
        gang_rank=None if batch.gang_rank is None else batch.gang_rank[idx],
    )
