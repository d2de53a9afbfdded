"""DefaultPreemption — PostFilter that evicts lower-priority pods to admit a pod.

The counterpart of `kubernetes_tpu/scheduler/plugins/default_preemption.py`
(reference: pkg/scheduler/framework/preemption/preemption.go — Evaluator
:127, Preempt :230, findCandidates :305, DryRunPreemption :680,
SelectCandidate :396, prepareCandidate :431 — and
plugins/defaultpreemption/default_preemption.go:93).

Algorithm:
  1. Eligibility: preemptionPolicy != Never.
  2. Candidates = nodes that failed with UNSCHEDULABLE (not UNRESOLVABLE),
     dry-run in node order until max(100, 10% of the nodes) are found
     (GetOffsetAndNumCandidates, preemption.go:595).
  3. Dry run per node: remove ALL lower-priority pods; if the pod then fits,
     reprieve victims while the pod still fits — PDB-violating victims first
     (so they are most likely to be kept), then non-violating, each
     highest-priority-first (selectVictimsOnNode + filterPodsWithPDBViolation);
     reprieve failures among the violating set count as PDB violations.
  4. SelectCandidate: fewest PDB violations, then lowest highest-victim
     priority, then smallest victim priority sum, then fewest victims, then
     node name (pick_one_node_for_preemption :560).
  5. prepareCandidate[Async]: set the preemptor's status.nominatedNodeName
     synchronously, then narrate each victim with a "Preempted" event and
     DELETE the victims in one batched store.delete_pods — on one
     preparation worker thread when async_preparation is on (the
     SchedulerAsyncPreemption gate, prepareCandidateAsync :470).
The batch scheduler's tiered preemption (scheduler/batch.py _batch_preempt)
and the gang victim cover (scheduler/gangpreempt.py) run the dry run and the
victim execution through this plugin.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ...utils.featuregate import feature_gates
from ..framework import Code, CycleState, NodeInfo, PodInfo, Status, SUCCESS


@dataclass
class Candidate:
    node_name: str
    victims: List  # pods, sorted by descending priority
    num_pdb_violations: int = 0


class DefaultPreemption:
    name = "DefaultPreemption"

    # candidate search caps (defaultpreemption config defaults:
    # minCandidateNodesPercentage 10, minCandidateNodesAbsolute 100)
    MIN_CANDIDATE_NODES_PERCENTAGE = 10
    MIN_CANDIDATE_NODES_ABSOLUTE = 100

    def __init__(self, framework=None, store=None,
                 async_preparation: Optional[bool] = None, recorder=None):
        self.framework = framework
        self.store = store
        self._recorder = recorder
        # SchedulerAsyncPreemption: victim deletion off the scheduling thread.
        # Defaults from the feature gate (beta, on — registry.go:45-60).
        if async_preparation is None:
            async_preparation = feature_gates.enabled("SchedulerAsyncPreemption")
        self.async_preparation = async_preparation
        # one shared deletion worker (prepareCandidateAsync :470 runs one
        # goroutine per candidate; a queue bounds thread count under batches)
        self._prep_q: Optional[_queue.Queue] = None
        self._prep_thread: Optional[threading.Thread] = None
        # error types of failed bulk deletes already logged (one warning a
        # type, not a victim set: no log storms)
        self._bulk_delete_warned: set = set()

    def set_handles(self, framework, store, recorder=None) -> None:
        """Injected by the Scheduler (the reference passes framework.Handle)."""
        self.framework = framework
        self.store = store
        if recorder is not None:
            self._recorder = recorder

    def _pdbs(self):
        if self.store is None:
            return []
        pdbs, _ = self.store.list("poddisruptionbudgets")
        return pdbs

    def post_filter(self, state: CycleState, pod, filtered_statuses: Dict[str, Status]):
        """Returns (nominated_node_name | None, Status)."""
        if pod.spec.preemption_policy == "Never":
            return None, Status.unresolvable("preemption policy is Never", plugin=self.name)
        snapshot = state.read_or_none("Snapshot")
        if snapshot is None:
            return None, Status.error("no snapshot in cycle state", plugin=self.name)

        candidates = self._find_candidates(state, pod, snapshot, filtered_statuses)
        if not candidates:
            return None, Status.unresolvable(
                "preemption: 0/%d nodes are available" % len(snapshot), plugin=self.name
            )
        best = self._select_candidate(candidates)
        self._prepare_candidate(best, pod)
        return best.node_name, SUCCESS

    # -- dry run (DryRunPreemption :680) ---------------------------------------

    def _find_candidates(self, state, pod, snapshot, filtered_statuses) -> List[Candidate]:
        pdbs = self._pdbs()
        # candidate cap (GetOffsetAndNumCandidates, preemption.go:595): dry-run
        # until enough candidates are found instead of sweeping every node
        n = len(snapshot.node_info_list)
        num_candidates = max(self.MIN_CANDIDATE_NODES_ABSOLUTE,
                             n * self.MIN_CANDIDATE_NODES_PERCENTAGE // 100)
        out = []
        for ni in snapshot.node_info_list:
            name = ni.node.metadata.name
            st = filtered_statuses.get(name)
            if st is not None and st.code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue  # removing pods cannot help (interface.go semantics)
            cand = self._dry_run_node(state, pod, ni, pdbs)
            if cand is not None:
                out.append(cand)
                if len(out) >= num_candidates:
                    break
        return out

    @staticmethod
    def _split_pdb_violating(victims, pdbs):
        """filterPodsWithPDBViolation (preemption.go): a victim violates when it
        matches a PDB with no disruption budget left; each non-violating match
        consumes one unit of that PDB's remaining allowance."""
        allowed = [p.disruptions_allowed for p in pdbs]
        violating, non_violating = [], []
        for v in victims:
            hits = [i for i, p in enumerate(pdbs)
                    if p.metadata.namespace == v.metadata.namespace
                    and p.selector is not None
                    and p.selector.matches(v.metadata.labels)]
            if any(allowed[i] <= 0 for i in hits):
                violating.append(v)
            else:
                for i in hits:
                    allowed[i] -= 1
                non_violating.append(v)
        return violating, non_violating

    def _dry_run_node(self, state, pod, node_info: NodeInfo, pdbs) -> Optional[Candidate]:
        fw = self.framework
        ni = node_info.clone()
        st = state.clone()
        # remove all lower-priority pods
        potential_victims = [
            pi.pod for pi in list(ni.pods) if pi.pod.spec.priority < pod.spec.priority
        ]
        if not potential_victims:
            return None
        for v in potential_victims:
            ni.remove_pod(v)
            fw.run_remove_pod(st, pod, v, ni)
        if not fw.run_filter(st, pod, ni).is_success():
            return None
        # reprieve while the pod still fits: PDB-violating victims first (most
        # likely to be KEPT), then non-violating; highest priority first within
        # each set (selectVictimsOnNode)
        potential_victims.sort(key=lambda p: (-p.spec.priority, p.key))
        violating, non_violating = self._split_pdb_violating(potential_victims, pdbs)
        victims = []
        num_violations = 0

        def reprieve(v) -> bool:
            ni.add_pod(PodInfo(v))
            fw.run_add_pod(st, pod, v, ni)
            if fw.run_filter(st, pod, ni).is_success():
                return True
            ni.remove_pod(v)
            fw.run_remove_pod(st, pod, v, ni)
            victims.append(v)
            return False

        for v in violating:
            if not reprieve(v):
                num_violations += 1
        for v in non_violating:
            reprieve(v)
        if not victims:
            return None  # pod fit without evictions: not a preemption case
        victims.sort(key=lambda p: -p.spec.priority)
        return Candidate(node_name=node_info.node.metadata.name, victims=victims,
                         num_pdb_violations=num_violations)

    # -- selection (pick_one_node_for_preemption :560) -------------------------

    def _select_candidate(self, candidates: List[Candidate]) -> Candidate:
        def key(c: Candidate):
            highest_victim_priority = c.victims[0].spec.priority if c.victims else -(2**31)
            priority_sum = sum(v.spec.priority for v in c.victims)
            return (
                c.num_pdb_violations,      # fewest PDB violations
                highest_victim_priority,   # lowest highest-priority victim
                priority_sum,              # smallest priority sum
                len(c.victims),            # fewest victims
                c.node_name,               # stable
            )

        return min(candidates, key=key)

    # -- execution (prepareCandidate :431 / prepareCandidateAsync :470) --------

    def _prepare_candidate(self, cand: Candidate, pod) -> None:
        if self.store is None:
            return
        # nomination is set synchronously either way — the next cycle's
        # nominated-node fast path depends on it (schedule_one.go:492)
        try:
            self.store.update_pod_status(
                pod.metadata.namespace, pod.metadata.name,
                lambda st: setattr(st, "nominated_node_name", cand.node_name),
            )
        except Exception:
            pass
        # async mode moves the WHOLE per-victim preparation — narration
        # events and DELETE writes — onto the worker (the reference's
        # prepareCandidateAsync runs everything after nomination in a
        # goroutine). Each recorder.event is a store write (~ms); paying
        # victims x that on the scheduling thread was why PreemptionAsync
        # benched no faster than the serial mode.
        if self.async_preparation:
            self._ensure_prep_worker()
            self._prep_q.put((list(cand.victims), pod.metadata.name,
                              cand.node_name))
        else:
            self._narrate_victims(cand.victims, pod.metadata.name,
                                  cand.node_name)
            self._delete_victims(cand.victims)

    def _narrate_victims(self, victims, preemptor_name: str, node_name: str) -> None:
        """One "Preempted" event per victim, through the scheduler's recorder
        (shared clock and aggregation)."""
        try:
            if self._recorder is None:
                from ...api.events import EventRecorder

                self._recorder = EventRecorder(self.store, component="default-scheduler")
            for v in victims:
                self._recorder.event(v, "Normal", "Preempted",
                                     f"Preempted by pod {preemptor_name} on node {node_name}")
        except Exception:
            pass

    def _delete_victims(self, victims) -> None:
        """One store critical section and one coalesced DELETED delivery for
        the whole victim set; a victim already gone is a per-key miss. A
        failing bulk delete falls back to per-pod deletes, logged once per
        error type (utils/tracing.py default_logger)."""
        try:
            self.store.delete_pods([v.key for v in victims])
            return
        except Exception as e:
            kind = type(e).__name__
            if kind not in self._bulk_delete_warned:
                self._bulk_delete_warned.add(kind)
                from ...utils.tracing import default_logger

                default_logger.warning(
                    "delete_pods (bulk victim deletion) failed; falling "
                    "back to per-pod deletes", error=f"{kind}: {e}",
                    victims=len(victims))
        for v in victims:
            try:
                self.store.delete("pods", v.key)
            except Exception:
                pass

    def _ensure_prep_worker(self) -> None:
        if self._prep_q is None:
            self._prep_q = _queue.Queue()
        if self._prep_thread is None or not self._prep_thread.is_alive():
            self._prep_thread = threading.Thread(target=self._prep_loop, daemon=True)
            self._prep_thread.start()

    def _prep_loop(self) -> None:
        while True:
            victims, preemptor_name, node_name = self._prep_q.get()
            try:
                self._narrate_victims(victims, preemptor_name, node_name)
                self._delete_victims(victims)
            finally:
                self._prep_q.task_done()

    def wait_for_preparation(self, timeout: float = 5.0) -> None:
        """Wait (bounded) for outstanding async victim deletions."""
        if self._prep_q is None:
            return
        deadline = time.monotonic() + timeout
        while self._prep_q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)
