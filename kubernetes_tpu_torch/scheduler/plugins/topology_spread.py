"""PodTopologySpread — Filter (DoNotSchedule skew) and Score (ScheduleAnyway).

reference: pkg/scheduler/framework/plugins/podtopologyspread/{filtering.go,
scoring.go, common.go}. Semantics preserved:
  - PreFilter builds per-constraint TpValueToMatchNum over eligible nodes
    (honoring NodeAffinityPolicy/NodeTaintsPolicy), plus minMatchNum with
    MinDomains (filtering.go:55).
  - Filter: matchNum + selfMatch - minMatchNum <= maxSkew (filtering.go:340-355);
    nodes missing the topology key are UnschedulableAndUnresolvable.
  - Score: per-topology-value counts x log-normalizing weight (scoring.go),
    then the special maxScore+minScore-s normalization.
  - AddPod/RemovePod PreFilterExtensions keep counts incremental for preemption.

The counterpart of `kubernetes_tpu/scheduler/plugins/topology_spread.py`, host Python with
the same integer arithmetic (the parity tests hold scores equal).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ...api import find_matching_untolerated_taint
from ...api.types import LABEL_HOSTNAME
from ..framework import (
    MAX_NODE_SCORE,
    CycleState,
    NodeInfo,
    Plugin,
    Status,
    SUCCESS,
)
from .helpers import (
    count_pods_match_selector,
    node_matches_node_selector_and_affinity,
    pts_effective_selector,
)

_FILTER_KEY = "PreFilterPodTopologySpread"
_SCORE_KEY = "PreScorePodTopologySpread"
_INVALID = -1


class _FilterState:
    def __init__(self, constraints, tp_counts, min_counts):
        # constraints: list of (constraint, effective_selector)
        self.constraints = constraints
        # tp_counts[i]: {topology_value: match_count}
        self.tp_counts = tp_counts
        # min_counts[i]: precomputed minMatchNum honoring MinDomains
        self.min_counts = min_counts

    def clone(self):
        return _FilterState(self.constraints, [dict(d) for d in self.tp_counts], list(self.min_counts))

    def recompute_min(self):
        out = []
        for i, (c, _sel) in enumerate(self.constraints):
            counts = self.tp_counts[i]
            m = min(counts.values(), default=0)
            if c.min_domains and c.min_domains > len(counts):
                m = 0
            out.append(m)
        self.min_counts = out


class PodTopologySpread(Plugin):
    name = "PodTopologySpread"

    def __init__(self, default_constraints=(), system_defaulted: bool = False):
        self.default_constraints = tuple(default_constraints)
        self.system_defaulted = system_defaulted

    def events_to_register(self):
        """podtopologyspread EventsToRegister: Pod add/update/delete of pods
        matching a constraint selector shift the skew; Node add/update can add
        topology domains."""
        from ..framework import ClusterEventWithHint

        def pod_counts(pod, event_pod):
            if event_pod.metadata.namespace != pod.metadata.namespace:
                return False
            for c in pod.spec.topology_spread_constraints:
                sel = pts_effective_selector(c, pod)
                if sel is not None and sel.matches(event_pod.metadata.labels):
                    return True
            return False

        return (ClusterEventWithHint("pods", "add", pod_counts),
                ClusterEventWithHint("pods", "update", pod_counts),
                ClusterEventWithHint("pods", "delete", pod_counts),
                ClusterEventWithHint("nodes", "add"),
                ClusterEventWithHint("nodes", "update"),
                # a domain disappearing can lower minMatchNum below the skew
                # bound (upstream registers Node Add|Delete)
                ClusterEventWithHint("nodes", "delete"))

    # -- Filter path -----------------------------------------------------------

    def pre_filter(self, state: CycleState, pod, snapshot):
        constraints = [
            (c, pts_effective_selector(c, pod))
            for c in pod.spec.topology_spread_constraints
            if c.when_unsatisfiable == "DoNotSchedule"
        ]
        if not constraints:
            state.write(_FILTER_KEY, None)
            return None, SUCCESS
        tp_counts: List[Dict[str, int]] = [dict() for _ in constraints]
        for ni in snapshot.node_info_list:
            node = ni.node
            # Inclusion policies are per-constraint (common.go
            # matchNodeInclusionPolicies): node eligibility for one constraint's
            # domains must not leak into another's.
            for i, (c, sel) in enumerate(constraints):
                if not self._constraint_node_eligible(pod, node, c):
                    continue
                val = node.metadata.labels.get(c.topology_key)
                if val is None:
                    continue
                cnt = count_pods_match_selector(ni.pods, sel, pod.metadata.namespace)
                tp_counts[i][val] = tp_counts[i].get(val, 0) + cnt
        st = _FilterState(constraints, tp_counts, [])
        st.recompute_min()
        state.write(_FILTER_KEY, st)
        return None, SUCCESS

    @staticmethod
    def _constraint_node_eligible(pod, node, c) -> bool:
        """Per-constraint node inclusion (common.go matchNodeInclusionPolicies)."""
        if c.node_affinity_policy == "Honor" and \
                not node_matches_node_selector_and_affinity(pod, node):
            return False
        if c.node_taints_policy == "Honor" and \
                find_matching_untolerated_taint(node.spec.taints, pod.spec.tolerations) is not None:
            return False
        return True

    def filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        st: Optional[_FilterState] = state.read_or_none(_FILTER_KEY)
        if st is None:
            return SUCCESS
        node = node_info.node
        for i, (c, sel) in enumerate(st.constraints):
            val = node.metadata.labels.get(c.topology_key)
            if val is None:
                return Status.unresolvable("node(s) didn't have the requested topology",
                                           plugin=self.name)
            self_match = 1 if (sel is not None and sel.matches(pod.metadata.labels)) else 0
            match_num = st.tp_counts[i].get(val, 0)
            skew = match_num + self_match - st.min_counts[i]
            if skew > c.max_skew:
                return Status.unschedulable(
                    "node(s) didn't match pod topology spread constraints",
                    plugin=self.name,
                )
        return SUCCESS

    # PreFilterExtensions (preemption dry-runs mutate counts incrementally)

    def add_pod(self, state: CycleState, pod_to_schedule, added_pod, node_info: NodeInfo) -> Status:
        self._update(state, pod_to_schedule, added_pod, node_info, +1)
        return SUCCESS

    def remove_pod(self, state: CycleState, pod_to_schedule, removed_pod, node_info: NodeInfo) -> Status:
        self._update(state, pod_to_schedule, removed_pod, node_info, -1)
        return SUCCESS

    def _update(self, state, pod, other_pod, node_info, delta):
        st: Optional[_FilterState] = state.read_or_none(_FILTER_KEY)
        if st is None:
            return
        node = node_info.node
        for i, (c, sel) in enumerate(st.constraints):
            if not self._constraint_node_eligible(pod, node, c):
                continue
            val = node.metadata.labels.get(c.topology_key)
            if val is None or sel is None:
                continue
            if other_pod.metadata.namespace == pod.metadata.namespace and \
                    sel.matches(other_pod.metadata.labels):
                st.tp_counts[i][val] = st.tp_counts[i].get(val, 0) + delta
        st.recompute_min()

    # -- Score path ------------------------------------------------------------

    def pre_score(self, state: CycleState, pod, filtered_nodes) -> Status:
        snapshot = state.read_or_none("Snapshot")
        all_nodes = snapshot.node_info_list if snapshot else filtered_nodes
        constraints = [
            (c, pts_effective_selector(c, pod))
            for c in pod.spec.topology_spread_constraints
            if c.when_unsatisfiable == "ScheduleAnyway"
        ]
        if not constraints:
            state.write(_SCORE_KEY, None)
            return Status.skip(plugin=self.name)
        require_all = True  # non-system-default constraints (scoring.go:121)

        # Domains from *filtered* nodes (initPreScoreState), counts over all nodes.
        ignored_nodes = set()
        tp_counts: List[Dict[str, int]] = [dict() for _ in constraints]
        topo_size = [0] * len(constraints)
        for ni in filtered_nodes:
            node = ni.node
            if require_all and any(c.topology_key not in node.metadata.labels for c, _ in constraints):
                ignored_nodes.add(node.metadata.name)
                continue
            for i, (c, _sel) in enumerate(constraints):
                if c.topology_key == LABEL_HOSTNAME:
                    continue
                val = node.metadata.labels.get(c.topology_key)
                if val is not None and val not in tp_counts[i]:
                    tp_counts[i][val] = 0
                    topo_size[i] += 1

        weights = []
        for i, (c, _sel) in enumerate(constraints):
            size = topo_size[i]
            if c.topology_key == LABEL_HOSTNAME:
                size = len(filtered_nodes) - len(ignored_nodes)
            weights.append(math.log(size + 2))

        for ni in all_nodes:
            node = ni.node
            if not node_matches_node_selector_and_affinity(pod, node):
                continue
            if require_all and any(c.topology_key not in node.metadata.labels for c, _ in constraints):
                continue
            for i, (c, sel) in enumerate(constraints):
                val = node.metadata.labels.get(c.topology_key)
                if val is None or val not in tp_counts[i]:
                    continue
                tp_counts[i][val] += count_pods_match_selector(ni.pods, sel, pod.metadata.namespace)

        state.write(_SCORE_KEY, {
            "constraints": constraints,
            "ignored": ignored_nodes,
            "tp_counts": tp_counts,
            "weights": weights,
        })
        return SUCCESS

    def score(self, state: CycleState, pod, node_info: NodeInfo) -> Tuple[int, Status]:
        s = state.read_or_none(_SCORE_KEY)
        if not s:
            return 0, SUCCESS
        node = node_info.node
        if node.metadata.name in s["ignored"]:
            return 0, SUCCESS
        score = 0.0
        for i, (c, sel) in enumerate(s["constraints"]):
            val = node.metadata.labels.get(c.topology_key)
            if val is None:
                continue
            if c.topology_key == LABEL_HOSTNAME:
                cnt = count_pods_match_selector(node_info.pods, sel, pod.metadata.namespace)
            else:
                cnt = s["tp_counts"][i].get(val, 0)
            score += cnt * s["weights"][i] + (c.max_skew - 1)
        return int(round(score)), SUCCESS

    def normalize_score(self, state: CycleState, pod, scores: Dict[str, int]) -> Status:
        s = state.read_or_none(_SCORE_KEY)
        if not s:
            return SUCCESS
        ignored = s["ignored"]
        valid = {k: v for k, v in scores.items() if k not in ignored}
        if not valid:
            for k in scores:
                scores[k] = 0
            return SUCCESS
        min_score = min(valid.values())
        max_score = max(valid.values())
        for k in scores:
            if k in ignored:
                scores[k] = 0
            elif max_score == 0:
                scores[k] = MAX_NODE_SCORE
            else:
                scores[k] = MAX_NODE_SCORE * (max_score + min_score - scores[k]) // max_score
        return SUCCESS
