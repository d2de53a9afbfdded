"""InterPodAffinity — Filter (required (anti-)affinity incl. symmetry) and Score.

reference: pkg/scheduler/framework/plugins/interpodaffinity/{filtering.go,
scoring.go}. State = three topologyPair->count maps (filtering.go:44-50):
  existing_anti: existing pods' required anti-affinity terms matching the
    incoming pod (symmetry check);
  affinity / anti_affinity: existing pods matching the incoming pod's terms.
Filter rules (filtering.go:415):
  1. no existing pod's required anti-affinity is violated;
  2. incoming required affinity satisfied (with the first-pod-in-cluster
     exception, filtering.go satisfyPodAffinity);
  3. incoming required anti-affinity not violated.
Score (scoring.go): weighted per-(topologyKey,value) sums over preferred terms of
the incoming pod AND (symmetrically) of existing pods, incl. existing pods'
*required* affinity terms weighted by hard_pod_affinity_weight; normalized
(score-min)/(max-min)*100.

The counterpart of `kubernetes_tpu/scheduler/plugins/interpod_affinity.py`, host Python with
the same integer arithmetic (the parity tests hold scores equal).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

from ..framework import (
    MAX_NODE_SCORE,
    CycleState,
    NodeInfo,
    Plugin,
    Status,
    SUCCESS,
)
from .helpers import term_matches_pod

_FILTER_KEY = "PreFilterInterPodAffinity"
_SCORE_KEY = "PreScoreInterPodAffinity"


class _FilterState:
    __slots__ = ("existing_anti", "affinity", "anti_affinity", "pod")

    def __init__(self, pod, existing_anti, affinity, anti_affinity):
        self.pod = pod
        self.existing_anti: Dict[Tuple[str, str], int] = existing_anti
        self.affinity: Dict[Tuple[str, str], int] = affinity
        self.anti_affinity: Dict[Tuple[str, str], int] = anti_affinity

    def clone(self):
        return _FilterState(self.pod, dict(self.existing_anti), dict(self.affinity),
                            dict(self.anti_affinity))


class InterPodAffinity(Plugin):
    name = "InterPodAffinity"

    def __init__(self, hard_pod_affinity_weight: int = 1,
                 ns_labels: Optional[Mapping[str, Mapping[str, str]]] = None):
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self._ns_labels = ns_labels or {}

    def set_namespace_labels(self, ns_labels: Mapping[str, Mapping[str, str]]) -> None:
        self._ns_labels = ns_labels

    def _has_constraints(self, pod) -> bool:
        aff = pod.spec.affinity
        return bool(aff and (aff.pod_affinity_required or aff.pod_anti_affinity_required))

    def events_to_register(self):
        """interpodaffinity EventsToRegister: Pod add/update/delete (a matching
        pod appearing satisfies affinity; a blocking pod leaving clears
        anti-affinity) and Node add/update (new topology domains)."""
        from ..framework import ClusterEventWithHint

        def pod_related(pod, event_pod):
            aff = pod.spec.affinity
            if aff is None:
                return True  # rejected via symmetry: any pod event may matter
            terms = (tuple(aff.pod_affinity_required)
                     + tuple(aff.pod_anti_affinity_required))
            if any(term_matches_pod(t, pod, event_pod, self._ns_labels)
                   for t in terms):
                return True
            # symmetric direction: the event pod's own terms may target us
            ev_aff = event_pod.spec.affinity
            return bool(ev_aff and (ev_aff.pod_affinity_required
                                    or ev_aff.pod_anti_affinity_required))

        return (ClusterEventWithHint("pods", "add", pod_related),
                ClusterEventWithHint("pods", "update", pod_related),
                ClusterEventWithHint("pods", "delete", pod_related),
                ClusterEventWithHint("nodes", "add"),
                ClusterEventWithHint("nodes", "update"))

    # -- Filter ----------------------------------------------------------------

    def pre_filter(self, state: CycleState, pod, snapshot):
        ns_labels = self._ns_labels
        existing_anti: Dict[Tuple[str, str], int] = {}
        affinity: Dict[Tuple[str, str], int] = {}
        anti_affinity: Dict[Tuple[str, str], int] = {}

        aff = pod.spec.affinity
        required = tuple(aff.pod_affinity_required) if aff else ()
        anti = tuple(aff.pod_anti_affinity_required) if aff else ()

        # Existing pods' required anti-affinity vs the incoming pod (symmetry).
        for ni in snapshot.have_pods_with_required_anti_affinity_list:
            node = ni.node
            for pi in ni.pods_with_required_anti_affinity:
                for term in pi.required_anti_affinity_terms:
                    val = node.metadata.labels.get(term.topology_key)
                    if val is None:
                        continue
                    if term_matches_pod(term, pi.pod, pod, ns_labels):
                        k = (term.topology_key, val)
                        existing_anti[k] = existing_anti.get(k, 0) + 1

        # Incoming pod's terms vs existing pods.
        if required or anti:
            for ni in snapshot.node_info_list:
                node = ni.node
                for pi in ni.pods:
                    for term in required:
                        val = node.metadata.labels.get(term.topology_key)
                        if val is not None and term_matches_pod(term, pod, pi.pod, ns_labels):
                            k = (term.topology_key, val)
                            affinity[k] = affinity.get(k, 0) + 1
                    for term in anti:
                        val = node.metadata.labels.get(term.topology_key)
                        if val is not None and term_matches_pod(term, pod, pi.pod, ns_labels):
                            k = (term.topology_key, val)
                            anti_affinity[k] = anti_affinity.get(k, 0) + 1

        if not existing_anti and not required and not anti:
            state.write(_FILTER_KEY, None)
            return None, Status.skip(plugin=self.name)
        state.write(_FILTER_KEY, _FilterState(pod, existing_anti, affinity, anti_affinity))
        return None, SUCCESS

    def filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        st: Optional[_FilterState] = state.read_or_none(_FILTER_KEY)
        if st is None:
            return SUCCESS
        node = node_info.node
        labels = node.metadata.labels

        # 1. existing pods' required anti-affinity (filtering.go satisfyExistingPodsAntiAffinity)
        for (tk, tv), cnt in st.existing_anti.items():
            if cnt > 0 and labels.get(tk) == tv:
                return Status.unschedulable(
                    "node(s) didn't satisfy existing pods anti-affinity rules", plugin=self.name
                )

        aff = pod.spec.affinity
        required = tuple(aff.pod_affinity_required) if aff else ()
        anti = tuple(aff.pod_anti_affinity_required) if aff else ()

        # 2. incoming required affinity (satisfyPodAffinity incl. first-pod rule)
        if required:
            pods_exist = True
            for term in required:
                val = labels.get(term.topology_key)
                if val is None:
                    return Status.unschedulable(
                        "node(s) didn't match pod affinity rules", plugin=self.name
                    )
                if st.affinity.get((term.topology_key, val), 0) <= 0:
                    pods_exist = False
            if not pods_exist:
                if not st.affinity and self._pod_matches_all_own_terms(pod, required):
                    pass  # first pod in a self-affine series
                else:
                    return Status.unschedulable(
                        "node(s) didn't match pod affinity rules", plugin=self.name
                    )

        # 3. incoming required anti-affinity (satisfyPodAntiAffinity)
        for term in anti:
            val = labels.get(term.topology_key)
            if val is not None and st.anti_affinity.get((term.topology_key, val), 0) > 0:
                return Status.unschedulable(
                    "node(s) didn't match pod anti-affinity rules", plugin=self.name
                )
        return SUCCESS

    def _pod_matches_all_own_terms(self, pod, terms) -> bool:
        return all(term_matches_pod(t, pod, pod, self._ns_labels) for t in terms)

    # PreFilterExtensions

    def add_pod(self, state: CycleState, pod, added_pod, node_info: NodeInfo) -> Status:
        self._update(state, pod, added_pod, node_info, +1)
        return SUCCESS

    def remove_pod(self, state: CycleState, pod, removed_pod, node_info: NodeInfo) -> Status:
        self._update(state, pod, removed_pod, node_info, -1)
        return SUCCESS

    def _update(self, state, pod, other, node_info, delta):
        st: Optional[_FilterState] = state.read_or_none(_FILTER_KEY)
        if st is None:
            return
        node = node_info.node
        labels = node.metadata.labels
        ns_labels = self._ns_labels
        other_aff = other.spec.affinity
        for term in (other_aff.pod_anti_affinity_required if other_aff else ()):
            val = labels.get(term.topology_key)
            if val is not None and term_matches_pod(term, other, pod, ns_labels):
                k = (term.topology_key, val)
                st.existing_anti[k] = st.existing_anti.get(k, 0) + delta
        aff = pod.spec.affinity
        for term in (aff.pod_affinity_required if aff else ()):
            val = labels.get(term.topology_key)
            if val is not None and term_matches_pod(term, pod, other, ns_labels):
                k = (term.topology_key, val)
                st.affinity[k] = st.affinity.get(k, 0) + delta
        for term in (aff.pod_anti_affinity_required if aff else ()):
            val = labels.get(term.topology_key)
            if val is not None and term_matches_pod(term, pod, other, ns_labels):
                k = (term.topology_key, val)
                st.anti_affinity[k] = st.anti_affinity.get(k, 0) + delta

    # -- Score -----------------------------------------------------------------

    def pre_score(self, state: CycleState, pod, filtered_nodes) -> Status:
        aff = pod.spec.affinity
        has_pref = bool(aff and (aff.pod_affinity_preferred or aff.pod_anti_affinity_preferred))
        has_constraints = has_pref
        # Symmetric scoring considers existing pods' terms even when the incoming
        # pod has none (scoring.go:127 PreScore early-exit only when the pod has
        # no affinity at all AND ignorePreferredTermsOfExistingPods).
        snapshot = state.read_or_none("Snapshot")
        all_nodes = snapshot.node_info_list if snapshot else filtered_nodes
        ns_labels = self._ns_labels

        score_map: Dict[Tuple[str, str], int] = {}

        def bump(topology_key: str, value: str, weight: int):
            k = (topology_key, value)
            score_map[k] = score_map.get(k, 0) + weight

        candidates = all_nodes if has_constraints else snapshot.have_pods_with_affinity_list if snapshot else all_nodes
        for ni in candidates:
            node = ni.node
            labels = node.metadata.labels
            pods = ni.pods if has_constraints else ni.pods_with_affinity
            for pi in pods:
                existing = pi.pod
                # incoming pod's preferred terms vs existing pod
                if aff:
                    for wt in aff.pod_affinity_preferred:
                        val = labels.get(wt.term.topology_key)
                        if val is not None and term_matches_pod(wt.term, pod, existing, ns_labels):
                            bump(wt.term.topology_key, val, wt.weight)
                    for wt in aff.pod_anti_affinity_preferred:
                        val = labels.get(wt.term.topology_key)
                        if val is not None and term_matches_pod(wt.term, pod, existing, ns_labels):
                            bump(wt.term.topology_key, val, -wt.weight)
                # existing pod's preferred terms vs incoming pod (symmetry)
                for wt in pi.preferred_affinity_terms:
                    val = labels.get(wt.term.topology_key)
                    if val is not None and term_matches_pod(wt.term, existing, pod, ns_labels):
                        bump(wt.term.topology_key, val, wt.weight)
                for wt in pi.preferred_anti_affinity_terms:
                    val = labels.get(wt.term.topology_key)
                    if val is not None and term_matches_pod(wt.term, existing, pod, ns_labels):
                        bump(wt.term.topology_key, val, -wt.weight)
                # existing pod's REQUIRED affinity terms, hard weight (symmetry)
                if self.hard_pod_affinity_weight > 0:
                    for term in pi.required_affinity_terms:
                        val = labels.get(term.topology_key)
                        if val is not None and term_matches_pod(term, existing, pod, ns_labels):
                            bump(term.topology_key, val, self.hard_pod_affinity_weight)

        if not score_map:
            state.write(_SCORE_KEY, None)
            return Status.skip(plugin=self.name)
        state.write(_SCORE_KEY, score_map)
        return SUCCESS

    def score(self, state: CycleState, pod, node_info: NodeInfo) -> Tuple[int, Status]:
        score_map = state.read_or_none(_SCORE_KEY)
        if not score_map:
            return 0, SUCCESS
        labels = node_info.node.metadata.labels
        total = 0
        for (tk, tv), w in score_map.items():
            if labels.get(tk) == tv:
                total += w
        return total, SUCCESS

    def normalize_score(self, state: CycleState, pod, scores: Dict[str, int]) -> Status:
        if not scores:
            return SUCCESS
        max_c = max(scores.values())
        min_c = min(scores.values())
        diff = max_c - min_c
        for k, v in scores.items():
            scores[k] = int(MAX_NODE_SCORE * (v - min_c) / diff) if diff > 0 else 0
        return SUCCESS
