"""Small node-predicate/score plugins: NodeName, NodePorts, NodeUnschedulable,
NodeAffinity, TaintToleration, ImageLocality, SchedulingGates, PrioritySort.

reference: pkg/scheduler/framework/plugins/{nodename/node_name.go,
nodeports/node_ports.go, nodeunschedulable/node_unschedulable.go,
nodeaffinity/node_affinity.go, tainttoleration/taint_toleration.go,
imagelocality/image_locality.go, schedulinggates/scheduling_gates.go,
queuesort/priority_sort.go}.

The counterpart of `kubernetes_tpu/scheduler/plugins/node_plugins.py`, host Python with
the same integer arithmetic (the parity tests hold scores equal).
"""

from __future__ import annotations

from typing import Dict, Tuple

from ...api import find_matching_untolerated_taint
from ...api.types import TAINT_NO_EXECUTE, TAINT_NO_SCHEDULE, TAINT_PREFER_NO_SCHEDULE
from ..framework import (
    MAX_NODE_SCORE,
    CycleState,
    NodeInfo,
    Plugin,
    Status,
    SUCCESS,
    default_normalize_score,
)
from .helpers import node_matches_node_selector_and_affinity


class NodeName(Plugin):
    """Filter: pod.Spec.NodeName == node.Name (node_name.go)."""

    name = "NodeName"

    def events_to_register(self):
        from ..framework import ClusterEventWithHint

        def is_the_node(pod, node):
            return node.metadata.name == pod.spec.node_name

        return (ClusterEventWithHint("nodes", "add", is_the_node),)

    def filter(self, state, pod, node_info: NodeInfo) -> Status:
        if pod.spec.node_name and pod.spec.node_name != node_info.node.metadata.name:
            return Status.unschedulable("node(s) didn't match the requested node name",
                                        plugin=self.name)
        return SUCCESS


class NodePorts(Plugin):
    """Filter host-port conflicts (node_ports.go)."""

    name = "NodePorts"
    _KEY = "PreFilterNodePorts"

    def events_to_register(self):
        from ..framework import ClusterEventWithHint, _host_ports

        def freed_wanted_port(pod, event_pod):
            if not event_pod.spec.node_name:
                return False
            wanted = {(proto, port) for _, proto, port in _host_ports(pod)}
            return any((proto, port) in wanted
                       for _, proto, port in _host_ports(event_pod))

        return (ClusterEventWithHint("nodes", "add"),
                ClusterEventWithHint("pods", "delete", freed_wanted_port))

    def pre_filter(self, state: CycleState, pod, snapshot):
        from ..framework import _host_ports

        ports = list(_host_ports(pod))
        state.write(self._KEY, ports)
        if not ports:
            return None, Status.skip(plugin=self.name)
        return None, SUCCESS

    def filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        from ..framework import _host_ports

        ports = state.read_or_none(self._KEY)
        if ports is None:
            ports = list(_host_ports(pod))
        for ip, proto, port in ports:
            for uip, uproto, uport in node_info.used_ports:
                if port == uport and proto == uproto and (
                    ip == "0.0.0.0" or uip == "0.0.0.0" or ip == uip
                ):
                    return Status.unschedulable("node(s) didn't have free ports for the requested pod ports",
                                                plugin=self.name)
        return SUCCESS


class NodeUnschedulable(Plugin):
    """Filter spec.unschedulable, honoring the unschedulable taint toleration
    (node_unschedulable.go)."""

    name = "NodeUnschedulable"
    _UNSCHEDULABLE_TAINT_KEY = "node.kubernetes.io/unschedulable"

    def events_to_register(self):
        from ..framework import ClusterEventWithHint

        def now_schedulable(pod, node):
            return not node.spec.unschedulable

        return (ClusterEventWithHint("nodes", "add", now_schedulable),
                ClusterEventWithHint("nodes", "update", now_schedulable))

    def filter(self, state, pod, node_info: NodeInfo) -> Status:
        if not node_info.node.spec.unschedulable:
            return SUCCESS
        # Tolerating the synthesized unschedulable taint admits the pod
        # (node_unschedulable.go TolerationsTolerateTaint).
        from ...api import Taint

        fake = Taint(key=self._UNSCHEDULABLE_TAINT_KEY, effect=TAINT_NO_SCHEDULE)
        if any(t.tolerates(fake) for t in pod.spec.tolerations):
            return SUCCESS
        return Status.unresolvable("node(s) were unschedulable", plugin=self.name)


class NodeAffinity(Plugin):
    """Filter: nodeSelector AND required node affinity; Score: sum of matched
    preferred term weights, DefaultNormalizeScore (node_affinity.go)."""

    name = "NodeAffinity"

    def events_to_register(self):
        from ..framework import ClusterEventWithHint

        def node_matches(pod, node):
            return node_matches_node_selector_and_affinity(pod, node)

        return (ClusterEventWithHint("nodes", "add", node_matches),
                ClusterEventWithHint("nodes", "update", node_matches))

    def filter(self, state, pod, node_info: NodeInfo) -> Status:
        if not node_matches_node_selector_and_affinity(pod, node_info.node):
            return Status.unresolvable("node(s) didn't match Pod's node affinity/selector",
                                       plugin=self.name)
        return SUCCESS

    def score(self, state, pod, node_info: NodeInfo) -> Tuple[int, Status]:
        aff = pod.spec.affinity
        if not aff or not aff.node_affinity_preferred:
            return 0, SUCCESS
        total = 0
        for pref in aff.node_affinity_preferred:
            if pref.term.matches(node_info.node):
                total += pref.weight
        return total, SUCCESS

    def normalize_score(self, state, pod, scores: Dict[str, int]) -> Status:
        default_normalize_score(MAX_NODE_SCORE, False, scores)
        return SUCCESS


class TaintToleration(Plugin):
    """Filter NoSchedule/NoExecute taints; Score counts intolerable
    PreferNoSchedule taints, normalized reversed (taint_toleration.go)."""

    name = "TaintToleration"

    def events_to_register(self):
        from ..framework import ClusterEventWithHint

        def taints_tolerated(pod, node):
            return find_matching_untolerated_taint(
                node.spec.taints, pod.spec.tolerations,
                effects=(TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE)) is None

        return (ClusterEventWithHint("nodes", "add", taints_tolerated),
                ClusterEventWithHint("nodes", "update", taints_tolerated))

    def filter(self, state, pod, node_info: NodeInfo) -> Status:
        taint = find_matching_untolerated_taint(
            node_info.node.spec.taints, pod.spec.tolerations,
            effects=(TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE),
        )
        if taint is None:
            return SUCCESS
        return Status.unresolvable(
            f"node(s) had untolerated taint {{{taint.key}: {taint.value}}}", plugin=self.name
        )

    def pre_score(self, state: CycleState, pod, nodes) -> Status:
        # Tolerations with empty effect also cover PreferNoSchedule
        # (taint_toleration.go:133-141).
        tols = [t for t in pod.spec.tolerations if t.effect in ("", TAINT_PREFER_NO_SCHEDULE)]
        state.write("PreScoreTaintToleration", tols)
        return SUCCESS

    def score(self, state, pod, node_info: NodeInfo) -> Tuple[int, Status]:
        tols = state.read_or_none("PreScoreTaintToleration")
        if tols is None:
            tols = [t for t in pod.spec.tolerations if t.effect in ("", TAINT_PREFER_NO_SCHEDULE)]
        count = 0
        for taint in node_info.node.spec.taints:
            if taint.effect != TAINT_PREFER_NO_SCHEDULE:
                continue
            if not any(t.tolerates(taint) for t in tols):
                count += 1
        return count, SUCCESS

    def normalize_score(self, state, pod, scores: Dict[str, int]) -> Status:
        default_normalize_score(MAX_NODE_SCORE, True, scores)
        return SUCCESS


class ImageLocality(Plugin):
    """Score by image bytes already on node, scaled by image spread across nodes
    (image_locality.go:78-117)."""

    name = "ImageLocality"

    MIN_THRESHOLD = 23 * 1024 * 1024  # mb*23 (image_locality.go:36-40)
    MAX_CONTAINER_THRESHOLD = 1000 * 1024 * 1024

    def score(self, state, pod, node_info: NodeInfo) -> Tuple[int, Status]:
        total_nodes = state.read_or_none("TotalNodes") or 1
        sum_scores = 0
        for c in list(pod.spec.init_containers) + list(pod.spec.containers):
            img = _normalized_image_name(c.image)
            st = node_info.image_states.get(img)
            if st is not None:
                spread = st.num_nodes / total_nodes
                sum_scores += int(st.size * spread)
        num_containers = len(pod.spec.containers) + len(pod.spec.init_containers)
        max_threshold = self.MAX_CONTAINER_THRESHOLD * num_containers
        sum_scores = min(max(sum_scores, self.MIN_THRESHOLD), max_threshold)
        return MAX_NODE_SCORE * (sum_scores - self.MIN_THRESHOLD) // (max_threshold - self.MIN_THRESHOLD), SUCCESS


class SchedulingGates(Plugin):
    """PreEnqueue: hold gated pods out of the active queue (scheduling_gates.go)."""

    name = "SchedulingGates"

    def pre_enqueue(self, pod) -> Status:
        if pod.spec.scheduling_gates:
            gates = ", ".join(pod.spec.scheduling_gates)
            return Status.unresolvable(f"waiting for scheduling gates: {gates}", plugin=self.name)
        return SUCCESS


class PrioritySort(Plugin):
    """QueueSort: priority desc, then creation/queue timestamp asc (priority_sort.go)."""

    name = "PrioritySort"

    def less(self, pod_info_a, pod_info_b) -> bool:
        pa, pb = pod_info_a.pod.spec.priority, pod_info_b.pod.spec.priority
        if pa != pb:
            return pa > pb
        return pod_info_a.timestamp < pod_info_b.timestamp


def _normalized_image_name(name: str) -> str:
    if name.rfind(":") <= name.rfind("/"):
        name += ":latest"
    return name
