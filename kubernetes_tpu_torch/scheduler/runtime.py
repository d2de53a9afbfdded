"""Framework runtime — executes plugins per extension point.

The counterpart of `kubernetes_tpu/scheduler/runtime.py` (reference:
pkg/scheduler/framework/runtime/framework.go (frameworkImpl):
RunPreFilterPlugins (merges PreFilterResults, records Skip set),
RunFilterPlugins (first rejection wins), RunFilterPluginsWithNominatedPods
:984, RunPostFilterPlugins, RunScorePlugins :1112 (three passes: score per
node, NormalizeScore per plugin, apply weight), plus the
Reserve/Permit/PreBind/Bind/PostBind chains).

The reference parallelizes the per-node passes over 16 goroutines
(parallelize/parallelism.go); in CPython that adds only overhead, so the
per-pod cycle runs them in a plain loop on the host. The batch path's
solvers are the parallel form of the same default profile.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .framework import (
    Code,
    CycleState,
    NodeInfo,
    Plugin,
    PreFilterResult,
    Snapshot,
    Status,
    SUCCESS,
)

# Default plugin weights (reference: apis/config/v1/default_plugins.go:30-56).
DEFAULT_WEIGHTS = {
    "TaintToleration": 3,
    "NodeAffinity": 2,
    "PodTopologySpread": 2,
    "InterPodAffinity": 2,
    "NodeResourcesFit": 1,
    "NodeResourcesBalancedAllocation": 1,
    "ImageLocality": 1,
}


class Framework:
    def __init__(self, plugins: Sequence[Plugin], weights: Optional[Dict[str, int]] = None,
                 disabled_points: Optional[set] = None):
        self.plugins = list(plugins)
        self.weights = dict(DEFAULT_WEIGHTS)
        if weights:
            self.weights.update(weights)
        # (plugin name, method name) pairs a profile disabled at one extension
        # point (apis/config/types.go PluginSet.Disabled)
        disabled = disabled_points or set()

        def at(method: str):
            return [p for p in self.plugins
                    if hasattr(p, method) and (p.name, method) not in disabled]

        self.pre_enqueue_plugins = at("pre_enqueue")
        self.pre_filter_plugins = at("pre_filter")
        self.filter_plugins = at("filter")
        self.post_filter_plugins = at("post_filter")
        self.pre_score_plugins = at("pre_score")
        self.score_plugins = at("score")
        self.reserve_plugins = at("reserve")
        self.permit_plugins = at("permit")
        self.pre_bind_plugins = at("pre_bind")
        self.bind_plugins = at("bind")
        self.post_bind_plugins = at("post_bind")
        self.queue_sort_plugin = next(iter(at("less")), None)

    # -- PreEnqueue ------------------------------------------------------------

    def run_pre_enqueue(self, pod) -> Status:
        for p in self.pre_enqueue_plugins:
            st = p.pre_enqueue(pod)
            if not st.is_success():
                return st
        return SUCCESS

    # -- PreFilter -------------------------------------------------------------

    def run_pre_filter(self, state: CycleState, pod, snapshot: Snapshot) -> Tuple[PreFilterResult, Status]:
        result = PreFilterResult(None)
        state.write("Snapshot", snapshot)
        state.write("TotalNodes", len(snapshot))
        for p in self.pre_filter_plugins:
            r, st = p.pre_filter(state, pod, snapshot)
            if st.is_skip():
                state.skip_filter_plugins.add(p.name)
                continue
            if not st.is_success():
                st.plugin = st.plugin or p.name
                return result, st
            if r is not None:
                result = result.merge(r)
                if r.node_names is not None and not r.node_names:
                    return result, Status.unresolvable(
                        "node(s) didn't satisfy plugin prefilter", plugin=p.name
                    )
        return result, SUCCESS

    # -- Filter ----------------------------------------------------------------

    def run_filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        for p in self.filter_plugins:
            if p.name in state.skip_filter_plugins:
                continue
            st = p.filter(state, pod, node_info)
            if not st.is_success():
                st.plugin = st.plugin or p.name
                return st
        return SUCCESS

    def run_filter_with_nominated_pods(self, state: CycleState, pod, node_info: NodeInfo,
                                       nominated_pods_for_node=()) -> Status:
        """Filters run twice when nominated pods exist: once assuming higher/equal
        priority nominated pods are running on the node, once without
        (runtime/framework.go:984 RunFilterPluginsWithNominatedPods)."""
        from .framework import PodInfo

        if nominated_pods_for_node:
            state_with = state.clone()
            ni = node_info.clone()
            for np in nominated_pods_for_node:
                pi = PodInfo(np)
                ni.add_pod(pi)
                self.run_add_pod(state_with, pod, np, ni)
            st = self.run_filter(state_with, pod, ni)
            if not st.is_success():
                return st
        return self.run_filter(state, pod, node_info)

    def run_add_pod(self, state: CycleState, pod, added_pod, node_info: NodeInfo) -> Status:
        for p in self.filter_plugins:
            if hasattr(p, "add_pod") and p.name not in state.skip_filter_plugins:
                st = p.add_pod(state, pod, added_pod, node_info)
                if not st.is_success():
                    return st
        return SUCCESS

    def run_remove_pod(self, state: CycleState, pod, removed_pod, node_info: NodeInfo) -> Status:
        for p in self.filter_plugins:
            if hasattr(p, "remove_pod") and p.name not in state.skip_filter_plugins:
                st = p.remove_pod(state, pod, removed_pod, node_info)
                if not st.is_success():
                    return st
        return SUCCESS

    # -- PostFilter ------------------------------------------------------------

    def run_post_filter(self, state: CycleState, pod, filtered_statuses) -> Tuple[Optional[str], Status]:
        for p in self.post_filter_plugins:
            nominated, st = p.post_filter(state, pod, filtered_statuses)
            if st.is_success() or st.code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE:
                return nominated, st
        return None, Status.unschedulable("no postFilter plugin made the pod schedulable")

    # -- Score -----------------------------------------------------------------

    def run_pre_score(self, state: CycleState, pod, nodes: List[NodeInfo]) -> Status:
        for p in self.pre_score_plugins:
            st = p.pre_score(state, pod, nodes)
            if st.is_skip():
                state.skip_score_plugins.add(p.name)
                continue
            if not st.is_success():
                st.plugin = st.plugin or p.name
                return st
        return SUCCESS

    def run_score(self, state: CycleState, pod, nodes: List[NodeInfo]) -> Dict[str, int]:
        """Returns node name -> weighted total score (RunScorePlugins :1112)."""
        totals: Dict[str, int] = {ni.node.metadata.name: 0 for ni in nodes}
        for p in self.score_plugins:
            if p.name in state.skip_score_plugins:
                continue
            scores: Dict[str, int] = {}
            for ni in nodes:
                s, st = p.score(state, pod, ni)
                if not st.is_success():
                    raise RuntimeError(f"score plugin {p.name} failed: {st.message()}")
                scores[ni.node.metadata.name] = s
            if hasattr(p, "normalize_score"):
                p.normalize_score(state, pod, scores)
            w = self.weights.get(p.name, 1)
            for name, s in scores.items():
                totals[name] += s * w
        return totals

    # -- Reserve / Permit / Bind ----------------------------------------------

    def run_reserve(self, state: CycleState, pod, node_name: str) -> Status:
        for p in self.reserve_plugins:
            st = p.reserve(state, pod, node_name)
            if not st.is_success():
                for q in self.reserve_plugins:
                    if hasattr(q, "unreserve"):
                        q.unreserve(state, pod, node_name)
                return st
        return SUCCESS

    def run_unreserve(self, state: CycleState, pod, node_name: str) -> None:
        for p in self.reserve_plugins:
            if hasattr(p, "unreserve"):
                p.unreserve(state, pod, node_name)

    def run_permit(self, state: CycleState, pod, node_name: str) -> Status:
        for p in self.permit_plugins:
            st = p.permit(state, pod, node_name)
            if not st.is_success() and st.code != Code.WAIT:
                return st
        return SUCCESS

    def run_pre_bind(self, state: CycleState, pod, node_name: str) -> Status:
        for p in self.pre_bind_plugins:
            st = p.pre_bind(state, pod, node_name)
            if not st.is_success():
                return st
        return SUCCESS

    def run_bind(self, state: CycleState, pod, node_name: str) -> Status:
        for p in self.bind_plugins:
            st = p.bind(state, pod, node_name)
            if st.is_skip():
                continue
            return st
        return Status.error("no bind plugin handled the pod")

    def run_post_bind(self, state: CycleState, pod, node_name: str) -> None:
        for p in self.post_bind_plugins:
            p.post_bind(state, pod, node_name)
