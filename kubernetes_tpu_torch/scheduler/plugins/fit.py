"""NodeResourcesFit + scoring strategies + BalancedAllocation.

reference: pkg/scheduler/framework/plugins/noderesources/{fit.go,
least_allocated.go:30, most_allocated.go:30, balanced_allocation.go:145-179,
resource_allocation.go}.

The counterpart of `kubernetes_tpu/scheduler/plugins/fit.py`, host Python with
the same integer arithmetic (the parity tests hold scores equal).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ...api import Resource
from ...api.resources import CPU, MEMORY
from ..framework import (
    MAX_NODE_SCORE,
    CycleState,
    NodeInfo,
    Plugin,
    Status,
    SUCCESS,
)

_STATE_KEY = "PreFilterNodeResourcesFit"
# the pod's non-zero request for Score, written by the first score() of a cycle
_NON_ZERO_KEY = "ScoreNodeResourcesFitNonZero"

DEFAULT_RESOURCES = ({"name": CPU, "weight": 1}, {"name": MEMORY, "weight": 1})


class NodeResourcesFit(Plugin):
    """PreFilter computes the pod request vector once (fit.go:230); Filter checks
    request <= allocatable - requested per resource incl. scalar resources and
    pod count (fit.go:499-580); Score applies the configured strategy."""

    name = "NodeResourcesFit"

    def __init__(self, strategy: str = "LeastAllocated", resources=DEFAULT_RESOURCES,
                 ignored_resources: Tuple[str, ...] = (), shape=None):
        self.strategy = strategy
        self.resources = tuple(resources)
        self.ignored_resources = set(ignored_resources)
        # RequestedToCapacityRatio piecewise-linear shape: [(utilization, score)]
        self.shape = shape or [(0, 0), (100, 10)]

    def events_to_register(self):
        """fit.go EventsToRegister: Node add/update (more capacity may fit the
        pod), assigned-Pod delete/update (resources freed)."""
        from ..framework import ClusterEventWithHint

        def node_could_fit(pod, node):
            # isSchedulableAfterNodeChange simplification: queue when the
            # request fits the node's full allocatable (optimistic — the
            # filter re-checks against live usage)
            from ...api import Resource, compute_pod_resource_request

            req = compute_pod_resource_request(pod)
            alloc = Resource.from_resource_list(node.status.allocatable)
            return (req.milli_cpu <= alloc.milli_cpu and req.memory <= alloc.memory
                    and all(alloc.scalar.get(k, 0) >= v for k, v in req.scalar.items()))

        def assigned_pod_freed(pod, event_pod):
            return bool(event_pod.spec.node_name)

        return (ClusterEventWithHint("nodes", "add", node_could_fit),
                ClusterEventWithHint("nodes", "update", node_could_fit),
                ClusterEventWithHint("pods", "delete", assigned_pod_freed),
                ClusterEventWithHint("pods", "update", assigned_pod_freed))

    # -- PreFilter -------------------------------------------------------------

    def pre_filter(self, state: CycleState, pod, snapshot):
        from ...api import compute_pod_resource_request

        state.write(_STATE_KEY, compute_pod_resource_request(pod))
        return None, SUCCESS

    # -- Filter ----------------------------------------------------------------

    def filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        req: Resource = state.read_or_none(_STATE_KEY)
        if req is None:
            from ...api import compute_pod_resource_request

            req = compute_pod_resource_request(pod)
        reasons = []
        alloc = node_info.allocatable
        used = node_info.requested
        if len(node_info.pods) + 1 > alloc.allowed_pod_number:
            reasons.append("Too many pods")
        if req.milli_cpu and req.milli_cpu > alloc.milli_cpu - used.milli_cpu:
            reasons.append("Insufficient cpu")
        if req.memory and req.memory > alloc.memory - used.memory:
            reasons.append("Insufficient memory")
        if req.ephemeral_storage and \
                req.ephemeral_storage > alloc.ephemeral_storage - used.ephemeral_storage:
            reasons.append("Insufficient ephemeral-storage")
        for name, v in req.scalar.items():
            if name in self.ignored_resources or v == 0:
                continue
            if v > alloc.scalar.get(name, 0) - used.scalar.get(name, 0):
                reasons.append(f"Insufficient {name}")
        if reasons:
            return Status.unschedulable(*reasons, plugin=self.name)
        return SUCCESS

    # -- Score -----------------------------------------------------------------

    def score(self, state: CycleState, pod, node_info: NodeInfo) -> Tuple[int, Status]:
        # Fit strategies score on NonZeroRequested (resource_allocation.go:90-92,
        # useRequested=false), so best-effort pods still spread. The pod's
        # non-zero request is computed once a cycle, on the first node scored.
        nz: Resource = state.read_or_none(_NON_ZERO_KEY)
        if nz is None:
            from ...api import compute_pod_resource_request

            nz = compute_pod_resource_request(pod, non_zero=True)
            state.write(_NON_ZERO_KEY, nz)
        requested, allocatable = _requested_allocatable(
            node_info, pod, self.resources, node_info.non_zero_requested, non_zero_pod=True,
            pod_request=nz)
        if self.strategy == "LeastAllocated":
            return _least_allocated(requested, allocatable, self.resources), SUCCESS
        if self.strategy == "MostAllocated":
            return _most_allocated(requested, allocatable, self.resources), SUCCESS
        if self.strategy == "RequestedToCapacityRatio":
            return _requested_to_capacity_ratio(requested, allocatable, self.resources, self.shape), SUCCESS
        return 0, Status.error(f"unknown strategy {self.strategy}", plugin=self.name)


class BalancedAllocation(Plugin):
    """score = (1 - std(utilization fractions)) * 100 with the 2-resource shortcut
    |f1-f2|/2 (balanced_allocation.go:145-179). Skips best-effort pods
    (PreScore returns Skip). Uses Requested (useRequested=true)."""

    name = "NodeResourcesBalancedAllocation"

    def __init__(self, resources=DEFAULT_RESOURCES):
        self.resources = tuple(resources)

    def pre_score(self, state: CycleState, pod, nodes) -> Status:
        from ...api import compute_pod_resource_request

        req = compute_pod_resource_request(pod)
        if all(req.get(r["name"]) == 0 for r in self.resources):
            return Status.skip(plugin=self.name)
        state.write("PreScoreBalanced", req)
        return SUCCESS

    def score(self, state: CycleState, pod, node_info: NodeInfo) -> Tuple[int, Status]:
        req = state.read_or_none("PreScoreBalanced")
        if req is None:
            from ...api import compute_pod_resource_request

            req = compute_pod_resource_request(pod)
        requested, allocatable = _requested_allocatable(
            node_info, pod, self.resources, node_info.requested, non_zero_pod=False, pod_request=req
        )
        fractions = []
        for r, a in zip(requested, allocatable):
            if a == 0:
                continue
            fractions.append(min(r / a, 1.0))
        if len(fractions) == 2:
            std = abs(fractions[0] - fractions[1]) / 2
        elif len(fractions) > 2:
            mean = sum(fractions) / len(fractions)
            std = math.sqrt(sum((f - mean) ** 2 for f in fractions) / len(fractions))
        else:
            std = 0.0
        return int((1 - std) * MAX_NODE_SCORE), SUCCESS


def _requested_allocatable(node_info: NodeInfo, pod, resources, node_requested: Resource,
                           non_zero_pod: bool, pod_request: Optional[Resource] = None):
    """Per-configured-resource (requested+podRequest, allocatable) vectors."""
    from ...api import compute_pod_resource_request

    if pod_request is None:
        pod_request = compute_pod_resource_request(pod, non_zero=non_zero_pod)
    req_vec, alloc_vec = [], []
    for spec in resources:
        name = spec["name"]
        req_vec.append(node_requested.get(name) + pod_request.get(name))
        alloc_vec.append(node_info.allocatable.get(name))
    return req_vec, alloc_vec


def _least_allocated(requested: List[int], allocatable: List[int], resources) -> int:
    score = weight_sum = 0
    for req, alloc, spec in zip(requested, allocatable, resources):
        if alloc == 0:
            continue
        w = spec.get("weight", 1)
        if req > alloc:
            rs = 0
        else:
            rs = (alloc - req) * MAX_NODE_SCORE // alloc
        score += rs * w
        weight_sum += w
    return score // weight_sum if weight_sum else 0


def _most_allocated(requested: List[int], allocatable: List[int], resources) -> int:
    score = weight_sum = 0
    for req, alloc, spec in zip(requested, allocatable, resources):
        if alloc == 0:
            continue
        w = spec.get("weight", 1)
        rs = min(req, alloc) * MAX_NODE_SCORE // alloc
        score += rs * w
        weight_sum += w
    return score // weight_sum if weight_sum else 0


def _requested_to_capacity_ratio(requested, allocatable, resources, shape) -> int:
    """Piecewise-linear on utilization% (requested_to_capacity_ratio.go:60);
    shape points (utilization 0-100, score 0-10), scores scaled to 0-100."""
    score = weight_sum = 0
    for req, alloc, spec in zip(requested, allocatable, resources):
        if alloc == 0:
            continue
        w = spec.get("weight", 1)
        util = min(req * 100 // alloc, 100)
        score += _interp(shape, util) * 10 * w
        weight_sum += w
    return score // weight_sum if weight_sum else 0


def _interp(shape, x: int) -> int:
    if x <= shape[0][0]:
        return shape[0][1]
    for (x0, y0), (x1, y1) in zip(shape, shape[1:]):
        if x <= x1:
            return int(y0 + (y1 - y0) * (x - x0) / (x1 - x0))
    return shape[-1][1]
