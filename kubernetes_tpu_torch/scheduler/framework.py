"""Scheduler framework: plugin contract, statuses, CycleState, NodeInfo,
PodInfo and the per-cycle Snapshot.

The counterpart of `kubernetes_tpu/scheduler/framework.py` (reference:
pkg/scheduler/framework/interface.go — the extension points PreEnqueue,
QueueSort, PreFilter, Filter, PostFilter, PreScore, Score(+Normalize),
Reserve, Permit, PreBind, Bind, PostBind; Status codes :186-293;
CycleState cycle_state.go:48; types.go NodeInfo :734 and PodInfo :412;
backend/cache/snapshot.go). The serial plugins (scheduler/plugins) run these
semantics per pod on the host; the batch path encodes the default profile's
into tensors for the solvers.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from ..api import Pod, Resource, compute_pod_resource_request

MAX_NODE_SCORE = 100  # interface.go:255
MIN_NODE_SCORE = 0


class Code(enum.Enum):
    """Status codes (reference: interface.go:186)."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5
    PENDING = 6


@dataclass
class Status:
    code: Code = Code.SUCCESS
    reasons: Tuple[str, ...] = ()
    plugin: str = ""

    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def is_skip(self) -> bool:
        return self.code == Code.SKIP

    def is_rejected(self) -> bool:
        return self.code in (Code.UNSCHEDULABLE, Code.UNSCHEDULABLE_AND_UNRESOLVABLE, Code.PENDING)

    def message(self) -> str:
        return "; ".join(self.reasons)

    @staticmethod
    def success() -> "Status":
        return Status()

    @staticmethod
    def unschedulable(*reasons: str, plugin: str = "") -> "Status":
        return Status(Code.UNSCHEDULABLE, tuple(reasons), plugin)

    @staticmethod
    def unresolvable(*reasons: str, plugin: str = "") -> "Status":
        return Status(Code.UNSCHEDULABLE_AND_UNRESOLVABLE, tuple(reasons), plugin)

    @staticmethod
    def error(*reasons: str, plugin: str = "") -> "Status":
        return Status(Code.ERROR, tuple(reasons), plugin)

    @staticmethod
    def skip(plugin: str = "") -> "Status":
        return Status(Code.SKIP, (), plugin)


SUCCESS = Status.success()


class CycleState:
    """Per-scheduling-cycle typed KV store (reference: cycle_state.go:48)."""

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self.skip_filter_plugins: Set[str] = set()
        self.skip_score_plugins: Set[str] = set()

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def read(self, key: str) -> Any:
        return self._data[key]

    def read_or_none(self, key: str) -> Any:
        return self._data.get(key)

    def clone(self) -> "CycleState":
        cs = CycleState()
        cs._data = {k: (v.clone() if hasattr(v, "clone") else v) for k, v in self._data.items()}
        cs.skip_filter_plugins = set(self.skip_filter_plugins)
        cs.skip_score_plugins = set(self.skip_score_plugins)
        return cs


@dataclass
class PreFilterResult:
    """Optional node-subset fast path (reference: interface.go:841)."""

    node_names: Optional[Set[str]] = None  # None = all nodes

    def merge(self, other: "PreFilterResult") -> "PreFilterResult":
        if self.node_names is None:
            return PreFilterResult(None if other.node_names is None else set(other.node_names))
        if other.node_names is None:
            return PreFilterResult(set(self.node_names))
        return PreFilterResult(self.node_names & other.node_names)

    def all_nodes(self) -> bool:
        return self.node_names is None


class PodInfo:
    """Pod + precomputed scheduling-relevant state (reference: types.go:412)."""

    __slots__ = (
        "pod",
        "request",
        "non_zero_request",
        "required_affinity_terms",
        "required_anti_affinity_terms",
        "preferred_affinity_terms",
        "preferred_anti_affinity_terms",
    )

    def __init__(self, pod: Pod):
        self.pod = pod
        # requests are pure functions of spec, and specs are immutable in
        # practice (every spec change parses a NEW Pod object; structural
        # clones share spec AND this cache via __dict__ copy) — memoizing
        # removes the dominant per-pod cost of cache adds at 100k-bind scale.
        # Consumers treat these Resource objects as read-only.
        cached = pod.__dict__.get("_req_cache")
        if cached is None:
            cached = (compute_pod_resource_request(pod),
                      compute_pod_resource_request(pod, non_zero=True))
            pod.__dict__["_req_cache"] = cached
        self.request, self.non_zero_request = cached
        aff = pod.spec.affinity
        self.required_affinity_terms = tuple(aff.pod_affinity_required) if aff else ()
        self.required_anti_affinity_terms = tuple(aff.pod_anti_affinity_required) if aff else ()
        self.preferred_affinity_terms = tuple(aff.pod_affinity_preferred) if aff else ()
        self.preferred_anti_affinity_terms = tuple(aff.pod_anti_affinity_preferred) if aff else ()


@dataclass
class ImageStateSummary:
    """reference: types.go ImageStateSummary {Size, NumNodes}."""

    size: int
    num_nodes: int


class NodeInfo:
    """Aggregated per-node scheduling state (reference: types.go:734).

    Generation increments on every mutation and drives incremental snapshotting
    (cache.go:186) — the same diff stream the tensorizer consumes.
    """

    __slots__ = (
        "node",
        "pods",
        "pods_with_affinity",
        "pods_with_required_anti_affinity",
        "requested",
        "non_zero_requested",
        "allocatable",
        "used_ports",
        "image_states",
        "generation",
        "col_count",
    )

    def __init__(self, node=None):
        self.node = None
        self.pods: List[PodInfo] = []
        self.pods_with_affinity: List[PodInfo] = []
        self.pods_with_required_anti_affinity: List[PodInfo] = []
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = Resource()
        self.used_ports: Set[Tuple[str, str, int]] = set()  # (hostIP, proto, port)
        self.image_states: Dict[str, ImageStateSummary] = {}
        self.generation = 0
        # Pods held as columnar cache rows (scheduler/cachecols.py) rather
        # than PodInfo objects. Their resources are already folded into
        # `requested`/`non_zero_requested` by the phase-2 scatter; this count
        # keeps pod-population checks (the tensorizer's pod_count) exact
        # without materializing them. Rows are constraint-free by the
        # dispatch gate, so the affinity and port structures owe no entries.
        self.col_count = 0
        if node is not None:
            self.set_node(node)

    def set_node(self, node) -> None:
        self.node = node
        self.allocatable = Resource.from_resource_list(node.status.allocatable)
        # Per-node view of image states; the Cache overwrites num_nodes with the
        # cluster-wide spread count (cache.go createImageStateSummary).
        if node.status.images and not self.image_states:
            self.image_states = {
                nm: ImageStateSummary(size=img.size_bytes, num_nodes=1)
                for img in node.status.images
                for nm in img.names
            }

    def add_pod(self, pod_info: PodInfo) -> None:
        self.pods.append(pod_info)
        if pod_info.required_affinity_terms or pod_info.preferred_affinity_terms or \
           pod_info.required_anti_affinity_terms or pod_info.preferred_anti_affinity_terms:
            self.pods_with_affinity.append(pod_info)
        if pod_info.required_anti_affinity_terms:
            self.pods_with_required_anti_affinity.append(pod_info)
        self.requested.add(pod_info.request)
        self.non_zero_requested.add(pod_info.non_zero_request)
        for port in _host_ports(pod_info.pod):
            self.used_ports.add(port)

    def remove_pod(self, pod: Pod) -> bool:
        uid = pod.metadata.uid
        for i, pi in enumerate(self.pods):
            if pi.pod.metadata.uid == uid:
                self.pods.pop(i)
                self.pods_with_affinity = [p for p in self.pods_with_affinity if p.pod.metadata.uid != uid]
                self.pods_with_required_anti_affinity = [
                    p for p in self.pods_with_required_anti_affinity if p.pod.metadata.uid != uid
                ]
                self.requested.sub(pi.request)
                self.non_zero_requested.sub(pi.non_zero_request)
                for port in _host_ports(pi.pod):
                    self.used_ports.discard(port)
                return True
        return False

    def clone(self) -> "NodeInfo":
        ni = NodeInfo()
        ni.node = self.node
        ni.pods = list(self.pods)
        ni.pods_with_affinity = list(self.pods_with_affinity)
        ni.pods_with_required_anti_affinity = list(self.pods_with_required_anti_affinity)
        ni.requested = self.requested.clone()
        ni.non_zero_requested = self.non_zero_requested.clone()
        ni.allocatable = self.allocatable.clone()
        ni.used_ports = set(self.used_ports)
        ni.image_states = dict(self.image_states)
        ni.generation = self.generation
        ni.col_count = self.col_count
        return ni


def _host_ports(pod: Pod) -> Iterable[Tuple[str, str, int]]:
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port > 0:
                yield (p.host_ip or "0.0.0.0", p.protocol or "TCP", p.host_port)


class Snapshot:
    """Immutable per-cycle view of cluster state (reference: backend/cache/snapshot.go:198).

    `changed_names`/`changed_from_gen` carry the incremental-diff provenance
    when the snapshot was derived via `from_prev`: the set of node names whose
    NodeInfo differs from the snapshot at cache generation `changed_from_gen`.
    Consumers holding that predecessor (TensorCache) can requantize exactly
    those rows instead of identity-walking the full node list. A full-built
    snapshot leaves them None (meaning: diff unknown, walk everything).
    """

    def __init__(self, node_infos: Optional[Dict[str, NodeInfo]] = None):
        self.node_info_map: Dict[str, NodeInfo] = node_infos or {}
        self.node_info_list: List[NodeInfo] = list(self.node_info_map.values())
        self._name_index: Dict[str, int] = {
            name: i for i, name in enumerate(self.node_info_map)
        }
        self.have_pods_with_affinity_list: List[NodeInfo] = [
            n for n in self.node_info_list if n.pods_with_affinity
        ]
        self.have_pods_with_required_anti_affinity_list: List[NodeInfo] = [
            n for n in self.node_info_list if n.pods_with_required_anti_affinity
        ]
        self.generation = 0
        self.changed_names: Optional[frozenset] = None
        self.changed_from_gen: Optional[int] = None

    @classmethod
    def from_prev(cls, prev: "Snapshot", changed: Dict[str, NodeInfo]) -> "Snapshot":
        """Derive a snapshot from `prev` with only `changed` nodes replaced.

        Only valid when the NODE SET is unchanged (same names, same order) —
        the cache's dirty-name tracking falls back to a full build on any
        node add/remove/promote. List positions are patched in place via the
        shared name index, so node ordering (and therefore every downstream
        tensor row order) is bit-identical to a full rebuild.
        """
        snap = cls.__new__(cls)
        snap.node_info_map = dict(prev.node_info_map)
        snap.node_info_map.update(changed)
        snap._name_index = prev._name_index  # same node set: shared, immutable
        lst = list(prev.node_info_list)
        affinity_dirty = False
        for name, ni in changed.items():
            old = prev.node_info_list[prev._name_index[name]]
            lst[prev._name_index[name]] = ni
            if (ni.pods_with_affinity or old.pods_with_affinity
                    or ni.pods_with_required_anti_affinity
                    or old.pods_with_required_anti_affinity):
                affinity_dirty = True
        snap.node_info_list = lst
        if affinity_dirty:
            snap.have_pods_with_affinity_list = [n for n in lst if n.pods_with_affinity]
            snap.have_pods_with_required_anti_affinity_list = [
                n for n in lst if n.pods_with_required_anti_affinity
            ]
        else:
            snap.have_pods_with_affinity_list = prev.have_pods_with_affinity_list
            snap.have_pods_with_required_anti_affinity_list = (
                prev.have_pods_with_required_anti_affinity_list
            )
        snap.generation = 0
        snap.changed_names = frozenset(changed)
        snap.changed_from_gen = prev.generation
        return snap

    def get(self, name: str) -> Optional[NodeInfo]:
        return self.node_info_map.get(name)

    def __len__(self) -> int:
        return len(self.node_info_list)


# ---------------------------------------------------------------------------
# Plugin base classes. A plugin implements any subset; the framework runtime
# dispatches by hasattr on these method names.
# ---------------------------------------------------------------------------


class ClusterEventWithHint:
    """reference: framework/interface.go ClusterEventWithHint — an event a
    plugin cares about plus an optional QueueingHintFn. The hint decides
    whether the event could make a pod this plugin rejected schedulable:
    hint(pod, event_obj) -> bool (True = Queue, False = Skip). hint=None means
    always Queue (the pre-hints behavior for that event)."""

    __slots__ = ("resource", "action", "hint")

    def __init__(self, resource: str, action: str, hint=None):
        self.resource = resource  # store kind: "pods", "nodes", "podgroups"
        self.action = action  # "add" | "update" | "delete"
        self.hint = hint


class Plugin:
    name: str = "Plugin"

    # PreEnqueue(pod) -> Status
    # pre_filter(state, pod, snapshot) -> (PreFilterResult|None, Status)
    # filter(state, pod, node_info) -> Status
    # post_filter(state, pod, statuses) -> (nominated_node|None, Status)
    # pre_score(state, pod, nodes) -> Status
    # score(state, pod, node_info) -> (int, Status)
    # normalize_score(state, pod, scores: dict) -> Status
    # reserve/unreserve, permit, pre_bind, bind, post_bind
    # add_pod/remove_pod: PreFilterExtensions for incremental state updates

    def events_to_register(self):
        """EnqueueExtensions (interface.go:482): the cluster events that can
        make a pod rejected by this plugin schedulable. Default: none — a
        plugin that never rejects needs no events."""
        return ()


def default_normalize_score(max_priority: int, reverse: bool, scores: Dict[str, int]) -> None:
    """reference: plugins/helper/normalize_score.go DefaultNormalizeScore."""
    max_count = max(scores.values(), default=0)
    if max_count == 0:
        if reverse:
            for k in scores:
                scores[k] = max_priority
        return
    for k, v in scores.items():
        s = max_priority * v // max_count
        scores[k] = max_priority - s if reverse else s
