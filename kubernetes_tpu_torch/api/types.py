"""Typed object model: ObjectMeta, Pod, Node, Namespace.

The subset of the k8s core/v1 API surface the batch scheduler reads
(reference: staging/src/k8s.io/api/core/v1/types.go — Pod, PodSpec, Node,
Taint, Toleration, Affinity, TopologySpreadConstraint) and ObjectMeta
(reference: staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go).
Field names, defaults and matching rules are those of
`kubernetes_tpu/api/types.py`, so the port tensorizes the same objects into
the same arrays. Objects parse from k8s-style camelCase dicts (`from_dict`)
for the fields the scheduler reads.
"""

from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .labels import NodeSelector, PreferredSchedulingTerm, Selector

# Well-known label keys (reference: core/v1 well_known_labels.go)
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"

# A gang member's rank (its position in the job's collective order):
# positional metadata, excluded from the pod class signature so a 250-rank
# gang stays one equivalence class; consumed by the rank-alignment pass
# (models/gangcover.py rank_align). api/podgroup.py re-exports it.
POD_GROUP_RANK_LABEL = "pod-group.scheduling/rank"

# Taint effects
TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"

# Pod phases
PENDING = "Pending"
RUNNING = "Running"
SUCCEEDED = "Succeeded"
FAILED = "Failed"

DEFAULT_SCHEDULER_NAME = "default-scheduler"

_uid_counter = itertools.count(1)
_uid_session = uuid.uuid4().hex[:8]


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}-{_uid_session}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    resource_version: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    deletion_timestamp: Optional[float] = None

    @staticmethod
    def from_dict(d: Mapping) -> "ObjectMeta":
        return ObjectMeta(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            uid=d.get("uid", ""),
            resource_version=int(d.get("resourceVersion", 0) or 0),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            deletion_timestamp=d.get("deletionTimestamp"),
        )

    def to_dict(self) -> Dict[str, Any]:
        """The wire shape of the fields this model holds (the storage and
        DRA kinds' to_dict embed it)."""
        d: Dict[str, Any] = {"name": self.name, "namespace": self.namespace,
                             "uid": self.uid, "resourceVersion": self.resource_version}
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        if self.deletion_timestamp is not None:
            d["deletionTimestamp"] = self.deletion_timestamp
        return d


@dataclass(frozen=True)
class ContainerPort:
    container_port: int
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = ""
    image: str = ""
    resources: Dict[str, Dict[str, Any]] = field(default_factory=dict)  # requests/limits
    ports: List[ContainerPort] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Mapping) -> "Container":
        return Container(
            name=d.get("name", ""),
            image=d.get("image", ""),
            resources=dict(d.get("resources") or {}),
            ports=[
                ContainerPort(
                    container_port=int(p["containerPort"]),
                    host_port=int(p.get("hostPort", 0) or 0),
                    protocol=p.get("protocol", "TCP"),
                    host_ip=p.get("hostIP", ""),
                )
                for p in d.get("ports") or []
            ],
        )


@dataclass(frozen=True)
class Volume:
    """Pod volume source (reference: core/v1 types.go Volume): the sources
    the scheduler inspects, PVC references and the shared-disk sources
    VolumeRestrictions checks for conflicts, with their read-only flags."""

    name: str
    pvc_claim_name: str = ""  # persistentVolumeClaim.claimName
    pvc_read_only: bool = False
    gce_pd: str = ""  # gcePersistentDisk.pdName
    gce_read_only: bool = False
    aws_ebs: str = ""  # awsElasticBlockStore.volumeID
    rbd: str = ""  # rbd.image
    rbd_read_only: bool = False
    iscsi: str = ""  # iscsi "iqn/lun"
    iscsi_read_only: bool = False
    ephemeral: bool = False  # ephemeral.volumeClaimTemplate (claim name = pod-volname)
    config_map: str = ""
    secret: str = ""

    @property
    def scheduling_relevant(self) -> bool:
        """True when a scheduler plugin inspects this source; configMap/
        secret/emptyDir volumes never constrain placement."""
        return bool(self.pvc_claim_name or self.ephemeral or self.gce_pd
                    or self.aws_ebs or self.rbd or self.iscsi)

    @staticmethod
    def from_dict(d: Mapping) -> "Volume":
        pvc = d.get("persistentVolumeClaim") or {}
        gce = d.get("gcePersistentDisk") or {}
        rbd = d.get("rbd") or {}
        iscsi = d.get("iscsi") or {}
        return Volume(
            name=d.get("name", ""),
            pvc_claim_name=pvc.get("claimName", ""),
            pvc_read_only=bool(pvc.get("readOnly", False)),
            gce_pd=gce.get("pdName", ""),
            gce_read_only=bool(gce.get("readOnly", False)),
            aws_ebs=(d.get("awsElasticBlockStore") or {}).get("volumeID", ""),
            rbd=rbd.get("image", ""),
            rbd_read_only=bool(rbd.get("readOnly", False)),
            iscsi=(f"{iscsi.get('iqn', '')}/{iscsi.get('lun', 0)}" if iscsi else ""),
            iscsi_read_only=bool(iscsi.get("readOnly", False)),
            ephemeral="ephemeral" in d,
            config_map=(d.get("configMap") or {}).get("name", ""),
            secret=(d.get("secret") or {}).get("secretName", ""),
        )


@dataclass(frozen=True)
class Toleration:
    """reference: core/v1 types.go Toleration."""

    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: "Taint") -> bool:
        """ToleratesTaint (reference: core/v1/toleration.go:38)."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator in ("", "Equal"):
            return self.value == taint.value
        return self.operator == "Exists"

    @staticmethod
    def from_dict(d: Mapping) -> "Toleration":
        return Toleration(
            key=d.get("key", ""),
            operator=d.get("operator", "Equal"),
            value=d.get("value", ""),
            effect=d.get("effect", ""),
            toleration_seconds=d.get("tolerationSeconds"),
        )


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = TAINT_NO_SCHEDULE

    @staticmethod
    def from_dict(d: Mapping) -> "Taint":
        return Taint(key=d["key"], value=d.get("value", ""),
                     effect=d.get("effect", TAINT_NO_SCHEDULE))


def find_matching_untolerated_taint(taints, tolerations, effects=(TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE)):
    """reference: staging/src/k8s.io/component-helpers/scheduling/corev1/helpers.go
    FindMatchingUntoleratedTaint filtered to DoNotSchedule effects."""
    for taint in taints:
        if taint.effect not in effects:
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return taint
    return None


@dataclass(frozen=True)
class PodAffinityTerm:
    """reference: core/v1 types.go PodAffinityTerm."""

    topology_key: str
    selector: Optional[Selector]  # over pod labels; None matches nothing
    namespaces: Tuple[str, ...] = ()
    namespace_selector: Optional[Selector] = None  # over namespace labels; empty matches all
    match_label_keys: Tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: Mapping) -> "PodAffinityTerm":
        return PodAffinityTerm(
            topology_key=d.get("topologyKey", ""),
            selector=Selector.from_label_selector(d.get("labelSelector")),
            namespaces=tuple(d.get("namespaces") or ()),
            namespace_selector=Selector.from_label_selector(d.get("namespaceSelector")),
            match_label_keys=tuple(d.get("matchLabelKeys") or ()),
        )


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm

    @staticmethod
    def from_dict(d: Mapping) -> "WeightedPodAffinityTerm":
        return WeightedPodAffinityTerm(int(d["weight"]),
                                       PodAffinityTerm.from_dict(d["podAffinityTerm"]))


@dataclass
class Affinity:
    node_affinity_required: Optional[NodeSelector] = None
    node_affinity_preferred: List[PreferredSchedulingTerm] = field(default_factory=list)
    pod_affinity_required: List[PodAffinityTerm] = field(default_factory=list)
    pod_affinity_preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_required: List[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Optional[Mapping]) -> Optional["Affinity"]:
        if not d:
            return None
        req = "requiredDuringSchedulingIgnoredDuringExecution"
        pref = "preferredDuringSchedulingIgnoredDuringExecution"
        na = d.get("nodeAffinity") or {}
        pa = d.get("podAffinity") or {}
        paa = d.get("podAntiAffinity") or {}
        return Affinity(
            node_affinity_required=NodeSelector.from_dict(na.get(req)),
            node_affinity_preferred=[PreferredSchedulingTerm.from_dict(t)
                                     for t in na.get(pref) or []],
            pod_affinity_required=[PodAffinityTerm.from_dict(t)
                                   for t in pa.get(req) or []],
            pod_affinity_preferred=[WeightedPodAffinityTerm.from_dict(t)
                                    for t in pa.get(pref) or []],
            pod_anti_affinity_required=[PodAffinityTerm.from_dict(t)
                                        for t in paa.get(req) or []],
            pod_anti_affinity_preferred=[WeightedPodAffinityTerm.from_dict(t)
                                         for t in paa.get(pref) or []],
        )


@dataclass(frozen=True)
class TopologySpreadConstraint:
    """reference: core/v1 types.go TopologySpreadConstraint."""

    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    selector: Optional[Selector]
    min_domains: Optional[int] = None
    node_affinity_policy: str = "Honor"  # Honor | Ignore
    node_taints_policy: str = "Ignore"  # Honor | Ignore
    match_label_keys: Tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: Mapping) -> "TopologySpreadConstraint":
        return TopologySpreadConstraint(
            max_skew=int(d["maxSkew"]),
            topology_key=d["topologyKey"],
            when_unsatisfiable=d["whenUnsatisfiable"],
            selector=Selector.from_label_selector(d.get("labelSelector")),
            min_domains=d.get("minDomains"),
            node_affinity_policy=d.get("nodeAffinityPolicy", "Honor"),
            node_taints_policy=d.get("nodeTaintsPolicy", "Ignore"),
            match_label_keys=tuple(d.get("matchLabelKeys") or ()),
        )


@dataclass
class PodSpec:
    node_name: str = ""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    priority: int = 0
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    scheduling_gates: List[str] = field(default_factory=list)
    overhead: Optional[Dict[str, Any]] = None
    volumes: List[Volume] = field(default_factory=list)
    # DRA claim references: [(ref name, ResourceClaim name)] and
    # [(ref name, ResourceClaimTemplate name)]
    resource_claims: List[Tuple[str, str]] = field(default_factory=list)
    resource_claim_templates: List[Tuple[str, str]] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Mapping) -> "PodSpec":
        claims = d.get("resourceClaims") or []
        return PodSpec(
            node_name=d.get("nodeName", ""),
            scheduler_name=d.get("schedulerName", DEFAULT_SCHEDULER_NAME),
            containers=[Container.from_dict(c) for c in d.get("containers") or []],
            init_containers=[Container.from_dict(c) for c in d.get("initContainers") or []],
            node_selector=dict(d.get("nodeSelector") or {}),
            affinity=Affinity.from_dict(d.get("affinity")),
            tolerations=[Toleration.from_dict(t) for t in d.get("tolerations") or []],
            topology_spread_constraints=[
                TopologySpreadConstraint.from_dict(t)
                for t in d.get("topologySpreadConstraints") or []
            ],
            priority=int(d.get("priority", 0) or 0),
            preemption_policy=d.get("preemptionPolicy", "PreemptLowerPriority"),
            scheduling_gates=[g["name"] if isinstance(g, Mapping) else g
                              for g in d.get("schedulingGates") or []],
            overhead=d.get("overhead"),
            volumes=[Volume.from_dict(v) for v in d.get("volumes") or []],
            resource_claims=[(rc.get("name", ""), rc.get("resourceClaimName", ""))
                             for rc in claims
                             if not rc.get("resourceClaimTemplateName")],
            resource_claim_templates=[(rc.get("name", ""),
                                       rc.get("resourceClaimTemplateName", ""))
                                      for rc in claims
                                      if rc.get("resourceClaimTemplateName")],
        )


@dataclass
class PodCondition:
    type: str
    status: str
    reason: str = ""
    message: str = ""


@dataclass
class PodStatus:
    phase: str = PENDING
    conditions: List[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""
    # claim ref name -> generated ResourceClaim name (status.resourceClaimStatuses,
    # written by the claim controller for template-backed references)
    resource_claim_statuses: Dict[str, str] = field(default_factory=dict)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind = "Pod"

    @staticmethod
    def from_dict(d: Mapping) -> "Pod":
        st = d.get("status") or {}
        return Pod(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=PodSpec.from_dict(d.get("spec") or {}),
            status=PodStatus(
                phase=st.get("phase", PENDING),
                nominated_node_name=st.get("nominatedNodeName", ""),
                resource_claim_statuses={
                    rs.get("name", ""): rs.get("resourceClaimName", "")
                    for rs in st.get("resourceClaimStatuses") or []}),
        )

    @property
    def key(self) -> str:
        # memoized; clones inherit it via __dict__ copy and namespace/name
        # never change on a live object
        k = self.__dict__.get("_key_cache")
        if k is None:
            k = f"{self.metadata.namespace}/{self.metadata.name}"
            self.__dict__["_key_cache"] = k
        return k

    def is_terminal(self) -> bool:
        return self.status.phase in (SUCCEEDED, FAILED)


@dataclass(frozen=True)
class ContainerImage:
    names: Tuple[str, ...]
    size_bytes: int = 0


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Mapping) -> "NodeSpec":
        return NodeSpec(
            unschedulable=bool(d.get("unschedulable", False)),
            taints=[Taint.from_dict(t) for t in d.get("taints") or []],
        )


@dataclass
class NodeStatus:
    capacity: Dict[str, Any] = field(default_factory=dict)
    allocatable: Dict[str, Any] = field(default_factory=dict)
    images: List[ContainerImage] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Mapping) -> "NodeStatus":
        return NodeStatus(
            capacity=dict(d.get("capacity") or {}),
            allocatable=dict(d.get("allocatable") or d.get("capacity") or {}),
            images=[ContainerImage(tuple(i.get("names") or ()), int(i.get("sizeBytes", 0) or 0))
                    for i in d.get("images") or []],
        )


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    kind = "Node"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped

    @staticmethod
    def from_dict(d: Mapping) -> "Node":
        return Node(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=NodeSpec.from_dict(d.get("spec") or {}),
            status=NodeStatus.from_dict(d.get("status") or {}),
        )


@dataclass
class Namespace:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    kind = "Namespace"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped

    @staticmethod
    def from_dict(d: Mapping) -> "Namespace":
        return Namespace(metadata=ObjectMeta.from_dict(d.get("metadata") or {}))
