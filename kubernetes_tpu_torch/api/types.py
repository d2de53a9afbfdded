"""Typed object model: ObjectMeta, Pod, Node, Namespace, Binding.

The counterpart of `kubernetes_tpu/api/types.py`: the k8s core/v1 API surface
relevant to scheduling and control loops (reference:
staging/src/k8s.io/api/core/v1/types.go — Pod, PodSpec, Node, Taint,
Toleration, Affinity, TopologySpreadConstraint) and ObjectMeta (reference:
staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go), with the same
field names, defaults and matching rules, so the port tensorizes the same
objects into the same arrays and the workload controllers read the same
owner references and finalizers.

Objects parse from / serialize to k8s-style camelCase dicts so standard
manifests round-trip (`from_dict`, `to_dict`; the whole-object forms are in
api/serialize.py).
"""

from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .labels import NodeSelector, PreferredSchedulingTerm, Selector

# Well-known label keys (reference: staging/src/k8s.io/api/core/v1/well_known_labels.go)
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
# one urandom draw per process, not per uid: uuid4 costs an entropy
# syscall and uid generation sits on event/create hot paths; the
# counter already guarantees in-process uniqueness, the session suffix keeps
# uids from different processes distinct
_uid_session = uuid.uuid4().hex[:8]


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}-{_uid_session}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    resource_version: int = 0
    generation: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    owner_references: List[Dict[str, Any]] = field(default_factory=list)
    finalizers: List[str] = field(default_factory=list)
    # server-side-apply field ownership (raw wire entries: manager,
    # operation, fieldsType, fieldsV1) — maintained by server/fieldmanager.py
    managed_fields: List[Dict[str, Any]] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Mapping) -> "ObjectMeta":
        return ObjectMeta(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            uid=d.get("uid", ""),
            resource_version=int(d.get("resourceVersion", 0) or 0),
            generation=int(d.get("generation", 0) or 0),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            creation_timestamp=float(d.get("creationTimestamp", 0.0) or 0.0),
            deletion_timestamp=d.get("deletionTimestamp"),
            owner_references=list(d.get("ownerReferences") or []),
            finalizers=list(d.get("finalizers") or []),
            managed_fields=list(d.get("managedFields") or []),
        )

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "namespace": self.namespace,
            "uid": self.uid,
            "resourceVersion": self.resource_version,
        }
        if self.generation:
            d["generation"] = self.generation
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        if self.creation_timestamp:
            d["creationTimestamp"] = self.creation_timestamp
        if self.deletion_timestamp is not None:
            d["deletionTimestamp"] = self.deletion_timestamp
        if self.owner_references:
            d["ownerReferences"] = self.owner_references
        if self.finalizers:
            d["finalizers"] = self.finalizers
        if self.managed_fields:
            d["managedFields"] = self.managed_fields
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
    image_pull_policy: str = ""  # "", Always, IfNotPresent, Never
    # raw core/v1 SecurityContext dict (privileged, runAsNonRoot,
    # allowPrivilegeEscalation, capabilities, seccompProfile, ...) — consumed
    # by the PodSecurity admission level checks
    security_context: Dict[str, Any] = field(default_factory=dict)
    # raw core/v1 EnvVar list ({name, value} | {name, valueFrom:
    # {configMapKeyRef|secretKeyRef}}) + EnvFromSource list — the kubelet
    # resolves references at container start (CreateContainerConfigError
    # when the source is missing)
    env: List[Dict[str, Any]] = field(default_factory=list)
    env_from: List[Dict[str, Any]] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Mapping) -> "Container":
        return Container(
            name=d.get("name", ""),
            image=d.get("image", ""),
            resources=dict(d.get("resources") or {}),
            image_pull_policy=d.get("imagePullPolicy", ""),
            security_context=dict(d.get("securityContext") or {}),
            env=[dict(e) for e in d.get("env") or []],
            env_from=[dict(e) for e in d.get("envFrom") or []],
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

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name}
        if self.image:
            d["image"] = self.image
        if self.resources:
            d["resources"] = self.resources
        if self.image_pull_policy:
            d["imagePullPolicy"] = self.image_pull_policy
        if self.security_context:
            d["securityContext"] = self.security_context
        if self.env:
            d["env"] = self.env
        if self.env_from:
            d["envFrom"] = self.env_from
        if self.ports:
            d["ports"] = [
                {
                    "containerPort": p.container_port,
                    **({"hostPort": p.host_port} if p.host_port else {}),
                    "protocol": p.protocol,
                    **({"hostIP": p.host_ip} if p.host_ip else {}),
                }
                for p in self.ports
            ]
        return d


@dataclass(frozen=True)
class Volume:
    """Pod volume source (reference: staging/src/k8s.io/api/core/v1/types.go Volume;
    only the sources the scheduler inspects: PVC references and the shared-disk
    sources VolumeRestrictions checks for conflicts)."""

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
    host_path: str = ""  # hostPath.path — PodSecurity baseline forbids these
    config_map: str = ""  # configMap.name — kubelet resolves at start
    config_map_optional: bool = False
    secret: str = ""  # secret.secretName
    secret_optional: bool = False

    @property
    def scheduling_relevant(self) -> bool:
        """True when any scheduler plugin inspects this source (PVC/ephemeral
        for VolumeBinding/Zone/Limits, shared-disk sources for
        VolumeRestrictions). configMap/secret/emptyDir/projected volumes parse
        to name-only entries and never constrain placement."""
        return bool(self.pvc_claim_name or self.ephemeral or self.gce_pd
                    or self.aws_ebs or self.rbd or self.iscsi)

    @staticmethod
    def from_dict(d: Mapping) -> "Volume":
        pvc = d.get("persistentVolumeClaim") or {}
        gce = d.get("gcePersistentDisk") or {}
        ebs = d.get("awsElasticBlockStore") or {}
        rbd = d.get("rbd") or {}
        iscsi = d.get("iscsi") or {}
        return Volume(
            name=d.get("name", ""),
            pvc_claim_name=pvc.get("claimName", ""),
            pvc_read_only=bool(pvc.get("readOnly", False)),
            gce_pd=gce.get("pdName", ""),
            gce_read_only=bool(gce.get("readOnly", False)),
            aws_ebs=ebs.get("volumeID", ""),
            rbd=rbd.get("image", ""),
            rbd_read_only=bool(rbd.get("readOnly", False)),
            iscsi=(f"{iscsi.get('iqn', '')}/{iscsi.get('lun', 0)}" if iscsi else ""),
            iscsi_read_only=bool(iscsi.get("readOnly", False)),
            ephemeral="ephemeral" in d,
            host_path=(d.get("hostPath") or {}).get("path", ""),
            config_map=(d.get("configMap") or {}).get("name", ""),
            config_map_optional=bool((d.get("configMap") or {}).get("optional", False)),
            secret=(d.get("secret") or {}).get("secretName", ""),
            secret_optional=bool((d.get("secret") or {}).get("optional", False)),
        )

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name}
        if self.pvc_claim_name:
            d["persistentVolumeClaim"] = {"claimName": self.pvc_claim_name,
                                          **({"readOnly": True} if self.pvc_read_only else {})}
        if self.gce_pd:
            d["gcePersistentDisk"] = {"pdName": self.gce_pd,
                                      **({"readOnly": True} if self.gce_read_only else {})}
        if self.aws_ebs:
            d["awsElasticBlockStore"] = {"volumeID": self.aws_ebs}
        if self.rbd:
            d["rbd"] = {"image": self.rbd, **({"readOnly": True} if self.rbd_read_only else {})}
        if self.iscsi:
            iqn, _, lun = self.iscsi.rpartition("/")
            d["iscsi"] = {"iqn": iqn, "lun": int(lun or 0),
                          **({"readOnly": True} if self.iscsi_read_only else {})}
        if self.ephemeral:
            d["ephemeral"] = {"volumeClaimTemplate": {}}
        if self.host_path:
            d["hostPath"] = {"path": self.host_path}
        if self.config_map:
            d["configMap"] = {"name": self.config_map,
                              **({"optional": True} if self.config_map_optional
                                 else {})}
        if self.secret:
            d["secret"] = {"secretName": self.secret,
                           **({"optional": True} if self.secret_optional
                              else {})}
        return d


@dataclass(frozen=True)
class Toleration:
    """reference: staging/src/k8s.io/api/core/v1/types.go Toleration."""

    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: "Taint") -> bool:
        """ToleratesTaint semantics (reference:
        staging/src/k8s.io/api/core/v1/toleration.go:38)."""
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
        return Taint(key=d["key"], value=d.get("value", ""), effect=d.get("effect", TAINT_NO_SCHEDULE))


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
    """reference: staging/src/k8s.io/api/core/v1/types.go PodAffinityTerm."""

    topology_key: str
    selector: Optional[Selector]  # label_selector over pods; None matches nothing
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
        return WeightedPodAffinityTerm(int(d["weight"]), PodAffinityTerm.from_dict(d["podAffinityTerm"]))


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
        a = Affinity()
        na = d.get("nodeAffinity") or {}
        a.node_affinity_required = NodeSelector.from_dict(
            na.get("requiredDuringSchedulingIgnoredDuringExecution")
        )
        a.node_affinity_preferred = [
            PreferredSchedulingTerm.from_dict(t)
            for t in na.get("preferredDuringSchedulingIgnoredDuringExecution") or []
        ]
        pa = d.get("podAffinity") or {}
        a.pod_affinity_required = [
            PodAffinityTerm.from_dict(t)
            for t in pa.get("requiredDuringSchedulingIgnoredDuringExecution") or []
        ]
        a.pod_affinity_preferred = [
            WeightedPodAffinityTerm.from_dict(t)
            for t in pa.get("preferredDuringSchedulingIgnoredDuringExecution") or []
        ]
        paa = d.get("podAntiAffinity") or {}
        a.pod_anti_affinity_required = [
            PodAffinityTerm.from_dict(t)
            for t in paa.get("requiredDuringSchedulingIgnoredDuringExecution") or []
        ]
        a.pod_anti_affinity_preferred = [
            WeightedPodAffinityTerm.from_dict(t)
            for t in paa.get("preferredDuringSchedulingIgnoredDuringExecution") or []
        ]
        return a


@dataclass(frozen=True)
class TopologySpreadConstraint:
    """reference: staging/src/k8s.io/api/core/v1/types.go TopologySpreadConstraint."""

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
    priority_class_name: str = ""
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    scheduling_gates: List[str] = field(default_factory=list)
    overhead: Optional[Dict[str, Any]] = None
    host_network: bool = False
    host_pid: bool = False
    host_ipc: bool = False
    # raw core/v1 PodSecurityContext dict (runAsNonRoot, seccompProfile, ...)
    security_context: Dict[str, Any] = field(default_factory=dict)
    restart_policy: str = "Always"
    termination_grace_period_seconds: int = 30
    volumes: List[Volume] = field(default_factory=list)
    # DRA (core/v1 PodSpec.ResourceClaims): [(claim ref name, ResourceClaim
    # object name)] — reference: PodResourceClaim, core/v1/types.go
    resource_claims: List[Tuple[str, str]] = field(default_factory=list)
    # [(claim ref name, ResourceClaimTemplate name)] — the resourceclaim
    # controller stamps a generated claim per pod and records it in
    # status.resource_claim_statuses
    resource_claim_templates: List[Tuple[str, str]] = field(default_factory=list)
    service_account_name: str = ""

    @staticmethod
    def from_dict(d: Mapping) -> "PodSpec":
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
            priority_class_name=d.get("priorityClassName", ""),
            preemption_policy=d.get("preemptionPolicy", "PreemptLowerPriority"),
            scheduling_gates=[g["name"] if isinstance(g, Mapping) else g for g in d.get("schedulingGates") or []],
            overhead=d.get("overhead"),
            host_network=bool(d.get("hostNetwork", False)),
            host_pid=bool(d.get("hostPID", False)),
            host_ipc=bool(d.get("hostIPC", False)),
            security_context=dict(d.get("securityContext") or {}),
            restart_policy=d.get("restartPolicy", "Always"),
            termination_grace_period_seconds=int(d.get("terminationGracePeriodSeconds", 30) or 30),
            volumes=[Volume.from_dict(v) for v in d.get("volumes") or []],
            resource_claims=[
                (rc.get("name", ""), rc.get("resourceClaimName", ""))
                for rc in d.get("resourceClaims") or []
                if not rc.get("resourceClaimTemplateName")
            ],
            resource_claim_templates=[
                (rc.get("name", ""), rc.get("resourceClaimTemplateName", ""))
                for rc in d.get("resourceClaims") or []
                if rc.get("resourceClaimTemplateName")
            ],
            service_account_name=d.get("serviceAccountName", ""),
        )


@dataclass
class PodCondition:
    type: str
    status: str
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class PodStatus:
    phase: str = PENDING
    conditions: List[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""
    # claim ref name -> generated ResourceClaim name (status.resourceClaimStatuses,
    # written by the resourceclaim controller for template-backed refs)
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
                resource_claim_statuses={
                    rs.get("name", ""): rs.get("resourceClaimName", "")
                    for rs in st.get("resourceClaimStatuses") or []},
                phase=st.get("phase", PENDING),
                conditions=[
                    PodCondition(
                        type=c.get("type", ""),
                        status=c.get("status", ""),
                        reason=c.get("reason", ""),
                        message=c.get("message", ""),
                        last_transition_time=float(c.get("lastTransitionTime", 0.0) or 0.0),
                    )
                    for c in st.get("conditions") or []
                ],
                nominated_node_name=st.get("nominatedNodeName", ""),
            ),
        )

    @property
    def key(self) -> str:
        # memoized: read several times per pod per scheduling cycle (clone,
        # assume, confirm, bind paths at 100k-pod rates); structural clones
        # inherit it via __dict__ copy, and namespace/name never change on a
        # live object (every rename parses a NEW Pod)
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
class NodeCondition:
    type: str
    status: str
    reason: str = ""
    last_heartbeat_time: float = 0.0
    last_transition_time: float = 0.0


@dataclass
class NodeStatus:
    capacity: Dict[str, Any] = field(default_factory=dict)
    allocatable: Dict[str, Any] = field(default_factory=dict)
    images: List[ContainerImage] = field(default_factory=list)
    conditions: List[NodeCondition] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Mapping) -> "NodeStatus":
        return NodeStatus(
            capacity=dict(d.get("capacity") or {}),
            allocatable=dict(d.get("allocatable") or d.get("capacity") or {}),
            images=[
                ContainerImage(tuple(i.get("names") or ()), int(i.get("sizeBytes", 0) or 0))
                for i in d.get("images") or []
            ],
            conditions=[
                NodeCondition(
                    type=c.get("type", ""),
                    status=c.get("status", ""),
                    reason=c.get("reason", ""),
                    last_heartbeat_time=float(c.get("lastHeartbeatTime", 0.0) or 0.0),
                    last_transition_time=float(c.get("lastTransitionTime", 0.0) or 0.0),
                )
                for c in d.get("conditions") or []
            ],
        )


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    kind = "Node"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped: one store key scheme

    @staticmethod
    def from_dict(d: Mapping) -> "Node":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""  # Nodes are cluster-scoped
        return Node(
            metadata=meta,
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
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""  # Namespaces are cluster-scoped
        return Namespace(metadata=meta)


@dataclass
class Binding:
    """Pod->Node binding subresource (reference:
    staging/src/k8s.io/api/core/v1/types.go Binding; handled by BindingREST.Create,
    pkg/registry/core/pod/storage/storage.go:149)."""

    pod_namespace: str
    pod_name: str
    node_name: str
