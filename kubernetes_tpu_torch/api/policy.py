"""Policy/autoscaling API types: ResourceQuota, LimitRange,
HorizontalPodAutoscaler, PodDisruptionBudget, PriorityClass, ServiceAccount.

reference: staging/src/k8s.io/api/core/v1/types.go (ResourceQuota, LimitRange,
ServiceAccount), staging/src/k8s.io/api/autoscaling/v2/types.go
(HorizontalPodAutoscaler), staging/src/k8s.io/api/policy/v1/types.go
(PodDisruptionBudget), staging/src/k8s.io/api/scheduling/v1/types.go
(PriorityClass).

The counterpart of `kubernetes_tpu/api/policy.py`: the same names, defaults
and wire forms, held equal to it by the port's tests. The PDB's selector and
`disruptions_allowed` are what preemption reads (scheduler/gangpreempt.py
pdb_blocked_mask) and the disruption controller maintains
(controllers/disruption.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

from .labels import Selector
from .types import ObjectMeta


@dataclass
class ResourceQuota:
    """Per-namespace aggregate limits; usage tracked in status
    (core/v1 ResourceQuota). Quantities kept in their string form — comparison
    happens through resources.quantity_milli_value."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    hard: Dict[str, Any] = field(default_factory=dict)  # spec.hard
    used: Dict[str, Any] = field(default_factory=dict)  # status.used

    kind = "ResourceQuota"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "ResourceQuota":
        return ResourceQuota(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            hard=dict((d.get("spec") or {}).get("hard") or {}),
            used=dict((d.get("status") or {}).get("used") or {}),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"apiVersion": "v1", "kind": "ResourceQuota",
                "metadata": self.metadata.to_dict(),
                "spec": {"hard": dict(self.hard)},
                "status": {"hard": dict(self.hard), "used": dict(self.used)}}


@dataclass
class LimitRange:
    """Per-namespace default/min/max for container resources (core/v1
    LimitRange, type=Container only — the admission-relevant subset)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    default_limits: Dict[str, Any] = field(default_factory=dict)  # default
    default_requests: Dict[str, Any] = field(default_factory=dict)  # defaultRequest
    max: Dict[str, Any] = field(default_factory=dict)
    min: Dict[str, Any] = field(default_factory=dict)

    kind = "LimitRange"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "LimitRange":
        lr = LimitRange(metadata=ObjectMeta.from_dict(d.get("metadata") or {}))
        for item in (d.get("spec") or {}).get("limits") or []:
            if item.get("type", "Container") != "Container":
                continue
            lr.default_limits.update(item.get("default") or {})
            lr.default_requests.update(item.get("defaultRequest") or {})
            lr.max.update(item.get("max") or {})
            lr.min.update(item.get("min") or {})
        return lr

    def to_dict(self) -> Dict[str, Any]:
        item: Dict[str, Any] = {"type": "Container"}
        if self.default_limits:
            item["default"] = dict(self.default_limits)
        if self.default_requests:
            item["defaultRequest"] = dict(self.default_requests)
        if self.max:
            item["max"] = dict(self.max)
        if self.min:
            item["min"] = dict(self.min)
        return {"apiVersion": "v1", "kind": "LimitRange",
                "metadata": self.metadata.to_dict(),
                "spec": {"limits": [item]}}


@dataclass
class HorizontalPodAutoscaler:
    """autoscaling/v2 subset: CPU-utilization target on a scale target."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    target_kind: str = "Deployment"  # scaleTargetRef.kind
    target_name: str = ""
    min_replicas: int = 1
    max_replicas: int = 10
    target_cpu_utilization: int = 80  # percent of requests
    current_replicas: int = 0
    desired_replicas: int = 0
    last_scale_time: Optional[float] = None

    kind = "HorizontalPodAutoscaler"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "HorizontalPodAutoscaler":
        sp = d.get("spec") or {}
        ref = sp.get("scaleTargetRef") or {}
        target = 80
        for m in sp.get("metrics") or []:
            res = m.get("resource") or {}
            if res.get("name") == "cpu":
                target = int((res.get("target") or {}).get("averageUtilization", 80))
        if "targetCPUUtilizationPercentage" in sp:  # autoscaling/v1 shape
            target = int(sp["targetCPUUtilizationPercentage"])
        st = d.get("status") or {}
        return HorizontalPodAutoscaler(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            target_kind=ref.get("kind", "Deployment"),
            target_name=ref.get("name", ""),
            min_replicas=int(sp.get("minReplicas", 1) or 1),
            max_replicas=int(sp.get("maxReplicas", 10) or 10),
            target_cpu_utilization=target,
            current_replicas=int(st.get("currentReplicas", 0) or 0),
            desired_replicas=int(st.get("desiredReplicas", 0) or 0),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "autoscaling/v2", "kind": "HorizontalPodAutoscaler",
            "metadata": self.metadata.to_dict(),
            "spec": {
                "scaleTargetRef": {"apiVersion": "apps/v1", "kind": self.target_kind,
                                   "name": self.target_name},
                "minReplicas": self.min_replicas,
                "maxReplicas": self.max_replicas,
                "metrics": [{"type": "Resource", "resource": {
                    "name": "cpu",
                    "target": {"type": "Utilization",
                               "averageUtilization": self.target_cpu_utilization}}}],
            },
            "status": {"currentReplicas": self.current_replicas,
                       "desiredReplicas": self.desired_replicas},
        }


@dataclass
class PodDisruptionBudget:
    """policy/v1 PDB: bounds voluntary evictions (consumed by preemption)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[Selector] = None
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None
    disruptions_allowed: int = 0

    kind = "PodDisruptionBudget"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "PodDisruptionBudget":
        sp = d.get("spec") or {}
        return PodDisruptionBudget(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=Selector.from_label_selector(sp.get("selector")),
            min_available=sp.get("minAvailable"),
            max_unavailable=sp.get("maxUnavailable"),
            disruptions_allowed=int((d.get("status") or {}).get("disruptionsAllowed", 0) or 0),
        )

    def to_dict(self) -> Dict[str, Any]:
        sp: Dict[str, Any] = {}
        if self.min_available is not None:
            sp["minAvailable"] = self.min_available
        if self.max_unavailable is not None:
            sp["maxUnavailable"] = self.max_unavailable
        return {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                "metadata": self.metadata.to_dict(), "spec": sp,
                "status": {"disruptionsAllowed": self.disruptions_allowed}}


@dataclass
class PriorityClass:
    """scheduling.k8s.io/v1 PriorityClass (reference:
    staging/src/k8s.io/api/scheduling/v1/types.go): named priority values the
    Priority admission plugin resolves into pod.spec.priority."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    description: str = ""

    kind = "PriorityClass"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped

    @staticmethod
    def from_dict(d: Mapping) -> "PriorityClass":
        return PriorityClass(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            value=int(d.get("value", 0) or 0),
            global_default=bool(d.get("globalDefault", False)),
            preemption_policy=d.get("preemptionPolicy", "PreemptLowerPriority"),
            description=d.get("description", ""),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "apiVersion": "scheduling.k8s.io/v1",
            "metadata": self.metadata.to_dict(), "value": self.value,
            **({"globalDefault": True} if self.global_default else {}),
            **({"preemptionPolicy": self.preemption_policy}
               if self.preemption_policy != "PreemptLowerPriority" else {}),
            **({"description": self.description} if self.description else {}),
        }


@dataclass
class ServiceAccount:
    """core/v1 ServiceAccount (identity for in-cluster workloads; the
    serviceaccount admission plugin + controller pair keep a 'default' SA in
    every namespace — reference: plugin/pkg/admission/serviceaccount,
    pkg/controller/serviceaccount)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    secrets: list = field(default_factory=list)
    automount_token: bool = True

    kind = "ServiceAccount"

    @staticmethod
    def from_dict(d: Mapping) -> "ServiceAccount":
        return ServiceAccount(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            secrets=list(d.get("secrets") or []),
            automount_token=bool(d.get("automountServiceAccountToken", True)),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "apiVersion": "v1",
            "metadata": self.metadata.to_dict(),
            **({"secrets": list(self.secrets)} if self.secrets else {}),
            **({} if self.automount_token
               else {"automountServiceAccountToken": False}),
        }

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"
