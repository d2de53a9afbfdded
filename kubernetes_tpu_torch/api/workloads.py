"""Workload + coordination API types: PodTemplateSpec, ReplicaSet, Deployment,
Lease, Job, CronJob, StatefulSet and DaemonSet.

The counterpart of `kubernetes_tpu/api/workloads.py`: the same fields,
defaults and `from_dict` parsing (their wire forms are in api/serialize.py).

reference: staging/src/k8s.io/api/apps/v1/types.go (ReplicaSet, Deployment,
StatefulSet, DaemonSet), staging/src/k8s.io/api/batch/v1/types.go (Job,
CronJob), staging/src/k8s.io/api/coordination/v1/types.go (Lease).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from .labels import Selector
from .types import ObjectMeta, Pod, PodSpec


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)

    @staticmethod
    def from_dict(d: Mapping) -> "PodTemplateSpec":
        return PodTemplateSpec(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=PodSpec.from_dict(d.get("spec") or {}),
        )

    def make_pod(self, name: str, namespace: str, owner: Optional[Dict[str, Any]] = None) -> Pod:
        pod = Pod(
            metadata=ObjectMeta(
                name=name,
                namespace=namespace,
                labels=dict(self.metadata.labels),
                annotations=dict(self.metadata.annotations),
            ),
            spec=copy.deepcopy(self.spec),
        )
        from .types import new_uid

        pod.metadata.uid = new_uid()
        if owner:
            pod.metadata.owner_references = [owner]
        return pod


@dataclass
class ReplicaSetSpec:
    replicas: int = 1
    selector: Optional[Selector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class ReplicaSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicaSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicaSetSpec = field(default_factory=ReplicaSetSpec)
    status: ReplicaSetStatus = field(default_factory=ReplicaSetStatus)

    kind = "ReplicaSet"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "ReplicaSet":
        sp = d.get("spec") or {}
        return ReplicaSet(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=ReplicaSetSpec(
                replicas=int(sp.get("replicas", 1)),
                selector=Selector.from_label_selector(sp.get("selector")),
                template=PodTemplateSpec.from_dict(sp.get("template") or {}),
            ),
        )


@dataclass
class DeploymentSpec:
    replicas: int = 1
    selector: Optional[Selector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    strategy: str = "RollingUpdate"  # or "Recreate"
    max_surge: int = 1
    max_unavailable: int = 0


@dataclass
class DeploymentStatus:
    replicas: int = 0
    updated_replicas: int = 0
    ready_replicas: int = 0
    observed_generation: int = 0


@dataclass
class Deployment:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)
    status: DeploymentStatus = field(default_factory=DeploymentStatus)

    kind = "Deployment"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "Deployment":
        sp = d.get("spec") or {}
        strat = sp.get("strategy") or {}
        ru = strat.get("rollingUpdate") or {}
        return Deployment(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=DeploymentSpec(
                replicas=int(sp.get("replicas", 1)),
                selector=Selector.from_label_selector(sp.get("selector")),
                template=PodTemplateSpec.from_dict(sp.get("template") or {}),
                strategy=strat.get("type", "RollingUpdate"),
                max_surge=int(ru.get("maxSurge", 1) or 0),
                max_unavailable=int(ru.get("maxUnavailable", 0) or 0),
            ),
        )


@dataclass
class Lease:
    """coordination/v1 Lease — node heartbeats and leader election locks."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_seconds: int = 40
    acquire_time: float = 0.0
    renew_time: float = 0.0

    kind = "Lease"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "Lease":
        sp = d.get("spec") or {}
        return Lease(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            holder_identity=sp.get("holderIdentity", ""),
            lease_duration_seconds=int(sp.get("leaseDurationSeconds", 40) or 40),
            acquire_time=_parse_time(sp.get("acquireTime")),
            renew_time=_parse_time(sp.get("renewTime")),
        )


def _parse_time(v) -> float:
    """Seconds-float internally; accepts the RFC3339 MicroTime strings real
    coordination/v1 manifests carry."""
    if v in (None, ""):
        return 0.0
    if isinstance(v, (int, float)):
        return float(v)
    from datetime import datetime

    return datetime.fromisoformat(str(v).replace("Z", "+00:00")).timestamp()


# ---------------------------------------------------------------------------
# batch/v1 Job + CronJob (staging/src/k8s.io/api/batch/v1/types.go)
# ---------------------------------------------------------------------------


@dataclass
class JobSpec:
    parallelism: int = 1
    completions: Optional[int] = None  # None: any single success completes (non-indexed)
    backoff_limit: int = 6
    active_deadline_seconds: Optional[int] = None
    completion_mode: str = "NonIndexed"  # or "Indexed"
    selector: Optional[Selector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    ttl_seconds_after_finished: Optional[int] = None
    suspend: bool = False


@dataclass
class JobStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    conditions: List[Dict[str, Any]] = field(default_factory=list)  # Complete/Failed
    # Indexed completion mode: compressed ranges of succeeded indexes,
    # e.g. "0-2,5" (batch/v1 Job.status.completedIndexes)
    completed_indexes: str = ""


@dataclass
class Job:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)

    kind = "Job"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def is_finished(self) -> bool:
        """JobFinished: a Complete or Failed condition with status True."""
        return any(c.get("type") in ("Complete", "Failed") and c.get("status") == "True"
                   for c in self.status.conditions)

    @staticmethod
    def from_dict(d: Mapping) -> "Job":
        sp = d.get("spec") or {}
        st = d.get("status") or {}
        return Job(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=JobSpec(
                parallelism=(int(sp["parallelism"])
                             if sp.get("parallelism") is not None else 1),
                completions=sp.get("completions"),
                backoff_limit=int(sp.get("backoffLimit", 6) if sp.get("backoffLimit") is not None else 6),
                active_deadline_seconds=sp.get("activeDeadlineSeconds"),
                completion_mode=sp.get("completionMode", "NonIndexed"),
                selector=Selector.from_label_selector(sp.get("selector")),
                template=PodTemplateSpec.from_dict(sp.get("template") or {}),
                ttl_seconds_after_finished=sp.get("ttlSecondsAfterFinished"),
                suspend=bool(sp.get("suspend", False)),
            ),
            status=JobStatus(
                active=int(st.get("active", 0) or 0),
                succeeded=int(st.get("succeeded", 0) or 0),
                failed=int(st.get("failed", 0) or 0),
                conditions=list(st.get("conditions") or []),
                completed_indexes=st.get("completedIndexes", ""),
            ),
        )


@dataclass
class CronJobSpec:
    schedule: str = "* * * * *"
    time_zone: str = ""  # IANA name; empty = the controller's local/UTC
    suspend: bool = False
    concurrency_policy: str = "Allow"  # Allow | Forbid | Replace
    starting_deadline_seconds: Optional[int] = None
    successful_jobs_history_limit: int = 3
    failed_jobs_history_limit: int = 1
    job_template: JobSpec = field(default_factory=JobSpec)


@dataclass
class CronJobStatus:
    last_schedule_time: Optional[float] = None
    last_successful_time: Optional[float] = None
    active: List[str] = field(default_factory=list)  # job keys


@dataclass
class CronJob:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CronJobSpec = field(default_factory=CronJobSpec)
    status: CronJobStatus = field(default_factory=CronJobStatus)

    kind = "CronJob"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "CronJob":
        sp = d.get("spec") or {}
        jt = (sp.get("jobTemplate") or {}).get("spec") or {}
        return CronJob(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=CronJobSpec(
                schedule=sp.get("schedule", "* * * * *"),
                time_zone=sp.get("timeZone") or "",
                suspend=bool(sp.get("suspend", False)),
                concurrency_policy=sp.get("concurrencyPolicy", "Allow"),
                starting_deadline_seconds=sp.get("startingDeadlineSeconds"),
                successful_jobs_history_limit=int(sp.get("successfulJobsHistoryLimit", 3)
                                                  if sp.get("successfulJobsHistoryLimit") is not None else 3),
                failed_jobs_history_limit=int(sp.get("failedJobsHistoryLimit", 1)
                                              if sp.get("failedJobsHistoryLimit") is not None else 1),
                job_template=Job.from_dict({"spec": jt}).spec,
            ),
        )


# ---------------------------------------------------------------------------
# apps/v1 StatefulSet + DaemonSet (staging/src/k8s.io/api/apps/v1/types.go)
# ---------------------------------------------------------------------------


@dataclass
class StatefulSetSpec:
    replicas: int = 1
    selector: Optional[Selector] = None
    service_name: str = ""
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    pod_management_policy: str = "OrderedReady"  # or "Parallel"
    volume_claim_templates: List[Dict[str, Any]] = field(default_factory=list)
    update_strategy: str = "RollingUpdate"  # or "OnDelete"
    # RollingUpdate only touches ordinals >= partition (canary staging;
    # apps/v1 RollingUpdateStatefulSetStrategy.partition)
    partition: int = 0


@dataclass
class StatefulSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    current_replicas: int = 0
    updated_replicas: int = 0
    observed_generation: int = 0
    update_revision: str = ""


@dataclass
class StatefulSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: StatefulSetSpec = field(default_factory=StatefulSetSpec)
    status: StatefulSetStatus = field(default_factory=StatefulSetStatus)

    kind = "StatefulSet"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "StatefulSet":
        sp = d.get("spec") or {}
        return StatefulSet(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=StatefulSetSpec(
                replicas=int(sp.get("replicas", 1) if sp.get("replicas") is not None else 1),
                selector=Selector.from_label_selector(sp.get("selector")),
                service_name=sp.get("serviceName", ""),
                template=PodTemplateSpec.from_dict(sp.get("template") or {}),
                pod_management_policy=sp.get("podManagementPolicy", "OrderedReady"),
                volume_claim_templates=list(sp.get("volumeClaimTemplates") or []),
                update_strategy=(sp.get("updateStrategy") or {}).get(
                    "type", "RollingUpdate"),
                partition=int(((sp.get("updateStrategy") or {})
                               .get("rollingUpdate") or {}).get("partition", 0) or 0),
            ),
        )


@dataclass
class DaemonSetSpec:
    selector: Optional[Selector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    update_strategy: str = "RollingUpdate"  # or "OnDelete"
    max_unavailable: int = 1  # rollingUpdate.maxUnavailable (absolute count)


@dataclass
class DaemonSetStatus:
    desired_number_scheduled: int = 0
    current_number_scheduled: int = 0
    number_ready: int = 0
    number_misscheduled: int = 0
    updated_number_scheduled: int = 0
    observed_generation: int = 0


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)
    status: DaemonSetStatus = field(default_factory=DaemonSetStatus)

    kind = "DaemonSet"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "DaemonSet":
        sp = d.get("spec") or {}
        return DaemonSet(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=DaemonSetSpec(
                selector=Selector.from_label_selector(sp.get("selector")),
                template=PodTemplateSpec.from_dict(sp.get("template") or {}),
                update_strategy=(sp.get("updateStrategy") or {}).get(
                    "type", "RollingUpdate"),
                max_unavailable=int(((sp.get("updateStrategy") or {})
                                     .get("rollingUpdate") or {})
                                    .get("maxUnavailable", 1) or 1),
            ),
        )
