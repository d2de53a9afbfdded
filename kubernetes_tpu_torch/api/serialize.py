"""Object <-> k8s-style camelCase dict serialization for every API type.

The counterpart of `kubernetes_tpu/api/serialize.py`, with the same four
tables (RESOURCE_TO_TYPE, KIND_TO_RESOURCE, CLUSTER_SCOPED, GROUP_PREFIX).
The wire format matches kubernetes manifests (reference: the JSON forms of
staging/src/k8s.io/api types) byte for byte with the JAX package's
(`json.dumps(..., sort_keys=True)`), so standard YAML round-trips and
template fingerprints (controllers/revision.py) agree.
"""

from __future__ import annotations

from typing import Any, Dict

from .labels import NodeSelector, Selector
from .types import Affinity, Namespace, Node, Pod, PodAffinityTerm
from .networking import (
    EndpointSlice,
    Ingress,
    IngressClass,
    NetworkPolicy,
    Service,
)
from .policy import (
    HorizontalPodAutoscaler,
    LimitRange,
    PodDisruptionBudget,
    PriorityClass,
    ResourceQuota,
    ServiceAccount,
)
from .admissionregistration import (
    MutatingWebhookConfiguration,
    ValidatingAdmissionPolicy,
    ValidatingAdmissionPolicyBinding,
    ValidatingWebhookConfiguration,
)
from .apiservice import APIService
from .certificates import CertificateSigningRequest
from .config import ConfigMap, Secret
from .crd import CustomResourceDefinition
from .flowcontrolapi import (
    FlowSchemaConfiguration,
    PriorityLevelConfiguration,
)
from .dra import DeviceClass, ResourceClaim, ResourceClaimTemplate, ResourceSlice
from .events import Event as CoreEvent, PodLog
from .execapi import PodExec, PodPortForward
from .storage import (
    CSINode,
    PersistentVolume,
    PersistentVolumeClaim,
    StorageClass,
    VolumeAttachment,
)
from .podgroup import PodGroup
from .workloads import (
    CronJob,
    DaemonSet,
    Deployment,
    Job,
    Lease,
    ReplicaSet,
    StatefulSet,
)

KIND_TO_RESOURCE = {
    "Pod": "pods",
    "Node": "nodes",
    "Namespace": "namespaces",
    "ReplicaSet": "replicasets",
    "Deployment": "deployments",
    "StatefulSet": "statefulsets",
    "DaemonSet": "daemonsets",
    "Job": "jobs",
    "CronJob": "cronjobs",
    "Lease": "leases",
    "PersistentVolume": "persistentvolumes",
    "PersistentVolumeClaim": "persistentvolumeclaims",
    "StorageClass": "storageclasses",
    "CSINode": "csinodes",
    "Service": "services",
    "EndpointSlice": "endpointslices",
    "ResourceQuota": "resourcequotas",
    "LimitRange": "limitranges",
    "HorizontalPodAutoscaler": "horizontalpodautoscalers",
    "PodDisruptionBudget": "poddisruptionbudgets",
    "PriorityClass": "priorityclasses",
    "ServiceAccount": "serviceaccounts",
    "Event": "events",
    "ResourceClaim": "resourceclaims",
    "ResourceSlice": "resourceslices",
    "DeviceClass": "deviceclasses",
    "CustomResourceDefinition": "customresourcedefinitions",
    "CertificateSigningRequest": "certificatesigningrequests",
    "APIService": "apiservices",
    "VolumeAttachment": "volumeattachments",
    "ResourceClaimTemplate": "resourceclaimtemplates",
    "PodLog": "podlogs",
    "PodExec": "podexecs",
    "PodPortForward": "podportforwards",
    "ConfigMap": "configmaps",
    "Secret": "secrets",
    "Ingress": "ingresses",
    "IngressClass": "ingressclasses",
    "NetworkPolicy": "networkpolicies",
    "PriorityLevelConfiguration": "prioritylevelconfigurations",
    "FlowSchema": "flowschemas",
    "ValidatingAdmissionPolicy": "validatingadmissionpolicies",
    "ValidatingAdmissionPolicyBinding": "validatingadmissionpolicybindings",
    "MutatingWebhookConfiguration": "mutatingwebhookconfigurations",
    "ValidatingWebhookConfiguration": "validatingwebhookconfigurations",
    "PodGroup": "podgroups",
}
RESOURCE_TO_TYPE = {
    "pods": Pod,
    "nodes": Node,
    "namespaces": Namespace,
    "replicasets": ReplicaSet,
    "deployments": Deployment,
    "statefulsets": StatefulSet,
    "daemonsets": DaemonSet,
    "jobs": Job,
    "cronjobs": CronJob,
    "leases": Lease,
    "persistentvolumes": PersistentVolume,
    "persistentvolumeclaims": PersistentVolumeClaim,
    "storageclasses": StorageClass,
    "csinodes": CSINode,
    "services": Service,
    "endpointslices": EndpointSlice,
    "resourcequotas": ResourceQuota,
    "limitranges": LimitRange,
    "horizontalpodautoscalers": HorizontalPodAutoscaler,
    "poddisruptionbudgets": PodDisruptionBudget,
    "priorityclasses": PriorityClass,
    "serviceaccounts": ServiceAccount,
    "events": CoreEvent,
    "resourceclaims": ResourceClaim,
    "resourceslices": ResourceSlice,
    "deviceclasses": DeviceClass,
    "customresourcedefinitions": CustomResourceDefinition,
    "certificatesigningrequests": CertificateSigningRequest,
    "apiservices": APIService,
    "volumeattachments": VolumeAttachment,
    "resourceclaimtemplates": ResourceClaimTemplate,
    "podlogs": PodLog,
    "podexecs": PodExec,
    "podportforwards": PodPortForward,
    "configmaps": ConfigMap,
    "secrets": Secret,
    "ingresses": Ingress,
    "ingressclasses": IngressClass,
    "networkpolicies": NetworkPolicy,
    "prioritylevelconfigurations": PriorityLevelConfiguration,
    "flowschemas": FlowSchemaConfiguration,
    "validatingadmissionpolicies": ValidatingAdmissionPolicy,
    "validatingadmissionpolicybindings": ValidatingAdmissionPolicyBinding,
    "mutatingwebhookconfigurations": MutatingWebhookConfiguration,
    "validatingwebhookconfigurations": ValidatingWebhookConfiguration,
    "podgroups": PodGroup,
}
CLUSTER_SCOPED = {"nodes", "namespaces", "persistentvolumes", "storageclasses",
                  "volumeattachments", "apiservices",
                  "csinodes", "resourceslices", "deviceclasses",
                  "priorityclasses", "customresourcedefinitions",
                  "certificatesigningrequests", "ingressclasses",
                  "prioritylevelconfigurations", "flowschemas",
                  "validatingadmissionpolicies",
                  "validatingadmissionpolicybindings",
                  "mutatingwebhookconfigurations",
                  "validatingwebhookconfigurations"}
GROUP_PREFIX = {
    "pods": "/api/v1",
    "nodes": "/api/v1",
    "namespaces": "/api/v1",
    "replicasets": "/apis/apps/v1",
    "deployments": "/apis/apps/v1",
    "statefulsets": "/apis/apps/v1",
    "daemonsets": "/apis/apps/v1",
    "jobs": "/apis/batch/v1",
    "cronjobs": "/apis/batch/v1",
    "leases": "/apis/coordination.k8s.io/v1",
    "persistentvolumes": "/api/v1",
    "persistentvolumeclaims": "/api/v1",
    "storageclasses": "/apis/storage.k8s.io/v1",
    "csinodes": "/apis/storage.k8s.io/v1",
    "volumeattachments": "/apis/storage.k8s.io/v1",
    "apiservices": "/apis/apiregistration.k8s.io/v1",
    "services": "/api/v1",
    "endpointslices": "/apis/discovery.k8s.io/v1",
    "resourcequotas": "/api/v1",
    "limitranges": "/api/v1",
    "horizontalpodautoscalers": "/apis/autoscaling/v2",
    "poddisruptionbudgets": "/apis/policy/v1",
    "priorityclasses": "/apis/scheduling.k8s.io/v1",
    "serviceaccounts": "/api/v1",
    "events": "/api/v1",
    "resourceclaims": "/apis/resource.k8s.io/v1beta1",
    "resourceclaimtemplates": "/apis/resource.k8s.io/v1beta1",
    "resourceslices": "/apis/resource.k8s.io/v1beta1",
    "deviceclasses": "/apis/resource.k8s.io/v1beta1",
    "customresourcedefinitions": "/apis/apiextensions.k8s.io/v1",
    "certificatesigningrequests": "/apis/certificates.k8s.io/v1",
    "podlogs": "/api/v1",
    "podexecs": "/api/v1",
    "podportforwards": "/api/v1",
    "configmaps": "/api/v1",
    "secrets": "/api/v1",
    "ingresses": "/apis/networking.k8s.io/v1",
    "ingressclasses": "/apis/networking.k8s.io/v1",
    "networkpolicies": "/apis/networking.k8s.io/v1",
    "prioritylevelconfigurations": "/apis/flowcontrol.apiserver.k8s.io/v1",
    "flowschemas": "/apis/flowcontrol.apiserver.k8s.io/v1",
    "validatingadmissionpolicies": "/apis/admissionregistration.k8s.io/v1",
    "validatingadmissionpolicybindings":
        "/apis/admissionregistration.k8s.io/v1",
    "mutatingwebhookconfigurations": "/apis/admissionregistration.k8s.io/v1",
    "validatingwebhookconfigurations":
        "/apis/admissionregistration.k8s.io/v1",
    "podgroups": "/apis/scheduling.x-k8s.io/v1alpha1",
}


def resource_type(resource: str):
    """The object type of a resource name; KeyError for an unknown one."""
    return RESOURCE_TO_TYPE[resource]


def from_dict(resource: str, d: Dict) -> Any:
    t = resource_type(resource)
    if hasattr(t, "from_dict"):
        return t.from_dict(d)
    raise ValueError(f"cannot deserialize {resource}")


def _requirements_to_list(reqs) -> list:
    out = []
    for r in reqs:
        e: Dict[str, Any] = {"key": r.key, "operator": r.op}
        if r.values:
            e["values"] = list(r.values)
        out.append(e)
    return out


def _selector_to_dict(sel: Selector) -> Dict:
    return {"matchExpressions": _requirements_to_list(sel.requirements)} if sel.requirements else {}


def _node_selector_to_dict(ns: NodeSelector) -> Dict:
    return {"nodeSelectorTerms": [
        {
            **({"matchExpressions": _requirements_to_list(t.match_expressions)}
               if t.match_expressions else {}),
            **({"matchFields": _requirements_to_list(t.match_fields)}
               if t.match_fields else {}),
        }
        for t in ns.terms
    ]}


def _pod_affinity_term_to_dict(t: PodAffinityTerm) -> Dict:
    d: Dict[str, Any] = {"topologyKey": t.topology_key}
    if t.selector is not None:
        d["labelSelector"] = _selector_to_dict(t.selector)
    if t.namespaces:
        d["namespaces"] = list(t.namespaces)
    if t.namespace_selector is not None:
        d["namespaceSelector"] = _selector_to_dict(t.namespace_selector)
    if t.match_label_keys:
        d["matchLabelKeys"] = list(t.match_label_keys)
    return d


def _affinity_to_dict(a: Affinity) -> Dict:
    d: Dict[str, Any] = {}
    na: Dict[str, Any] = {}
    if a.node_affinity_required is not None:
        na["requiredDuringSchedulingIgnoredDuringExecution"] = _node_selector_to_dict(
            a.node_affinity_required)
    if a.node_affinity_preferred:
        na["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": p.weight, "preference": {
                **({"matchExpressions": _requirements_to_list(p.term.match_expressions)}
                   if p.term.match_expressions else {}),
                **({"matchFields": _requirements_to_list(p.term.match_fields)}
                   if p.term.match_fields else {}),
            }}
            for p in a.node_affinity_preferred
        ]
    if na:
        d["nodeAffinity"] = na
    for attr, key in (("pod_affinity_required", "podAffinity"),
                      ("pod_anti_affinity_required", "podAntiAffinity")):
        terms = getattr(a, attr)
        pref = getattr(a, attr.replace("_required", "_preferred"))
        sub: Dict[str, Any] = {}
        if terms:
            sub["requiredDuringSchedulingIgnoredDuringExecution"] = [
                _pod_affinity_term_to_dict(t) for t in terms]
        if pref:
            sub["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": w.weight, "podAffinityTerm": _pod_affinity_term_to_dict(w.term)}
                for w in pref]
        if sub:
            d[key] = sub
    return d


def pod_to_dict(pod: Pod) -> Dict:
    spec: Dict[str, Any] = {
        "containers": [c.to_dict() for c in pod.spec.containers],
    }
    if pod.spec.init_containers:
        spec["initContainers"] = [c.to_dict() for c in pod.spec.init_containers]
    if pod.spec.node_name:
        spec["nodeName"] = pod.spec.node_name
    if pod.spec.scheduler_name != "default-scheduler":
        spec["schedulerName"] = pod.spec.scheduler_name
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(pod.spec.node_selector)
    if pod.spec.affinity:
        aff = _affinity_to_dict(pod.spec.affinity)
        if aff:
            spec["affinity"] = aff
    if pod.spec.tolerations:
        spec["tolerations"] = [
            {k: v for k, v in (("key", t.key), ("operator", t.operator), ("value", t.value),
                               ("effect", t.effect), ("tolerationSeconds", t.toleration_seconds))
             if v not in ("", None)}
            for t in pod.spec.tolerations
        ]
    if pod.spec.topology_spread_constraints:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": c.max_skew,
                "topologyKey": c.topology_key,
                "whenUnsatisfiable": c.when_unsatisfiable,
                **({"labelSelector": _selector_to_dict(c.selector)} if c.selector is not None else {}),
                **({"minDomains": c.min_domains} if c.min_domains else {}),
                **({"matchLabelKeys": list(c.match_label_keys)} if c.match_label_keys else {}),
            }
            for c in pod.spec.topology_spread_constraints
        ]
    if pod.spec.priority:
        spec["priority"] = pod.spec.priority
    if pod.spec.priority_class_name:
        spec["priorityClassName"] = pod.spec.priority_class_name
    if pod.spec.scheduling_gates:
        spec["schedulingGates"] = [{"name": g} for g in pod.spec.scheduling_gates]
    if pod.spec.overhead:
        spec["overhead"] = pod.spec.overhead
    if pod.spec.volumes:
        spec["volumes"] = [v.to_dict() for v in pod.spec.volumes]
    if pod.spec.resource_claims or pod.spec.resource_claim_templates:
        spec["resourceClaims"] = [
            {"name": n, "resourceClaimName": rc}
            for n, rc in pod.spec.resource_claims
        ] + [
            {"name": n, "resourceClaimTemplateName": t}
            for n, t in pod.spec.resource_claim_templates
        ]
    if pod.spec.service_account_name:
        spec["serviceAccountName"] = pod.spec.service_account_name
    # non-default scalars must round-trip, or read-modify-write paths (PATCH,
    # apply) silently reset them to from_dict defaults
    if pod.spec.restart_policy != "Always":
        spec["restartPolicy"] = pod.spec.restart_policy
    if pod.spec.termination_grace_period_seconds != 30:
        spec["terminationGracePeriodSeconds"] = pod.spec.termination_grace_period_seconds
    if pod.spec.preemption_policy != "PreemptLowerPriority":
        spec["preemptionPolicy"] = pod.spec.preemption_policy
    if pod.spec.host_network:
        spec["hostNetwork"] = True
    if pod.spec.host_pid:
        spec["hostPID"] = True
    if pod.spec.host_ipc:
        spec["hostIPC"] = True
    if pod.spec.security_context:
        spec["securityContext"] = pod.spec.security_context
    status: Dict[str, Any] = {"phase": pod.status.phase}
    if pod.status.nominated_node_name:
        status["nominatedNodeName"] = pod.status.nominated_node_name
    if pod.status.resource_claim_statuses:
        status["resourceClaimStatuses"] = [
            {"name": n, "resourceClaimName": c}
            for n, c in pod.status.resource_claim_statuses.items()]
    if pod.status.conditions:
        status["conditions"] = [
            {"type": c.type, "status": c.status,
             **({"reason": c.reason} if c.reason else {}),
             **({"message": c.message} if c.message else {}),
             **({"lastTransitionTime": c.last_transition_time}
                if c.last_transition_time else {})}
            for c in pod.status.conditions
        ]
    return {"apiVersion": "v1", "kind": "Pod", "metadata": pod.metadata.to_dict(),
            "spec": spec, "status": status}


def node_to_dict(node: Node) -> Dict:
    spec: Dict[str, Any] = {}
    if node.spec.unschedulable:
        spec["unschedulable"] = True
    if node.spec.taints:
        spec["taints"] = [
            {"key": t.key, **({"value": t.value} if t.value else {}), "effect": t.effect}
            for t in node.spec.taints
        ]
    status: Dict[str, Any] = {
        "capacity": dict(node.status.capacity),
        "allocatable": dict(node.status.allocatable),
    }
    if node.status.images:
        status["images"] = [{"names": list(i.names), "sizeBytes": i.size_bytes}
                            for i in node.status.images]
    if node.status.conditions:
        status["conditions"] = [
            {"type": c.type, "status": c.status,
             **({"reason": c.reason} if c.reason else {})}
            for c in node.status.conditions
        ]
    meta = node.metadata.to_dict()
    meta.pop("namespace", None)
    return {"apiVersion": "v1", "kind": "Node", "metadata": meta, "spec": spec, "status": status}


def _template_to_dict(t) -> Dict:
    pod = Pod(metadata=t.metadata, spec=t.spec)
    d = pod_to_dict(pod)
    return {"metadata": {k: v for k, v in d["metadata"].items()
                         if k in ("labels", "annotations", "name")},
            "spec": d["spec"]}


def replicaset_to_dict(rs: ReplicaSet) -> Dict:
    return {
        "apiVersion": "apps/v1", "kind": "ReplicaSet",
        "metadata": rs.metadata.to_dict(),
        "spec": {
            "replicas": rs.spec.replicas,
            **({"selector": _selector_to_dict(rs.spec.selector)}
               if rs.spec.selector is not None else {}),
            "template": _template_to_dict(rs.spec.template),
        },
        "status": {
            "replicas": rs.status.replicas,
            "readyReplicas": rs.status.ready_replicas,
            "observedGeneration": rs.status.observed_generation,
        },
    }


def deployment_to_dict(dep: Deployment) -> Dict:
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": dep.metadata.to_dict(),
        "spec": {
            "replicas": dep.spec.replicas,
            **({"selector": _selector_to_dict(dep.spec.selector)}
               if dep.spec.selector is not None else {}),
            "template": _template_to_dict(dep.spec.template),
            "strategy": {"type": dep.spec.strategy,
                         **({"rollingUpdate": {"maxSurge": dep.spec.max_surge,
                                               "maxUnavailable": dep.spec.max_unavailable}}
                            if dep.spec.strategy == "RollingUpdate" else {})},
        },
        "status": {
            "replicas": dep.status.replicas,
            "updatedReplicas": dep.status.updated_replicas,
            "readyReplicas": dep.status.ready_replicas,
            "observedGeneration": dep.status.observed_generation,
        },
    }


def job_to_dict(job: Job) -> Dict:
    spec: Dict[str, Any] = {
        "parallelism": job.spec.parallelism,
        "backoffLimit": job.spec.backoff_limit,
        "template": _template_to_dict(job.spec.template),
    }
    if job.spec.completions is not None:
        spec["completions"] = job.spec.completions
    if job.spec.active_deadline_seconds is not None:
        spec["activeDeadlineSeconds"] = job.spec.active_deadline_seconds
    if job.spec.completion_mode != "NonIndexed":
        spec["completionMode"] = job.spec.completion_mode
    if job.spec.selector is not None:
        spec["selector"] = _selector_to_dict(job.spec.selector)
    if job.spec.suspend:
        spec["suspend"] = True
    if job.spec.ttl_seconds_after_finished is not None:
        spec["ttlSecondsAfterFinished"] = job.spec.ttl_seconds_after_finished
    status: Dict[str, Any] = {
        "active": job.status.active,
        "succeeded": job.status.succeeded,
        "failed": job.status.failed,
    }
    if job.status.conditions:
        status["conditions"] = job.status.conditions
    if job.status.completed_indexes:
        status["completedIndexes"] = job.status.completed_indexes
    return {"apiVersion": "batch/v1", "kind": "Job",
            "metadata": job.metadata.to_dict(), "spec": spec, "status": status}


def cronjob_to_dict(cj: CronJob) -> Dict:
    job_spec = job_to_dict(Job(spec=cj.spec.job_template))["spec"]
    status: Dict[str, Any] = {}
    if cj.status.last_schedule_time is not None:
        status["lastScheduleTime"] = cj.status.last_schedule_time
    return {
        "apiVersion": "batch/v1", "kind": "CronJob",
        "metadata": cj.metadata.to_dict(),
        "spec": {
            "schedule": cj.spec.schedule,
            **({"timeZone": cj.spec.time_zone} if cj.spec.time_zone else {}),
            "concurrencyPolicy": cj.spec.concurrency_policy,
            **({"suspend": True} if cj.spec.suspend else {}),
            **({"startingDeadlineSeconds": cj.spec.starting_deadline_seconds}
               if cj.spec.starting_deadline_seconds is not None else {}),
            "successfulJobsHistoryLimit": cj.spec.successful_jobs_history_limit,
            "failedJobsHistoryLimit": cj.spec.failed_jobs_history_limit,
            "jobTemplate": {"spec": job_spec},
        },
        "status": status,
    }


def statefulset_to_dict(sts: StatefulSet) -> Dict:
    return {
        "apiVersion": "apps/v1", "kind": "StatefulSet",
        "metadata": sts.metadata.to_dict(),
        "spec": {
            "replicas": sts.spec.replicas,
            **({"selector": _selector_to_dict(sts.spec.selector)}
               if sts.spec.selector is not None else {}),
            "serviceName": sts.spec.service_name,
            "podManagementPolicy": sts.spec.pod_management_policy,
            "template": _template_to_dict(sts.spec.template),
            **({"volumeClaimTemplates": sts.spec.volume_claim_templates}
               if sts.spec.volume_claim_templates else {}),
            "updateStrategy": {
                "type": sts.spec.update_strategy,
                **({"rollingUpdate": {"partition": sts.spec.partition}}
                   if sts.spec.partition else {}),
            },
        },
        "status": {
            "replicas": sts.status.replicas,
            "readyReplicas": sts.status.ready_replicas,
            "currentReplicas": sts.status.current_replicas,
            "updatedReplicas": sts.status.updated_replicas,
            "observedGeneration": sts.status.observed_generation,
            **({"updateRevision": sts.status.update_revision}
               if sts.status.update_revision else {}),
        },
    }


def daemonset_to_dict(ds: DaemonSet) -> Dict:
    return {
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "metadata": ds.metadata.to_dict(),
        "spec": {
            **({"selector": _selector_to_dict(ds.spec.selector)}
               if ds.spec.selector is not None else {}),
            "template": _template_to_dict(ds.spec.template),
            "updateStrategy": {
                "type": ds.spec.update_strategy,
                **({"rollingUpdate": {"maxUnavailable": ds.spec.max_unavailable}}
                   if ds.spec.update_strategy == "RollingUpdate" else {}),
            },
        },
        "status": {
            "desiredNumberScheduled": ds.status.desired_number_scheduled,
            "currentNumberScheduled": ds.status.current_number_scheduled,
            "numberReady": ds.status.number_ready,
            "numberMisscheduled": ds.status.number_misscheduled,
            "updatedNumberScheduled": ds.status.updated_number_scheduled,
            "observedGeneration": ds.status.observed_generation,
        },
    }


def lease_to_dict(lease: Lease) -> Dict:
    return {
        "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
        "metadata": lease.metadata.to_dict(),
        "spec": {
            "holderIdentity": lease.holder_identity,
            "leaseDurationSeconds": lease.lease_duration_seconds,
            "acquireTime": lease.acquire_time,
            "renewTime": lease.renew_time,
        },
    }


def namespace_to_dict(ns: Namespace) -> Dict:
    meta = ns.metadata.to_dict()
    meta.pop("namespace", None)
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": meta}


_SERIALIZERS = {
    Pod: pod_to_dict,
    Node: node_to_dict,
    ReplicaSet: replicaset_to_dict,
    Deployment: deployment_to_dict,
    StatefulSet: statefulset_to_dict,
    DaemonSet: daemonset_to_dict,
    Job: job_to_dict,
    CronJob: cronjob_to_dict,
    Lease: lease_to_dict,
    Namespace: namespace_to_dict,
}


def to_dict(obj: Any) -> Dict:
    fn = _SERIALIZERS.get(type(obj))
    if fn is None:
        if hasattr(obj, "to_dict"):
            return obj.to_dict()
        raise ValueError(f"cannot serialize {type(obj).__name__}")
    return fn(obj)
