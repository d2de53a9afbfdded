"""Admission chain: mutating then validating plugins between authn and storage.

reference: staging/src/k8s.io/apiserver/pkg/admission (chain execution) and
plugin/pkg/admission/* — the subset carried here: NamespaceLifecycle,
LimitRanger, ResourceQuota, PodTolerationRestriction, NodeRestriction, plus
metadata defaulting. The REST server runs the chain on every create/update;
direct store writes (tests, controllers) bypass it, mirroring how controllers
with etcd access bypass admission in the reference only in the sense that the
chain lives in the apiserver handler path.

The counterpart of `kubernetes_tpu/server/admission.py`: the same behaviour,
names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional, Sequence

from ..api.policy import LimitRange, ResourceQuota
from ..api.resources import quantity_milli_value, quantity_value
from ..api.types import Taint, Toleration, new_uid
from ..controllers.serviceaccount import BOOTSTRAP_NAMESPACES
from ..store import APIStore, NotFoundError
from .podsecurity import ENFORCE_LABEL, LEVELS, check_level

CREATE = "CREATE"
UPDATE = "UPDATE"


class AdmissionError(Exception):
    def __init__(self, message: str, code: int = 403, reason: str = "Forbidden"):
        super().__init__(message)
        self.code = code
        self.reason = reason


class AdmissionPlugin:
    name = "AdmissionPlugin"

    def admit(self, store: APIStore, resource: str, operation: str, obj,
              user: str = "") -> None:
        """Mutating pass: modify obj in place or raise AdmissionError."""

    def validate(self, store: APIStore, resource: str, operation: str, obj,
                 user: str = "") -> None:
        """Validating pass: raise AdmissionError to reject."""


class MetadataDefaulter(AdmissionPlugin):
    """uid + creationTimestamp defaulting (the registry strategies'
    PrepareForCreate in the reference)."""

    name = "MetadataDefaulter"

    def __init__(self, now: Optional[Callable[[], float]] = None):
        import time

        self._now = now or time.time

    def admit(self, store, resource, operation, obj, user="") -> None:
        if operation != CREATE:
            return
        if not obj.metadata.uid:
            obj.metadata.uid = new_uid()
        if not obj.metadata.creation_timestamp:
            obj.metadata.creation_timestamp = self._now()


class NamespaceLifecycle(AdmissionPlugin):
    """Rejects writes into missing or terminating namespaces
    (plugin/pkg/admission/namespace/lifecycle)."""

    name = "NamespaceLifecycle"

    def validate(self, store, resource, operation, obj, user="") -> None:
        ns = getattr(obj.metadata, "namespace", "")
        if not ns or resource == "namespaces" or operation == "DELETE":
            return  # deletes must work even when the namespace is already gone
        if ns in BOOTSTRAP_NAMESPACES:
            return
        try:
            namespace = store.get("namespaces", ns)
        except NotFoundError:
            raise AdmissionError(f'namespace "{ns}" not found', code=404,
                                 reason="NotFound")
        if namespace.metadata.deletion_timestamp is not None and operation == CREATE:
            raise AdmissionError(
                f'namespace "{ns}" is terminating: no new objects allowed')


class LimitRanger(AdmissionPlugin):
    """Applies LimitRange container defaults and enforces min/max
    (plugin/pkg/admission/limitranger)."""

    name = "LimitRanger"

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        ranges, _ = store.list(
            "limitranges", lambda lr: lr.metadata.namespace == obj.metadata.namespace)
        for lr in ranges:
            for c in list(obj.spec.containers) + list(obj.spec.init_containers):
                # a manifest may carry "resources": {"requests": null}
                if not isinstance(c.resources, dict):
                    c.resources = {}
                if not isinstance(c.resources.get("requests"), dict):
                    c.resources["requests"] = {}
                if not isinstance(c.resources.get("limits"), dict):
                    c.resources["limits"] = {}
                for key, val in lr.default_requests.items():
                    c.resources["requests"].setdefault(key, val)
                for key, val in lr.default_limits.items():
                    c.resources["limits"].setdefault(key, val)

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        ranges, _ = store.list(
            "limitranges", lambda lr: lr.metadata.namespace == obj.metadata.namespace)
        for lr in ranges:
            for c in list(obj.spec.containers) + list(obj.spec.init_containers):
                requests = (c.resources or {}).get("requests") or {}
                for key, cap in lr.max.items():
                    have = requests.get(key)
                    if have is not None and _cmp(key, have) > _cmp(key, cap):
                        raise AdmissionError(
                            f"maximum {key} usage per Container is {cap}, but "
                            f"request is {have}")
                for key, floor in lr.min.items():
                    have = requests.get(key)
                    if have is not None and _cmp(key, have) < _cmp(key, floor):
                        raise AdmissionError(
                            f"minimum {key} usage per Container is {floor}, but "
                            f"request is {have}")


def _cmp(key: str, value) -> int:
    return quantity_milli_value(value) if key == "cpu" else quantity_value(value)


class ResourceQuotaAdmission(AdmissionPlugin):
    """Rejects pod creates that would exceed any ResourceQuota hard limit
    (plugin/pkg/admission/resourcequota). Usage is recomputed live so the
    check does not depend on the quota controller's status lag."""

    name = "ResourceQuota"

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        ns = obj.metadata.namespace
        quotas, _ = store.list("resourcequotas", lambda q: q.metadata.namespace == ns)
        if not quotas:
            return
        pods, _ = store.list(
            "pods", lambda p: p.metadata.namespace == ns and not p.is_terminal())
        used_cpu = sum(
            quantity_milli_value((c.resources.get("requests") or {}).get("cpu", 0))
            for p in pods for c in list(p.spec.containers) + list(p.spec.init_containers))
        used_mem = sum(
            quantity_value((c.resources.get("requests") or {}).get("memory", 0))
            for p in pods for c in list(p.spec.containers) + list(p.spec.init_containers))
        new_cpu = sum(
            quantity_milli_value((c.resources.get("requests") or {}).get("cpu", 0))
            for c in list(obj.spec.containers) + list(obj.spec.init_containers))
        new_mem = sum(
            quantity_value((c.resources.get("requests") or {}).get("memory", 0))
            for c in list(obj.spec.containers) + list(obj.spec.init_containers))
        for quota in quotas:
            for key, hard in quota.hard.items():
                if key in ("requests.cpu", "cpu"):
                    if used_cpu + new_cpu > quantity_milli_value(hard):
                        self._reject(quota, key, hard)
                elif key in ("requests.memory", "memory"):
                    if used_mem + new_mem > quantity_value(hard):
                        self._reject(quota, key, hard)
                elif key == "pods":
                    if len(pods) + 1 > int(hard):
                        self._reject(quota, key, hard)

    @staticmethod
    def _reject(quota: ResourceQuota, key: str, hard) -> None:
        raise AdmissionError(
            f"exceeded quota: {quota.metadata.name}, limited: {key}={hard}")


class PodTolerationRestriction(AdmissionPlugin):
    """Merges namespace default tolerations into pods
    (plugin/pkg/admission/podtolerationrestriction; annotation
    scheduler.alpha.kubernetes.io/defaultTolerations)."""

    name = "PodTolerationRestriction"
    DEFAULT_KEY = "scheduler.alpha.kubernetes.io/defaultTolerations"
    WHITELIST_KEY = "scheduler.alpha.kubernetes.io/tolerationsWhitelist"

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        ns = self._namespace(store, obj)
        if ns is None:
            return
        raw = ns.metadata.annotations.get(self.DEFAULT_KEY)
        if raw:
            for t in json.loads(raw):
                tol = Toleration.from_dict(t)
                if tol not in obj.spec.tolerations:
                    obj.spec.tolerations.append(tol)

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        ns = self._namespace(store, obj)
        if ns is None:
            return
        raw = ns.metadata.annotations.get(self.WHITELIST_KEY)
        if not raw:
            return
        allowed = [Toleration.from_dict(t) for t in json.loads(raw)]
        for tol in obj.spec.tolerations:
            if tol not in allowed:
                raise AdmissionError(
                    f"pod toleration {tol.key!r} not in the namespace whitelist")

    @staticmethod
    def _namespace(store, obj):
        try:
            return store.get("namespaces", obj.metadata.namespace)
        except NotFoundError:
            return None


class NodeRestriction(AdmissionPlugin):
    """A node identity (system:node:<name>) may only modify its own Node object
    and pods bound to it (plugin/pkg/admission/noderestriction)."""

    name = "NodeRestriction"
    PREFIX = "system:node:"

    def validate(self, store, resource, operation, obj, user="") -> None:
        if not user.startswith(self.PREFIX):
            return
        node_name = user[len(self.PREFIX):]
        if resource == "nodes" and obj.metadata.name != node_name:
            raise AdmissionError(
                f"node {node_name!r} may not modify node {obj.metadata.name!r}")
        if resource == "pods" and obj.spec.node_name != node_name:
            raise AdmissionError(
                f"node {node_name!r} may only write pods bound to itself")


class PriorityAdmission(AdmissionPlugin):
    """Resolves pod.spec.priorityClassName into spec.priority and
    spec.preemptionPolicy (plugin/pkg/admission/priority): unknown class
    names are rejected; a globalDefault class applies to pods that name none;
    the system- prefix is reserved."""

    name = "Priority"
    SYSTEM_CLASSES = {
        "system-cluster-critical": 2_000_000_000,
        "system-node-critical": 2_000_001_000,
    }

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        name = obj.spec.priority_class_name
        if not name:
            # the class value is AUTHORITATIVE: a client-supplied
            # spec.priority is always overwritten (0 without a default class)
            # — otherwise any tenant could self-assign system priority
            classes, _ = store.list("priorityclasses", lambda c: c.global_default)
            if classes:
                # ties between multiple globalDefault classes resolve to the
                # highest value (priority plugin getDefaultPriority)
                default = max(classes, key=lambda c: c.value)
                obj.spec.priority_class_name = default.metadata.name
                obj.spec.priority = default.value
                obj.spec.preemption_policy = default.preemption_policy
            else:
                obj.spec.priority = 0
            return
        if name in self.SYSTEM_CLASSES:
            # system classes are reserved for kube-system workloads
            if obj.metadata.namespace != "kube-system":
                raise AdmissionError(
                    f"pods with {name} priorityClass may only be created in "
                    "the kube-system namespace")
            obj.spec.priority = self.SYSTEM_CLASSES[name]
            # the class value is authoritative here too — system-critical
            # pods must be able to preempt
            obj.spec.preemption_policy = "PreemptLowerPriority"
            return
        try:
            pc = store.get("priorityclasses", name)
        except NotFoundError:
            raise AdmissionError(f"no PriorityClass with name {name!r} was found",
                                 code=400, reason="Invalid")
        obj.spec.priority = pc.value
        obj.spec.preemption_policy = pc.preemption_policy

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource == "pods" and operation == UPDATE:
            # pod priority is immutable after create (api validation in the
            # reference); without this a PUT could self-assign system priority
            try:
                existing = store.get("pods", obj.key)
            except NotFoundError:
                return
            if (obj.spec.priority != existing.spec.priority
                    or obj.spec.priority_class_name != existing.spec.priority_class_name):
                raise AdmissionError(
                    "pod updates may not change priority or priorityClassName",
                    code=422, reason="Invalid")
            return
        if resource != "priorityclasses" or operation != CREATE:
            return
        if obj.metadata.name.startswith("system-") \
                and obj.metadata.name not in self.SYSTEM_CLASSES:
            raise AdmissionError(
                "the system- prefix is reserved for system priority classes")


class DefaultTolerationSeconds(AdmissionPlugin):
    """Adds the 300s not-ready/unreachable NoExecute tolerations every pod
    gets (plugin/pkg/admission/defaulttolerationseconds) so taint eviction has
    the standard grace period."""

    name = "DefaultTolerationSeconds"
    SECONDS = 300
    KEYS = ("node.kubernetes.io/not-ready", "node.kubernetes.io/unreachable")

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        for key in self.KEYS:
            # skip only when an existing toleration ACTUALLY tolerates the
            # taint (ToleratesTaint in the reference plugin) — a key-equal
            # toleration with a non-matching value would not
            taint = Taint(key=key, effect="NoExecute")
            if any(t.tolerates(taint) for t in obj.spec.tolerations):
                continue
            obj.spec.tolerations.append(Toleration(
                key=key, operator="Exists", effect="NoExecute",
                toleration_seconds=self.SECONDS))


class DefaultStorageClass(AdmissionPlugin):
    """PVCs without a storageClassName get the cluster default class
    (plugin/pkg/admission/storage/storageclass/setdefault)."""

    name = "DefaultStorageClass"

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "persistentvolumeclaims" or operation != CREATE:
            return
        # None = "use the default class"; an EXPLICIT "" requests classless
        # static binding and must not be overwritten (setdefault plugin only
        # defaults when the field is nil)
        if obj.spec.storage_class_name is not None:
            return
        classes, _ = store.list("storageclasses", lambda c: c.is_default)
        if classes:
            # several defaults: newest creationTimestamp wins (setdefault
            # plugin tie-break)
            newest = max(classes, key=lambda c: c.metadata.creation_timestamp)
            obj.spec.storage_class_name = newest.metadata.name


class AlwaysPullImages(AdmissionPlugin):
    """Forces imagePullPolicy=Always (plugin/pkg/admission/alwayspullimages —
    multi-tenant image-credential protection). NOT in the default chain, like
    the reference; opt in via AdmissionChain([...])."""

    name = "AlwaysPullImages"

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            c.image_pull_policy = "Always"

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            if c.image_pull_policy != "Always":
                raise AdmissionError(
                    f"container {c.name!r} must have imagePullPolicy Always")


class ServiceAccountAdmission(AdmissionPlugin):
    """Defaults pod.spec.serviceAccountName to 'default' and requires an
    explicitly named non-default SA to exist
    (plugin/pkg/admission/serviceaccount). The implicit 'default' SA is not
    required to exist yet — the serviceaccount controller creates it
    asynchronously, same bootstrap tolerance as the reference's retry loop."""

    name = "ServiceAccount"

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        if not obj.spec.service_account_name:
            obj.spec.service_account_name = "default"

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        name = obj.spec.service_account_name
        if name in ("", "default"):
            return
        try:
            store.get("serviceaccounts", f"{obj.metadata.namespace}/{name}")
        except NotFoundError:
            raise AdmissionError(
                f"service account {obj.metadata.namespace}/{name} was not found",
                code=403, reason="Forbidden")


class PodSecurityAdmission(AdmissionPlugin):
    """Enforces the namespace's pod-security.kubernetes.io/enforce level on
    pod writes (staging/src/k8s.io/pod-security-admission/admission). The
    level checks live in podsecurity.py; unlabelled namespaces are
    `privileged` (no enforcement)."""

    name = "PodSecurity"

    def validate(self, store, resource, operation, obj, user="") -> None:
        # CREATE only: labelling a namespace must leave existing pods
        # updatable (status writes, labels) — the reference's
        # isSignificantPodUpdate exemption; pod specs are near-immutable
        # anyway, so create-time is where the policy bites
        if resource != "pods" or operation != CREATE:
            return
        try:
            ns = store.get("namespaces", obj.metadata.namespace)
        except NotFoundError:
            return  # NamespaceLifecycle owns this rejection
        level = ns.metadata.labels.get(ENFORCE_LABEL, "privileged")
        if level not in LEVELS:
            level = "restricted"  # unknown label value: fail closed
        errs = check_level(level, obj)
        if errs:
            raise AdmissionError(
                f"violates PodSecurity \"{level}\": " + "; ".join(errs),
                code=403, reason="Forbidden")


class ExtendedResourceToleration(AdmissionPlugin):
    """Pods requesting extended resources (anything not a core compute
    resource) get a matching toleration, so dedicated device nodes can be
    tainted with their resource name
    (plugin/pkg/admission/extendedresourcetoleration)."""

    name = "ExtendedResourceToleration"

    @staticmethod
    def is_extended(key: str) -> bool:
        """helper.IsExtendedResourceName: domain-qualified, not a native
        kubernetes.io resource, not a hugepages size."""
        if "/" not in key:
            return False
        domain = key.split("/", 1)[0]
        if domain == "kubernetes.io" or domain.endswith(".kubernetes.io"):
            return False
        return not key.startswith("requests.")

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE:
            return
        extended = set()
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            for section in ("requests", "limits"):
                for key in ((c.resources or {}).get(section) or {}):
                    if self.is_extended(key):
                        extended.add(key)
        for key in sorted(extended):
            if not any(t.key == key for t in obj.spec.tolerations):
                obj.spec.tolerations.append(Toleration(
                    key=key, operator="Exists", effect="NoSchedule"))


class TaintNodesByCondition(AdmissionPlugin):
    """New nodes start tainted not-ready NoSchedule until node_lifecycle
    observes a Ready condition (plugin/pkg/admission/nodetaint) — closes the
    window where a scheduler could bind to a node whose kubelet has not
    reported yet."""

    name = "TaintNodesByCondition"
    NOT_READY = "node.kubernetes.io/not-ready"

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "nodes" or operation != CREATE:
            return
        if not any(t.key == self.NOT_READY for t in obj.spec.taints):
            obj.spec.taints.append(Taint(key=self.NOT_READY, effect="NoSchedule"))


class LimitPodHardAntiAffinityTopology(AdmissionPlugin):
    """Rejects required pod anti-affinity with a topologyKey other than
    kubernetes.io/hostname (plugin/pkg/admission/antiaffinity) — zone-wide
    hard anti-affinity lets one tenant fence whole failure domains. NOT in
    the default chain, same as the reference."""

    name = "LimitPodHardAntiAffinityTopology"
    HOSTNAME = "kubernetes.io/hostname"

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource != "pods" or operation != CREATE or obj.spec.affinity is None:
            return
        for term in obj.spec.affinity.pod_anti_affinity_required:
            if term.topology_key != self.HOSTNAME:
                raise AdmissionError(
                    "affinity.podAntiAffinity.requiredDuringScheduling... "
                    f"topologyKey must be {self.HOSTNAME!r}, got "
                    f"{term.topology_key!r}", code=422, reason="Invalid")


class WorkloadValidation(AdmissionPlugin):
    """API-validation subset for workload specs the controllers depend on
    (pkg/apis/batch/validation): Indexed jobs require completions, and
    parallelism/completions/backoffLimit may not be negative."""

    name = "WorkloadValidation"

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource == "cronjobs" and operation in (CREATE, UPDATE):
            # the schedule and timeZone must parse NOW — a bad value stored
            # would make every controller sync raise forever
            from ..utils.cron import CronSchedule

            try:
                CronSchedule(obj.spec.schedule, tz=obj.spec.time_zone)
            except ValueError as e:
                raise AdmissionError(f"spec.schedule/timeZone: {e}",
                                     code=422, reason="Invalid")
            return
        if resource != "jobs" or operation not in (CREATE, UPDATE):
            return
        spec = obj.spec
        if spec.completion_mode == "Indexed" and spec.completions is None:
            raise AdmissionError(
                "spec.completions: Required value: when completion mode is "
                "Indexed", code=422, reason="Invalid")
        for name, val in (("parallelism", spec.parallelism),
                          ("completions", spec.completions),
                          ("backoffLimit", spec.backoff_limit)):
            if val is not None and val < 0:
                raise AdmissionError(
                    f"spec.{name}: must be greater than or equal to 0",
                    code=422, reason="Invalid")
        if operation == UPDATE:
            # completionMode/completions are immutable (batch validation):
            # flipping a running job to Indexed would orphan its index-less
            # pods and double-schedule every index
            try:
                existing = store.get(
                    "jobs", f"{obj.metadata.namespace}/{obj.metadata.name}")
            except NotFoundError:
                return
            if existing.spec.completion_mode != spec.completion_mode:
                raise AdmissionError("spec.completionMode is immutable",
                                     code=422, reason="Invalid")
            if existing.spec.completions != spec.completions:
                raise AdmissionError("spec.completions is immutable",
                                     code=422, reason="Invalid")


class DefaultIngressClass(AdmissionPlugin):
    """Ingresses without an ingressClassName get the cluster default class
    (plugin/pkg/admission/network/defaultingressclass) — the
    is-default-class annotation drives it, ties resolve to the newest."""

    name = "DefaultIngressClass"

    def admit(self, store, resource, operation, obj, user="") -> None:
        if resource != "ingresses" or operation != CREATE:
            return
        if obj.ingress_class_name is not None:
            return
        classes, _ = store.list("ingressclasses", lambda c: c.is_default)
        if classes:
            newest = max(classes, key=lambda c: c.metadata.creation_timestamp)
            obj.ingress_class_name = newest.metadata.name


class ImmutableConfigAdmission(AdmissionPlugin):
    """Enforces ConfigMap/Secret immutability (validation.Validate{ConfigMap,
    Secret}Update): once immutable, payload may not change and the flag may
    not be cleared — only deletion releases the name."""

    name = "ImmutableConfig"

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource not in ("configmaps", "secrets") or operation != UPDATE:
            return
        try:
            existing = store.get(
                resource, f"{obj.metadata.namespace}/{obj.metadata.name}")
        except NotFoundError:
            return
        if not existing.immutable:
            return
        if not obj.immutable:
            raise AdmissionError(
                f"{resource[:-1]} is immutable: the flag cannot be unset",
                code=422, reason="Invalid")
        changed = existing.data != obj.data
        if resource == "configmaps":
            changed = changed or existing.binary_data != obj.binary_data
        else:
            changed = changed or existing.type != obj.type
        if changed:
            raise AdmissionError(
                f"{resource[:-1]} {obj.metadata.name!r} is immutable: "
                "data cannot be updated", code=422, reason="Invalid")


class ServiceValidation(AdmissionPlugin):
    """spec.clusterIP is immutable once set (core validation
    ValidateServiceUpdate): a mutated address would desynchronize the
    allocator and let two Services share one ClusterIP."""

    name = "ServiceValidation"

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource != "services" or operation != UPDATE:
            return
        try:
            existing = store.get(
                "services", f"{obj.metadata.namespace}/{obj.metadata.name}")
        except NotFoundError:
            return
        if existing.spec.cluster_ip and \
                obj.spec.cluster_ip != existing.spec.cluster_ip:
            raise AdmissionError("spec.clusterIP is immutable", code=422,
                                 reason="Invalid")


class CertificateSubjectRestriction(AdmissionPlugin):
    """Rejects kube-apiserver-client CSRs that request the system:masters
    group (plugin/pkg/admission/certificates/subjectrestriction) — no
    credential-issuance path may mint a cluster-admin identity."""

    name = "CertificateSubjectRestriction"

    def validate(self, store, resource, operation, obj, user="") -> None:
        if resource != "certificatesigningrequests" or operation != CREATE:
            return
        from ..api.certificates import KUBE_APISERVER_CLIENT

        if obj.signer_name == KUBE_APISERVER_CLIENT and \
                "system:masters" in (obj.request.get("groups") or []):
            raise AdmissionError(
                "use of kubernetes.io/kube-apiserver-client signer with "
                "system:masters group is not allowed")


class AdmissionChain:
    """All mutators in order, then all validators (apiserver/pkg/admission
    chainAdmissionHandler)."""

    def __init__(self, plugins: Sequence[AdmissionPlugin]):
        self.plugins = list(plugins)

    def run(self, store: APIStore, resource: str, operation: str, obj,
            user: str = "") -> None:
        for p in self.plugins:
            p.admit(store, resource, operation, obj, user)
        for p in self.plugins:
            p.validate(store, resource, operation, obj, user)


def default_admission_chain() -> AdmissionChain:
    """The default plugin set, in the reference's recommended order
    (kubeapiserver/options/plugins.go — ValidatingAdmissionPolicy just
    before ResourceQuota, ResourceQuota last)."""
    from .admissionpolicy import PolicyAdmission

    return AdmissionChain([
        MetadataDefaulter(),
        NamespaceLifecycle(),
        LimitRanger(),
        ServiceAccountAdmission(),
        PodTolerationRestriction(),
        ExtendedResourceToleration(),
        PriorityAdmission(),
        DefaultTolerationSeconds(),
        DefaultStorageClass(),
        DefaultIngressClass(),
        WorkloadValidation(),
        TaintNodesByCondition(),
        PodSecurityAdmission(),
        ImmutableConfigAdmission(),
        ServiceValidation(),
        CertificateSubjectRestriction(),
        NodeRestriction(),
        PolicyAdmission(),
        ResourceQuotaAdmission(),
    ])
