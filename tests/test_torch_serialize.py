"""The port's API serializer against the JAX package's.

Seeded manifests (numpy default_rng) of every kind the port has go through
both packages' `from_dict` and `to_dict`; the wire forms must be equal byte
for byte as `json.dumps(..., sort_keys=True)`, and `from_dict(to_dict(x))`
must be a fixed point (test_api.py and test_fuzz_roundtrip.py's property).
The template fingerprint behind the pod-template-hash and the
controller-revision-hash must equal JAX's over seeded templates, including
an annotation-only change. The kinds beyond these (services, quotas,
certificates, CRDs, admission and flow-control objects, ...) are held
against JAX in tests/test_torch_api_kinds.py, whose builders extend these.
"""

import json

import numpy as np
import pytest

import kubernetes_tpu.api.serialize as jser
import kubernetes_tpu.controllers.revision as jrev
import kubernetes_tpu_torch.api.serialize as tser
import kubernetes_tpu_torch.controllers.revision as trev
from kubernetes_tpu.api.workloads import PodTemplateSpec as JTemplate
from kubernetes_tpu_torch.api.workloads import PodTemplateSpec as TTemplate

SEEDS = (0, 1)
N_DOCS = 6


def _name(rng, prefix="o"):
    return f"{prefix}-{int(rng.integers(0, 10_000))}"


def _pick(rng, options):
    return options[int(rng.integers(0, len(options)))]


def _maybe(rng, p=0.5):
    return bool(rng.random() < p)


def _labels(rng, n_max=3):
    return {f"k{int(rng.integers(0, 6))}.io/l": f"v{int(rng.integers(0, 9))}"
            for _ in range(int(rng.integers(0, n_max + 1)))}


def _meta(rng, namespaced=True, owned=True):
    m = {"name": _name(rng), "uid": f"uid-{int(rng.integers(0, 10**6))}",
         "resourceVersion": int(rng.integers(0, 10**6))}
    if namespaced:
        m["namespace"] = _pick(rng, ["default", "team-a", "kube-system"])
    if _maybe(rng):
        m["labels"] = _labels(rng)
    if _maybe(rng):
        m["annotations"] = {"note": _name(rng, "a")}
    if _maybe(rng):
        m["generation"] = int(rng.integers(1, 9))
    if _maybe(rng):
        m["creationTimestamp"] = float(rng.integers(1, 10**6)) / 4
    if _maybe(rng, 0.2):
        m["deletionTimestamp"] = float(rng.integers(1, 10**6))
    if owned and _maybe(rng):
        m["ownerReferences"] = [{"kind": _pick(rng, ["ReplicaSet", "Job", "DaemonSet"]),
                                 "name": _name(rng), "uid": f"uid-{int(rng.integers(0, 99))}",
                                 "controller": _maybe(rng)}]
    if _maybe(rng, 0.3):
        m["finalizers"] = [_pick(rng, ["kubernetes.io/pvc-protection", "foregroundDeletion"])]
    if _maybe(rng, 0.2):
        m["managedFields"] = [{"manager": "kubectl", "operation": "Apply",
                               "fieldsType": "FieldsV1", "fieldsV1": {"f:spec": {}}}]
    return m


def _container(rng, i):
    c = {"name": f"c{i}"}
    if _maybe(rng):
        c["image"] = _pick(rng, ["nginx:1", "busybox", "registry/app:v2"])
    if _maybe(rng, 0.7):
        c["resources"] = {"requests": {"cpu": _pick(rng, ["100m", "500m", "1"]),
                                       "memory": _pick(rng, ["64Mi", "1Gi"])}}
    if _maybe(rng, 0.3):
        c["imagePullPolicy"] = _pick(rng, ["Always", "IfNotPresent", "Never"])
    if _maybe(rng, 0.3):
        c["securityContext"] = {"runAsNonRoot": True}
    if _maybe(rng, 0.3):
        c["env"] = [{"name": "A", "value": "1"}]
    if _maybe(rng, 0.2):
        c["envFrom"] = [{"configMapRef": {"name": "cfg"}}]
    if _maybe(rng, 0.3):
        c["ports"] = [{"containerPort": int(rng.integers(1, 9000)),
                       **({"hostPort": int(rng.integers(1, 9000))} if _maybe(rng) else {}),
                       "protocol": _pick(rng, ["TCP", "UDP"])}]
    return c


def _selector(rng):
    sel = {"matchLabels": {"app": _name(rng, "app")}}
    if _maybe(rng, 0.3):
        sel["matchExpressions"] = [{"key": "tier", "operator": "In", "values": ["a", "b"]}]
    return sel


def _pod_spec(rng):
    sp = {"containers": [_container(rng, i) for i in range(int(rng.integers(1, 3)))]}
    if _maybe(rng, 0.3):
        sp["initContainers"] = [_container(rng, 9)]
    if _maybe(rng, 0.3):
        sp["nodeName"] = _name(rng, "node")
    if _maybe(rng, 0.2):
        sp["schedulerName"] = "other-scheduler"
    if _maybe(rng, 0.3):
        sp["nodeSelector"] = _labels(rng, 2)
    if _maybe(rng, 0.3):
        sp["affinity"] = {
            "nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {"nodeSelectorTerms": [
                    {"matchExpressions": [{"key": "zone", "operator": "In",
                                           "values": ["z1", "z2"]}]}]},
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 5, "preference": {"matchExpressions": [
                        {"key": "disk", "operator": "Exists"}]}}]},
            "podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"topologyKey": "kubernetes.io/hostname",
                     "labelSelector": {"matchLabels": {"app": "x"}}}],
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 3, "podAffinityTerm": {
                        "topologyKey": "zone", "namespaces": ["team-a"],
                        "labelSelector": {"matchExpressions": [
                            {"key": "app", "operator": "NotIn", "values": ["y"]}]}}}]},
        }
    if _maybe(rng, 0.4):
        sp["tolerations"] = [{"key": "node.kubernetes.io/not-ready", "operator": "Exists",
                              "effect": "NoExecute",
                              **({"tolerationSeconds": int(rng.integers(0, 600))}
                                 if _maybe(rng) else {})}]
    if _maybe(rng, 0.3):
        sp["topologySpreadConstraints"] = [{
            "maxSkew": int(rng.integers(1, 4)), "topologyKey": "zone",
            "whenUnsatisfiable": _pick(rng, ["DoNotSchedule", "ScheduleAnyway"]),
            "labelSelector": {"matchLabels": {"app": "w"}},
            **({"minDomains": 2} if _maybe(rng) else {}),
            **({"matchLabelKeys": ["pod-template-hash"]} if _maybe(rng) else {})}]
    if _maybe(rng, 0.3):
        sp["priority"] = int(rng.integers(-5, 1000))
    if _maybe(rng, 0.2):
        sp["priorityClassName"] = "high"
    if _maybe(rng, 0.2):
        sp["schedulingGates"] = [{"name": "gate"}]
    if _maybe(rng, 0.2):
        sp["overhead"] = {"cpu": "10m"}
    if _maybe(rng, 0.3):
        sp["volumes"] = [
            {"name": "data", "persistentVolumeClaim": {"claimName": "pvc-1",
                                                       **({"readOnly": True} if _maybe(rng)
                                                          else {})}},
            {"name": "cfg", "configMap": {"name": "cfg", "optional": True}},
            {"name": "sec", "secret": {"secretName": "s"}},
            {"name": "hp", "hostPath": {"path": "/var/x"}},
            {"name": "pd", "gcePersistentDisk": {"pdName": "disk-1"}},
            {"name": "eph", "ephemeral": {"volumeClaimTemplate": {}}},
        ][: int(rng.integers(1, 7))]
    if _maybe(rng, 0.2):
        sp["resourceClaims"] = [{"name": "gpu", "resourceClaimName": "claim-1"},
                                {"name": "tpl", "resourceClaimTemplateName": "tmpl-1"}]
    if _maybe(rng, 0.2):
        sp["serviceAccountName"] = "builder"
    if _maybe(rng, 0.3):
        sp["restartPolicy"] = _pick(rng, ["Always", "OnFailure", "Never"])
    if _maybe(rng, 0.2):
        sp["terminationGracePeriodSeconds"] = int(rng.integers(1, 120))
    if _maybe(rng, 0.2):
        sp["preemptionPolicy"] = "Never"
    for k in ("hostNetwork", "hostPID", "hostIPC"):
        if _maybe(rng, 0.15):
            sp[k] = True
    if _maybe(rng, 0.2):
        sp["securityContext"] = {"runAsUser": 1000}
    return sp


def _template(rng):
    t = {"metadata": {"labels": {"app": _name(rng, "app"), **_labels(rng, 2)}},
         "spec": _pod_spec(rng)}
    if _maybe(rng, 0.3):
        t["metadata"]["annotations"] = {"kubectl.kubernetes.io/restartedAt": _name(rng, "t")}
    return t


def _pod(rng):
    d = {"kind": "Pod", "metadata": _meta(rng), "spec": _pod_spec(rng)}
    st = {"phase": _pick(rng, ["Pending", "Running", "Succeeded", "Failed"])}
    if _maybe(rng, 0.3):
        st["nominatedNodeName"] = _name(rng, "node")
    if _maybe(rng, 0.3):
        st["conditions"] = [{"type": "PodScheduled", "status": "False",
                             "reason": "Unschedulable", "message": "0/3 nodes",
                             "lastTransitionTime": float(rng.integers(1, 999))}]
    if _maybe(rng, 0.2):
        st["resourceClaimStatuses"] = [{"name": "tpl", "resourceClaimName": "p-tpl"}]
    d["status"] = st
    return d


def _node(rng):
    d = {"kind": "Node", "metadata": _meta(rng, namespaced=False, owned=False)}
    sp = {}
    if _maybe(rng, 0.3):
        sp["unschedulable"] = True
    if _maybe(rng, 0.5):
        sp["taints"] = [{"key": "node.kubernetes.io/not-ready", "effect": "NoExecute"},
                        {"key": "dedicated", "value": "gpu", "effect": "NoSchedule"}]
    d["spec"] = sp
    st = {"capacity": {"cpu": "8", "memory": "32Gi", "pods": "110"},
          "allocatable": {"cpu": "7", "memory": "30Gi", "pods": "110"}}
    if _maybe(rng, 0.3):
        st["images"] = [{"names": ["nginx:1"], "sizeBytes": int(rng.integers(1, 10**9))}]
    if _maybe(rng, 0.5):
        st["conditions"] = [{"type": "Ready", "status": _pick(rng, ["True", "False"]),
                             **({"reason": "KubeletReady"} if _maybe(rng) else {}),
                             "lastHeartbeatTime": float(rng.integers(1, 999))}]
    d["status"] = st
    return d


def _rs(rng):
    return {"kind": "ReplicaSet", "metadata": _meta(rng),
            "spec": {"replicas": int(rng.integers(0, 9)), "selector": _selector(rng),
                     "template": _template(rng)}}


def _deployment(rng):
    sp = {"replicas": int(rng.integers(0, 12)), "selector": _selector(rng),
          "template": _template(rng)}
    if _maybe(rng, 0.3):
        sp["strategy"] = {"type": "Recreate"}
    elif _maybe(rng):
        sp["strategy"] = {"type": "RollingUpdate",
                          "rollingUpdate": {"maxSurge": int(rng.integers(0, 5)),
                                            "maxUnavailable": int(rng.integers(0, 5))}}
    return {"kind": "Deployment", "metadata": _meta(rng), "spec": sp}


def _job_spec(rng):
    sp = {"template": _template(rng)}
    if _maybe(rng):
        sp["parallelism"] = int(rng.integers(0, 5))
    if _maybe(rng):
        sp["completions"] = int(rng.integers(1, 9))
    if _maybe(rng):
        sp["backoffLimit"] = int(rng.integers(0, 7))
    if _maybe(rng, 0.3):
        sp["activeDeadlineSeconds"] = int(rng.integers(1, 600))
    if _maybe(rng, 0.3):
        sp["completionMode"] = "Indexed"
    if _maybe(rng, 0.3):
        sp["selector"] = _selector(rng)
    if _maybe(rng, 0.2):
        sp["suspend"] = True
    if _maybe(rng, 0.3):
        sp["ttlSecondsAfterFinished"] = int(rng.integers(0, 100))
    return sp


def _job(rng):
    d = {"kind": "Job", "metadata": _meta(rng), "spec": _job_spec(rng)}
    if _maybe(rng):
        d["status"] = {"active": int(rng.integers(0, 3)), "succeeded": int(rng.integers(0, 3)),
                       "failed": int(rng.integers(0, 3)),
                       **({"conditions": [{"type": "Complete", "status": "True"}]}
                          if _maybe(rng) else {}),
                       **({"completedIndexes": "0-2,5"} if _maybe(rng) else {})}
    return d


def _cronjob(rng):
    sp = {"schedule": _pick(rng, ["*/5 * * * *", "0 3 * * 1-5", "@hourly"]),
          "jobTemplate": {"spec": _job_spec(rng)}}
    if _maybe(rng):
        sp["timeZone"] = _pick(rng, ["Europe/Berlin", "America/New_York"])
    if _maybe(rng):
        sp["concurrencyPolicy"] = _pick(rng, ["Allow", "Forbid", "Replace"])
    if _maybe(rng, 0.2):
        sp["suspend"] = True
    if _maybe(rng, 0.3):
        sp["startingDeadlineSeconds"] = int(rng.integers(1, 300))
    if _maybe(rng):
        sp["successfulJobsHistoryLimit"] = int(rng.integers(0, 5))
        sp["failedJobsHistoryLimit"] = int(rng.integers(0, 5))
    return {"kind": "CronJob", "metadata": _meta(rng), "spec": sp}


def _statefulset(rng):
    sp = {"replicas": int(rng.integers(0, 6)), "selector": _selector(rng),
          "serviceName": _name(rng, "svc"), "template": _template(rng)}
    if _maybe(rng):
        sp["podManagementPolicy"] = "Parallel"
    if _maybe(rng):
        sp["volumeClaimTemplates"] = [{"metadata": {"name": "data"}, "spec": {
            "accessModes": ["ReadWriteOnce"],
            "resources": {"requests": {"storage": "1Gi"}}}}]
    if _maybe(rng):
        sp["updateStrategy"] = {"type": _pick(rng, ["RollingUpdate", "OnDelete"]),
                                "rollingUpdate": {"partition": int(rng.integers(0, 3))}}
    return {"kind": "StatefulSet", "metadata": _meta(rng), "spec": sp}


def _daemonset(rng):
    sp = {"selector": _selector(rng), "template": _template(rng)}
    if _maybe(rng):
        sp["updateStrategy"] = {"type": _pick(rng, ["RollingUpdate", "OnDelete"]),
                                "rollingUpdate": {"maxUnavailable": int(rng.integers(1, 4))}}
    return {"kind": "DaemonSet", "metadata": _meta(rng), "spec": sp}


def _lease(rng):
    return {"kind": "Lease", "metadata": _meta(rng, owned=False), "spec": {
        "holderIdentity": _name(rng, "node"), "leaseDurationSeconds": int(rng.integers(1, 60)),
        "acquireTime": float(rng.integers(0, 999)),
        "renewTime": _pick(rng, [float(rng.integers(0, 999)), "2026-01-02T03:04:05Z"])}}


def _namespace(rng):
    return {"kind": "Namespace", "metadata": _meta(rng, namespaced=False, owned=False)}


def _pdb(rng):
    sp = {"selector": _selector(rng)}
    if _maybe(rng):
        sp["minAvailable"] = _pick(rng, [int(rng.integers(0, 5)), "50%"])
    else:
        sp["maxUnavailable"] = _pick(rng, [int(rng.integers(0, 5)), "10%"])
    return {"kind": "PodDisruptionBudget", "metadata": _meta(rng, owned=False), "spec": sp,
            "status": {"disruptionsAllowed": int(rng.integers(0, 4))}}


def _event(rng):
    return {"kind": "Event", "metadata": _meta(rng, owned=False),
            "involvedObject": {"kind": "Pod", "name": _name(rng, "p"), "namespace": "default"},
            "reason": _pick(rng, ["FailedScheduling", "Preempted", "Killing"]),
            "message": _name(rng, "m"), "type": _pick(rng, ["Normal", "Warning"]),
            "count": int(rng.integers(1, 9)),
            **({"source": {"component": "default-scheduler"}} if _maybe(rng) else {}),
            **({"firstTimestamp": float(rng.integers(1, 99)),
                "lastTimestamp": float(rng.integers(100, 199))} if _maybe(rng) else {})}


def _podgroup(rng):
    d = {"kind": "PodGroup", "metadata": _meta(rng, owned=False),
         "spec": {"minMember": int(rng.integers(1, 9))}}
    if _maybe(rng):
        d["status"] = {"phase": _pick(rng, ["Pending", "Running"]),
                       "scheduled": int(rng.integers(0, 9))}
    return d


def _pv(rng):
    sp = {"capacity": {"storage": _pick(rng, ["1Gi", "10Gi"])},
          "accessModes": ["ReadWriteOnce"], "storageClassName": _pick(rng, ["", "fast"]),
          "csi": {"driver": "ebs.csi", "volumeHandle": _name(rng, "vol")}}
    if _maybe(rng):
        sp["claimRef"] = {"namespace": "default", "name": _name(rng, "pvc")}
    if _maybe(rng):
        sp["nodeAffinity"] = {"required": {"nodeSelectorTerms": [{"matchExpressions": [
            {"key": "zone", "operator": "In", "values": ["z1"]}]}]}}
    if _maybe(rng, 0.3):
        sp["persistentVolumeReclaimPolicy"] = "Retain"
    return {"kind": "PersistentVolume", "metadata": _meta(rng, namespaced=False, owned=False),
            "spec": sp, **({"status": {"phase": "Bound"}} if _maybe(rng) else {})}


def _pvc(rng):
    sp = {"accessModes": ["ReadWriteOnce"],
          "resources": {"requests": {"storage": _pick(rng, ["1Gi", "5Gi"])}}}
    if _maybe(rng):
        sp["storageClassName"] = _pick(rng, ["", "fast"])
    if _maybe(rng):
        sp["volumeName"] = _name(rng, "pv")
    return {"kind": "PersistentVolumeClaim", "metadata": _meta(rng), "spec": sp,
            **({"status": {"phase": "Bound"}} if _maybe(rng) else {})}


def _storageclass(rng):
    d = {"kind": "StorageClass", "metadata": _meta(rng, namespaced=False, owned=False),
         "provisioner": "ebs.csi",
         "volumeBindingMode": _pick(rng, ["Immediate", "WaitForFirstConsumer"])}
    if _maybe(rng):
        d["allowedTopologies"] = [{"matchLabelExpressions": [
            {"key": "zone", "values": ["z1", "z2"]}]}]
    if _maybe(rng):
        d["metadata"]["annotations"] = {"storageclass.kubernetes.io/is-default-class": "true"}
    return d


def _csinode(rng):
    return {"kind": "CSINode", "metadata": _meta(rng, namespaced=False, owned=False),
            "spec": {"drivers": [{"name": "ebs.csi",
                                  **({"allocatable": {"count": int(rng.integers(1, 40))}}
                                     if _maybe(rng) else {})}]}}


def _claim(rng):
    d = {"kind": "ResourceClaim", "metadata": _meta(rng),
         "spec": {"devices": {"requests": [
             {"name": "gpu", "deviceClassName": "gpu.example.com",
              "count": int(rng.integers(1, 4)),
              **({"selectors": [{"key": "mem", "op": ">=", "value": 16}]}
                 if _maybe(rng) else {})}]}}}
    if _maybe(rng):
        d["status"] = {"allocation": {"nodeName": _name(rng, "node"),
                                      "devices": {"gpu": ["gpu-0"]}},
                       "reservedFor": [{"name": _name(rng, "p")}]}
    return d


def _slice(rng):
    return {"kind": "ResourceSlice", "metadata": _meta(rng, namespaced=False, owned=False),
            "spec": {"nodeName": _name(rng, "node"), "driver": "gpu.example.com",
                     "pool": {"name": "pool-a"},
                     "devices": [{"name": f"gpu-{i}", "basic": {
                         "attributes": {"mem": int(rng.integers(8, 80))},
                         "capacity": {"memory": "16Gi"}}} for i in range(2)]}}


def _deviceclass(rng):
    return {"kind": "DeviceClass", "metadata": _meta(rng, namespaced=False, owned=False),
            "spec": {"selectors": [{"key": "vendor", "op": "==", "value": "acme"}]}}


BUILDERS = {
    "pods": _pod, "nodes": _node, "namespaces": _namespace, "replicasets": _rs,
    "deployments": _deployment, "statefulsets": _statefulset, "daemonsets": _daemonset,
    "jobs": _job, "cronjobs": _cronjob, "leases": _lease, "poddisruptionbudgets": _pdb,
    "events": _event, "podgroups": _podgroup, "persistentvolumes": _pv,
    "persistentvolumeclaims": _pvc, "storageclasses": _storageclass, "csinodes": _csinode,
    "resourceclaims": _claim, "resourceslices": _slice, "deviceclasses": _deviceclass,
}


def _docs(resource, seed):
    rng = np.random.default_rng([seed, sorted(BUILDERS).index(resource)])
    return [BUILDERS[resource](rng) for _ in range(N_DOCS)]


def _wire(ser, obj):
    return json.dumps(ser.to_dict(obj), sort_keys=True)


def test_every_ported_resource_has_a_builder():
    from test_torch_api_kinds import BUILDERS as ALL_BUILDERS

    assert set(BUILDERS) < set(ALL_BUILDERS) == set(tser.RESOURCE_TO_TYPE)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("resource", sorted(BUILDERS))
def test_to_dict_matches_jax_and_round_trips(resource, seed):
    for doc in _docs(resource, seed):
        want = _wire(jser, jser.from_dict(resource, doc))
        got = _wire(tser, tser.from_dict(resource, doc))
        assert got == want, f"{resource}: {doc}"
        # from_dict(to_dict(x)) is a fixed point, as in the JAX package
        again = _wire(tser, tser.from_dict(resource, json.loads(got)))
        assert again == got
        assert _wire(jser, jser.from_dict(resource, json.loads(want))) == again


def test_tables_match_jax_for_the_ported_kinds():
    ported = set(tser.RESOURCE_TO_TYPE)
    assert ported == set(jser.RESOURCE_TO_TYPE)
    assert tser.KIND_TO_RESOURCE == jser.KIND_TO_RESOURCE
    assert tser.GROUP_PREFIX == jser.GROUP_PREFIX
    assert tser.CLUSTER_SCOPED == jser.CLUSTER_SCOPED
    for resource, t in tser.RESOURCE_TO_TYPE.items():
        assert t.__name__ == jser.RESOURCE_TO_TYPE[resource].__name__
        assert tser.KIND_TO_RESOURCE[t.kind] == resource


def test_unknown_resource_and_object_raise_as_in_jax():
    with pytest.raises(KeyError):
        tser.from_dict("widgets", {})
    for ser in (jser, tser):
        with pytest.raises(ValueError, match="cannot serialize object"):
            ser.to_dict(object())


def _fingerprints(rev, template_cls, docs):
    return [rev.template_fingerprint(template_cls.from_dict(d)) for d in docs]


@pytest.mark.parametrize("seed", SEEDS)
def test_template_fingerprint_matches_jax(seed):
    rng = np.random.default_rng([seed, 99])
    docs = [_template(rng) for _ in range(12)]
    want = _fingerprints(jrev, JTemplate, docs)
    assert _fingerprints(trev, TTemplate, docs) == want
    assert len(set(want)) == len(want)  # distinct templates, distinct hashes
    names = [trev.revision_name("web", TTemplate.from_dict(d)) for d in docs]
    assert names == [jrev.revision_name("web", JTemplate.from_dict(d)) for d in docs]
    assert trev.REVISION_LABEL == jrev.REVISION_LABEL


def test_annotation_only_change_moves_the_fingerprint_as_in_jax():
    """A rollout restart patches only a template annotation
    (tests/test_workload_controllers.py's case): the hash must change, and
    equally in both packages; dict key order must not."""
    base = {"metadata": {"labels": {"app": "web", "tier": "fe"}},
            "spec": {"containers": [{"name": "c", "image": "v1"}]}}
    restarted = json.loads(json.dumps(base))
    restarted["metadata"]["annotations"] = {
        "kubectl.kubernetes.io/restartedAt": "2026-01-01T00:00:00Z"}
    reordered = {"spec": base["spec"],
                 "metadata": {"labels": {"tier": "fe", "app": "web"}}}
    got = _fingerprints(trev, TTemplate, [base, restarted, reordered])
    assert got == _fingerprints(jrev, JTemplate, [base, restarted, reordered])
    assert got[0] != got[1] and got[0] == got[2]
