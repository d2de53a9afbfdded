"""The port's API kinds and serializer against the JAX package's, every kind.

Seeded manifests (numpy default_rng) of each of the 46 resources of the JAX
package's RESOURCE_TO_TYPE go through both packages' `from_dict` and
`to_dict`: the wire forms must be equal byte for byte as
`json.dumps(..., sort_keys=True)`, and `from_dict(to_dict(x))` must be a
fixed point (test_api.py and test_fuzz_roundtrip.py's property). The
builders of the kinds tests/test_torch_serialize.py already covers are
reused; the others cover each kind's optional fields. Beside them: the four
tables, the structural-schema cases of tests/test_crd.py and the
DynamicRegistry, the pod-log channel's trimming, and the flow-control
objects' dispatch builders, which raise until the server is ported.
"""

import json

import numpy as np
import pytest

import kubernetes_tpu.api.crd as jcrd
import kubernetes_tpu.api.events as jevents
import kubernetes_tpu.api.flowcontrolapi as jflow
import kubernetes_tpu.api.serialize as jser
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.crd as tcrd
import kubernetes_tpu_torch.api.events as tevents
import kubernetes_tpu_torch.api.flowcontrolapi as tflow
import kubernetes_tpu_torch.api.serialize as tser
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu.store import APIStore as JStore
from kubernetes_tpu_torch.store import APIStore as TStore
from kubernetes_tpu_torch.testing import normalized_dump
from test_torch_serialize import BUILDERS as CORE_BUILDERS
from test_torch_serialize import SEEDS, _labels, _maybe, _meta, _name, _pick

N_DOCS = 6


def _port(rng, named=True):
    p = {"port": int(rng.integers(1, 65536)), "protocol": _pick(rng, ["TCP", "UDP"])}
    if named and _maybe(rng):
        p["name"] = _name(rng, "port")
    return p


def _service(rng):
    spec = {"ports": [{**_port(rng), **({"targetPort": int(rng.integers(1, 9000))}
                                        if _maybe(rng) else {}),
                       **({"nodePort": int(rng.integers(30000, 32768))}
                          if _maybe(rng, 0.3) else {})}
                      for _ in range(int(rng.integers(0, 3)))],
            "type": _pick(rng, ["ClusterIP", "NodePort", "LoadBalancer"])}
    if _maybe(rng):
        spec["selector"] = {"app": _name(rng, "app")}
    if _maybe(rng):
        spec["clusterIP"] = f"10.96.{int(rng.integers(0, 255))}.{int(rng.integers(1, 255))}"
    if _maybe(rng, 0.2):
        spec.update(type="ExternalName", externalName="db.example.com")
    if _maybe(rng, 0.3):
        spec["sessionAffinity"] = "ClientIP"
    return {"kind": "Service", "metadata": _meta(rng), "spec": spec}


def _endpointslice(rng):
    eps = []
    for _ in range(int(rng.integers(0, 4))):
        e = {"addresses": [f"10.{int(rng.integers(0, 255))}.0.{int(rng.integers(1, 255))}"],
             "conditions": {"ready": _maybe(rng)}}
        if _maybe(rng):
            e["nodeName"] = _name(rng, "node")
        if _maybe(rng):
            e["targetRef"] = {"kind": "Pod", "name": _name(rng, "p"),
                              **({"namespace": "team-a"} if _maybe(rng) else {})}
        eps.append(e)
    return {"kind": "EndpointSlice", "metadata": _meta(rng),
            "addressType": _pick(rng, ["IPv4", "IPv6"]), "endpoints": eps,
            "ports": [_port(rng) for _ in range(int(rng.integers(0, 3)))]}


def _resourcequota(rng):
    hard = {k: v for k, v in (("requests.cpu", "40"), ("requests.memory", "64Gi"),
                              ("pods", "100"), ("count/services", "5"))
            if _maybe(rng, 0.7)}
    d = {"kind": "ResourceQuota", "metadata": _meta(rng), "spec": {"hard": hard}}
    if _maybe(rng):
        d["status"] = {"used": {k: f"{int(rng.integers(0, 9))}" for k in hard}}
    return d


def _limitrange(rng):
    limits = []
    for typ in ("Container", "Pod"):
        if not _maybe(rng, 0.7):
            continue
        item = {"type": typ}
        for key in ("default", "defaultRequest", "max", "min"):
            if _maybe(rng):
                item[key] = {"cpu": _pick(rng, ["100m", "1", "2"]),
                             **({"memory": "1Gi"} if _maybe(rng) else {})}
        limits.append(item)
    return {"kind": "LimitRange", "metadata": _meta(rng), "spec": {"limits": limits}}


def _hpa(rng):
    spec = {"scaleTargetRef": {"kind": _pick(rng, ["Deployment", "ReplicaSet",
                                                   "StatefulSet"]),
                               "name": _name(rng, "web")},
            "minReplicas": int(rng.integers(1, 4)), "maxReplicas": int(rng.integers(4, 20))}
    if _maybe(rng):
        spec["metrics"] = [{"type": "Resource", "resource": {
            "name": "cpu", "target": {"type": "Utilization",
                                      "averageUtilization": int(rng.integers(10, 90))}}}]
    elif _maybe(rng):
        spec["targetCPUUtilizationPercentage"] = int(rng.integers(10, 90))
    d = {"kind": "HorizontalPodAutoscaler", "metadata": _meta(rng), "spec": spec}
    if _maybe(rng):
        d["status"] = {"currentReplicas": int(rng.integers(0, 9)),
                       "desiredReplicas": int(rng.integers(0, 9))}
    return d


def _priorityclass(rng):
    d = {"kind": "PriorityClass", "metadata": _meta(rng, namespaced=False, owned=False),
         "value": int(rng.integers(-100, 10**6))}
    if _maybe(rng, 0.3):
        d["globalDefault"] = True
    if _maybe(rng, 0.3):
        d["preemptionPolicy"] = "Never"
    if _maybe(rng):
        d["description"] = _name(rng, "tier")
    return d


def _serviceaccount(rng):
    d = {"kind": "ServiceAccount", "metadata": _meta(rng)}
    if _maybe(rng):
        d["secrets"] = [{"name": _name(rng, "token")}]
    if _maybe(rng, 0.3):
        d["automountServiceAccountToken"] = False
    return d


def _crd(rng):
    plural = _name(rng, "widgets")
    group = _pick(rng, ["batch.tpu.dev", "example.com"])
    names = {"plural": plural, "kind": "Widget"}
    if _maybe(rng):
        names["singular"] = "widget"
    if _maybe(rng):
        names["shortNames"] = ["wd"]
    if _maybe(rng, 0.3):
        names["listKind"] = "WidgetList"
    versions = [{"name": "v1", "served": True, "storage": True}]
    if _maybe(rng):
        versions[0]["schema"] = {"openAPIV3Schema": {
            "type": "object", "properties": {"spec": {"type": "object", "properties": {
                "replicas": {"type": "integer", "minimum": int(rng.integers(0, 3))}}}}}}
    if _maybe(rng, 0.3):
        versions.append({"name": "v1beta1", "served": _maybe(rng), "storage": False})
    meta = _meta(rng, namespaced=False, owned=False)
    meta["name"] = f"{plural}.{group}"
    return {"kind": "CustomResourceDefinition", "metadata": meta,
            "spec": {"group": group, "scope": _pick(rng, ["Namespaced", "Cluster"]),
                     "names": names, "versions": versions}}


def _csr(rng):
    spec = {"request": {"user": f"system:node:{_name(rng, 'n')}", "groups": ["system:nodes"]},
            "signerName": _pick(rng, ["kubernetes.io/kube-apiserver-client-kubelet",
                                      "kubernetes.io/kube-apiserver-client",
                                      "example.com/agent"])}
    if _maybe(rng):
        spec["usages"] = ["client auth", "digital signature"]
    if _maybe(rng):
        spec["expirationSeconds"] = int(rng.integers(600, 86400))
    if _maybe(rng):
        spec["username"] = "system:bootstrap:abc"
        spec["groups"] = ["system:bootstrappers"]
    d = {"kind": "CertificateSigningRequest",
         "metadata": _meta(rng, namespaced=False, owned=False), "spec": spec}
    if _maybe(rng):
        d["status"] = {"conditions": [{"type": _pick(rng, ["Approved", "Denied", "Failed"]),
                                       **({"reason": "AutoApproved"} if _maybe(rng) else {}),
                                       **({"message": "ok"} if _maybe(rng) else {}),
                                       **({"lastUpdateTime": float(rng.integers(1, 10**6))}
                                          if _maybe(rng) else {})}]}
        if _maybe(rng):
            d["status"]["certificate"] = _name(rng, "tok")
    return d


def _apiservice(rng):
    group = _pick(rng, ["metrics.k8s.io", "custom.example.com"])
    meta = _meta(rng, namespaced=False, owned=False)
    if _maybe(rng, 0.3):
        meta.pop("name")
    spec = {"group": group, "version": _pick(rng, ["v1", "v1beta1"])}
    if _maybe(rng):
        spec["service"] = {"url": f"http://127.0.0.1:{int(rng.integers(1024, 65535))}"}
    if _maybe(rng):
        spec["groupPriorityMinimum"] = int(rng.integers(1, 20000))
    d = {"kind": "APIService", "metadata": meta, "spec": spec}
    if _maybe(rng):
        d["status"] = {"conditions": [{"type": "Available",
                                       "status": _pick(rng, ["True", "False"]),
                                       **({"message": "unreachable"} if _maybe(rng) else {})}]}
    return d


def _volumeattachment(rng):
    d = {"kind": "VolumeAttachment", "metadata": _meta(rng, namespaced=False),
         "spec": {"attacher": _pick(rng, ["csi.example.com", "kubernetes.io/in-tree"]),
                  "nodeName": _name(rng, "node"),
                  "source": {"persistentVolumeName": _name(rng, "pv")}}}
    if _maybe(rng):
        d["status"] = {"attached": _maybe(rng)}
    return d


def _claimtemplate(rng):
    reqs = [{"name": f"r{i}", "deviceClassName": "gpu.example.com",
             "count": int(rng.integers(1, 4)),
             **({"selectors": [{"key": "mem", "op": ">=", "value": int(rng.integers(8, 80))}]}
                if _maybe(rng) else {})}
            for i in range(int(rng.integers(1, 3)))]
    spec = {"devices": {"requests": reqs}}
    return {"kind": "ResourceClaimTemplate", "metadata": _meta(rng),
            "spec": {"spec": spec} if _maybe(rng) else spec}


def _podlog(rng):
    return {"kind": "PodLog", "metadata": _meta(rng),
            "entries": [f"{float(rng.integers(0, 10**5)):.3f} [c] line {i}"
                        for i in range(int(rng.integers(0, 5)))]}


def _podexec(rng):
    st = {"done": _maybe(rng)}
    for key in ("stdout", "stdoutB64", "stderr", "error"):
        if _maybe(rng):
            st[key] = _name(rng, key)
    if _maybe(rng):
        st["exitCode"] = int(rng.integers(0, 3))
    spec = {"podName": _name(rng, "p"), "container": "c",
            "command": [_pick(rng, ["ls", "cat", "__attach__"]), "-l"]}
    if _maybe(rng):
        spec["stdin"] = "input"
    if _maybe(rng, 0.3):
        spec["tty"] = True
    return {"kind": "PodExec", "metadata": _meta(rng), "spec": spec, "status": st}


def _podportforward(rng):
    spec = {"podName": _name(rng, "p"), "port": int(rng.integers(1, 65536))}
    if _maybe(rng):
        spec["data"] = "aGVsbG8="
    st = {"done": _maybe(rng)}
    if _maybe(rng):
        st["data"] = "d29ybGQ="
    if _maybe(rng, 0.3):
        st["error"] = "connection refused"
    return {"kind": "PodPortForward", "metadata": _meta(rng), "spec": spec, "status": st}


def _configmap(rng):
    d = {"kind": "ConfigMap", "metadata": _meta(rng)}
    if _maybe(rng):
        d["data"] = {"a.conf": _name(rng, "v"), "n": int(rng.integers(0, 9))}
    if _maybe(rng):
        d["binaryData"] = {"blob": "AAEC"}
    if _maybe(rng, 0.3):
        d["immutable"] = True
    return d


def _secret(rng):
    d = {"kind": "Secret", "metadata": _meta(rng)}
    if _maybe(rng):
        d["type"] = _pick(rng, ["Opaque", "kubernetes.io/service-account-token"])
    if _maybe(rng):
        d["data"] = {"user": "YWRtaW4=", "k": "dg=="}
    if _maybe(rng):
        d["stringData"] = {"k": _name(rng, "plain"), "token": "s3cr3t"}
    if _maybe(rng, 0.3):
        d["immutable"] = True
    return d


def _ingress(rng):
    spec = {}
    if _maybe(rng):
        spec["ingressClassName"] = _pick(rng, ["nginx", ""])
    if _maybe(rng):
        spec["rules"] = [{**({"host": "a.example.com"} if _maybe(rng) else {}),
                          "http": {"paths": [
                              {"path": _pick(rng, ["/", "/api"]),
                               "pathType": _pick(rng, ["Prefix", "Exact"]),
                               "backend": {"service": {"name": _name(rng, "svc"),
                                                       "port": {"number": 80}}}}
                              for _ in range(int(rng.integers(1, 3)))]}}]
    if _maybe(rng):
        spec["defaultBackend"] = {"service": {"name": "fallback"}}
    return {"kind": "Ingress", "metadata": _meta(rng), "spec": spec}


def _ingressclass(rng):
    meta = _meta(rng, namespaced=False, owned=False)
    if _maybe(rng):
        meta.setdefault("annotations", {})["ingressclass.kubernetes.io/is-default-class"] = "true"
    return {"kind": "IngressClass", "metadata": meta,
            "spec": {"controller": _pick(rng, ["k8s.io/ingress-nginx", "example.com/lb"])}}


def _networkpolicy(rng):
    spec = {"podSelector": {"matchLabels": _labels(rng)} if _maybe(rng) else {}}
    if _maybe(rng):
        spec["policyTypes"] = ["Ingress"] + (["Egress"] if _maybe(rng) else [])
    if _maybe(rng):
        spec["ingress"] = [{"from": [{"podSelector": {"matchLabels": {"role": "fe"}}}],
                            "ports": [{"protocol": "TCP", "port": 6379}]}]
    if _maybe(rng):
        spec["egress"] = [{"to": [{"ipBlock": {"cidr": "10.0.0.0/24"}}]}]
    return {"kind": "NetworkPolicy", "metadata": _meta(rng), "spec": spec}


def _prioritylevel(rng):
    spec = {"type": _pick(rng, ["Limited", "Limited", "Exempt"])}
    if spec["type"] == "Limited" and _maybe(rng, 0.7):
        spec["limited"] = {k: v for k, v in (("seats", int(rng.integers(0, 40))),
                                             ("queueLength", int(rng.integers(0, 100))),
                                             ("queueTimeoutSeconds",
                                              float(rng.integers(0, 20)) / 2))
                           if _maybe(rng, 0.7)}
    return {"kind": "PriorityLevelConfiguration",
            "metadata": _meta(rng, namespaced=False, owned=False), "spec": spec}


def _flowschema(rng):
    spec = {"priorityLevelConfiguration": {"name": _pick(rng, ["workload-low", "exempt"])},
            "matchingPrecedence": int(rng.integers(1, 10000))}
    for key in ("users", "groups", "verbs", "resources"):
        if _maybe(rng, 0.6):
            spec[key] = [_pick(rng, ["*", "system:nodes", "get", "pods"])
                         for _ in range(int(rng.integers(0, 3)))]
    return {"kind": "FlowSchema", "metadata": _meta(rng, namespaced=False, owned=False),
            "spec": spec}


def _rules(rng):
    return [{"resources": [_pick(rng, ["pods", "*", "deployments"])],
             **({"operations": [_pick(rng, ["CREATE", "UPDATE", "*"])]} if _maybe(rng) else {})}
            for _ in range(int(rng.integers(0, 3)))]


def _vap(rng):
    spec = {"matchConstraints": {"resourceRules": _rules(rng)},
            "validations": [{"expression": "object.spec.replicas <= 5",
                             **({"message": "too many"} if _maybe(rng) else {}),
                             **({"reason": "Invalid"} if _maybe(rng) else {})}
                            for _ in range(int(rng.integers(0, 3)))]}
    if _maybe(rng):
        spec["failurePolicy"] = _pick(rng, ["Fail", "Ignore"])
    return {"kind": "ValidatingAdmissionPolicy",
            "metadata": _meta(rng, namespaced=False, owned=False), "spec": spec}


def _vapbinding(rng):
    spec = {"policyName": _name(rng, "policy")}
    if _maybe(rng):
        spec["matchResources"] = {"namespaceSelector": {"matchLabels": {"env": "prod"}}}
    if _maybe(rng):
        spec["validationActions"] = [_pick(rng, ["Deny", "Warn", "Audit"])]
    return {"kind": "ValidatingAdmissionPolicyBinding",
            "metadata": _meta(rng, namespaced=False, owned=False), "spec": spec}


def _webhooks(kind):
    def build(rng):
        return {"kind": kind, "metadata": _meta(rng, namespaced=False, owned=False),
                "webhooks": [{"name": f"w{i}.example.com",
                              "clientConfig": {"url": f"https://127.0.0.1:{9443 + i}/hook"},
                              "rules": _rules(rng),
                              **({"failurePolicy": "Ignore"} if _maybe(rng) else {}),
                              **({"timeoutSeconds": int(rng.integers(1, 30))}
                                 if _maybe(rng) else {})}
                             for i in range(int(rng.integers(0, 3)))]}
    return build


BUILDERS = {
    **CORE_BUILDERS,
    "services": _service, "endpointslices": _endpointslice, "resourcequotas": _resourcequota,
    "limitranges": _limitrange, "horizontalpodautoscalers": _hpa,
    "priorityclasses": _priorityclass, "serviceaccounts": _serviceaccount,
    "customresourcedefinitions": _crd, "certificatesigningrequests": _csr,
    "apiservices": _apiservice, "volumeattachments": _volumeattachment,
    "resourceclaimtemplates": _claimtemplate, "podlogs": _podlog, "podexecs": _podexec,
    "podportforwards": _podportforward, "configmaps": _configmap, "secrets": _secret,
    "ingresses": _ingress, "ingressclasses": _ingressclass,
    "networkpolicies": _networkpolicy, "prioritylevelconfigurations": _prioritylevel,
    "flowschemas": _flowschema, "validatingadmissionpolicies": _vap,
    "validatingadmissionpolicybindings": _vapbinding,
    "mutatingwebhookconfigurations": _webhooks("MutatingWebhookConfiguration"),
    "validatingwebhookconfigurations": _webhooks("ValidatingWebhookConfiguration"),
}


def _wire(ser, obj):
    return json.dumps(ser.to_dict(obj), sort_keys=True)


def test_every_jax_resource_has_a_builder():
    assert set(BUILDERS) == set(jser.RESOURCE_TO_TYPE) == set(tser.RESOURCE_TO_TYPE)


@pytest.mark.parametrize("resource", sorted(jser.RESOURCE_TO_TYPE))
def test_every_kind_to_dict_matches_jax_and_round_trips(resource):
    """Both seeds' documents of one resource: equal wire forms, and
    from_dict(to_dict(x)) a fixed point in both packages."""
    for seed in SEEDS:
        rng = np.random.default_rng([seed, sorted(BUILDERS).index(resource), 19])
        for _ in range(N_DOCS):
            doc = BUILDERS[resource](rng)
            want = _wire(jser, jser.from_dict(resource, doc))
            got = _wire(tser, tser.from_dict(resource, doc))
            assert got == want, f"{resource}: {doc}"
            again = _wire(tser, tser.from_dict(resource, json.loads(got)))
            assert again == got
            assert _wire(jser, jser.from_dict(resource, json.loads(want))) == again


def test_tables_equal_jax_entry_for_entry():
    assert tser.KIND_TO_RESOURCE == jser.KIND_TO_RESOURCE
    assert tser.CLUSTER_SCOPED == jser.CLUSTER_SCOPED
    assert tser.GROUP_PREFIX == jser.GROUP_PREFIX
    assert list(tser.RESOURCE_TO_TYPE) == list(jser.RESOURCE_TO_TYPE)
    for resource, t in tser.RESOURCE_TO_TYPE.items():
        assert t.__name__ == jser.RESOURCE_TO_TYPE[resource].__name__
        assert t.__module__.replace("kubernetes_tpu_torch", "kubernetes_tpu") \
            == jser.RESOURCE_TO_TYPE[resource].__module__
        assert tser.resource_type(resource) is t
    with pytest.raises(KeyError):
        tser.resource_type("widgets")


# -- structural schemas (tests/test_crd.py TestSchema) --------------------------------

TPUJOB = {
    "type": "object", "required": ["spec"],
    "properties": {
        "spec": {"type": "object", "required": ["replicas"], "properties": {
            "replicas": {"type": "integer", "minimum": 1},
            "topology": {"type": "string", "enum": ["2x2", "2x4", "4x4"], "default": "2x2"},
            "preemptible": {"type": "boolean", "default": False}}},
        "status": {"type": "object", "x-kubernetes-preserve-unknown-fields": True,
                   "properties": {}}}}
CLOSED = {"type": "object", "properties": {"replicas": {"type": "integer"}},
          "additionalProperties": False}
BOUNDS = {"type": "object", "properties": {
    "name": {"type": "string", "minLength": 2, "maxLength": 5, "pattern": "^[a-z]+$"},
    "tags": {"type": "array", "minItems": 1, "maxItems": 2, "items": {"type": "string"}},
    "ratio": {"type": "number", "maximum": 1.5},
    "extra": {"type": "object", "additionalProperties": {"type": "integer"}},
    "odd": {"type": "widget"}}}

SCHEMA_CASES = [
    (TPUJOB, {"spec": {"replicas": 3}}),
    (TPUJOB, {"spec": {"replicas": 0}}),
    (TPUJOB, {"spec": {"replicas": "three"}}),
    (TPUJOB, {}),
    (TPUJOB, {"spec": {"replicas": 1, "topology": "3x3"}}),
    (TPUJOB, {"spec": {"replicas": 2}, "junk": 1}),
    (TPUJOB, {"spec": {"replicas": 2}, "status": {"phase": "Running"}}),
    (TPUJOB, {"spec": {"replicas": True}}),
    (CLOSED, {"replicas": 1, "bogus": 2}),
    (BOUNDS, {"name": "A", "tags": [], "ratio": 2, "extra": {"a": "x", "b": 1}}),
    (BOUNDS, {"name": "abcdefg", "tags": ["a", 1, "c"], "ratio": 1.0}),
    (BOUNDS, {"odd": 1}),
    (None, {"anything": [1, 2]}),
]


@pytest.mark.parametrize("i", range(len(SCHEMA_CASES)))
def test_structural_schema_verdicts_and_objects_match_jax(i):
    schema, value = SCHEMA_CASES[i]
    assert tcrd.validate_structural(schema, value) == jcrd.validate_structural(schema, value)
    pruned = tcrd.prune_and_default(schema, value)
    assert pruned == jcrd.prune_and_default(schema, value)
    assert tcrd.validate_structural(schema, pruned) == jcrd.validate_structural(schema, pruned)


def _crd_doc(plural="tpujobs", group="batch.tpu.dev", short=("tj",), singular="tpujob",
             scope="Namespaced"):
    return {"apiVersion": "apiextensions.k8s.io/v1", "kind": "CustomResourceDefinition",
            "metadata": {"name": f"{plural}.{group}"},
            "spec": {"group": group, "scope": scope,
                     "names": {"plural": plural, "singular": singular, "kind": "TPUJob",
                               "shortNames": list(short)},
                     "versions": [{"name": "v1", "served": True, "storage": True,
                                   "schema": {"openAPIV3Schema": TPUJOB}}]}}


def _crd_flow(crd, Store):
    """CRD self-validation, registry resolution through create, alias
    rename and delete, and custom-object validation: what each step saw."""
    out = []
    good = crd.CustomResourceDefinition.from_dict(_crd_doc())
    out.append(good.validate())
    for mutate in (lambda c: setattr(c.metadata, "name", "wrong"),
                   lambda c: setattr(c.versions[0], "storage", False),
                   lambda c: setattr(c, "group", "nodots"),
                   lambda c: setattr(c, "scope", "Global"),
                   lambda c: setattr(c, "versions", [])):
        bad = crd.CustomResourceDefinition.from_dict(_crd_doc())
        mutate(bad)
        out.append(bad.validate())
    store = Store()
    reg = crd.DynamicRegistry(store)
    names = ("tpujobs", "tpujob", "tj", "TPUJob".lower(), "nope")
    out.append([reg.resolve(n) is not None for n in names])
    store.create("customresourcedefinitions", good)
    out.append([getattr(reg.resolve(n), "group_prefix", None) for n in names])
    renamed = crd.CustomResourceDefinition.from_dict(_crd_doc(short=("tpj",)))

    def rename(c):
        c.names = renamed.names
        return c

    store.guaranteed_update("customresourcedefinitions", "tpujobs.batch.tpu.dev", rename)
    out.append([reg.resolve(n) is not None for n in names + ("tpj",)])
    store.create("customresourcedefinitions", crd.CustomResourceDefinition.from_dict(
        _crd_doc(plural="slices", short=(), singular="", scope="Cluster")))
    out.append(sorted(c.names.plural for c in reg.all()))
    for body in ({"apiVersion": "batch.tpu.dev/v1", "kind": "TPUJob",
                  "metadata": {"name": "a", "namespace": "ns"}, "spec": {"replicas": 2},
                  "junk": 1},
                 {"apiVersion": "other.dev/v1", "kind": "TPUJob", "metadata": {"name": "b"}},
                 {"kind": "Widget", "metadata": {"name": "c"}},
                 {"metadata": {"name": "d"}, "spec": {"replicas": 0}}):
        for plural in ("tpujobs", "slices"):
            obj, errs = crd.validate_custom_object(reg.resolve(plural),
                                                   crd.Unstructured.from_dict(body))
            out.append([obj.to_dict() if obj is not None else None, errs])
    store.delete("customresourcedefinitions", "tpujobs.batch.tpu.dev")
    out.append([reg.resolve(n) is not None for n in names])
    return out


def test_crd_validation_and_dynamic_registry_match_jax():
    got = _crd_flow(tcrd, TStore)
    assert got == _crd_flow(jcrd, JStore)
    assert got[0] is None and all(got[1:6]) and got[7][:4] == ["/apis/batch.tpu.dev/v1"] * 4


# -- the pod-log channel ------------------------------------------------------------


def _log_flow(events, Store, types):
    store = Store()
    uid = types.new_uid()
    for i in range(1005):
        events.append_pod_log(store, "default", "p", "c", f"line {i}", 10.0 + i / 8, uid)
    first = store.get("podlogs", "default/p")
    summary = [len(first.entries), first.entries[0], first.entries[-1]]
    # a same-name pod recreated: the stream resets and is re-owned
    events.append_pod_log(store, "default", "p", "c", "fresh", 500.0, types.new_uid())
    events.append_pod_log(store, "default", "q", "c", "no owner", 501.0)
    return store, summary


def test_append_pod_log_trims_and_resets_as_in_jax():
    jstore, jsum = _log_flow(jevents, JStore, jtypes)
    tstore, tsum = _log_flow(tevents, TStore, ttypes)
    assert tsum == jsum == [1000, "10.625 [c] line 5", "135.500 [c] line 1004"]
    assert normalized_dump(tstore, tser.to_dict, ttypes._uid_session) \
        == normalized_dump(jstore, jser.to_dict, jtypes._uid_session)
    assert tstore.get("podlogs", "default/p").entries == ["500.000 [c] fresh"]
    assert tevents.PodLog.MAX_LINES == jevents.PodLog.MAX_LINES


# -- flow control -------------------------------------------------------------------


def test_flowcontrol_dispatch_builders_match_jax():
    """to_level() / to_schema() build server/flowcontrol.py's dispatch
    objects, field for field the JAX package's."""
    docs = (("prioritylevelconfigurations",
             {"metadata": {"name": "low"}, "spec": {"type": "Limited"}}),
            ("prioritylevelconfigurations",
             {"metadata": {"name": "batch"},
              "spec": {"type": "Limited", "limited": {"seats": 3, "queueLength": 0,
                                                      "queueTimeoutSeconds": 2.5}}}),
            ("prioritylevelconfigurations",
             {"metadata": {"name": "free"}, "spec": {"type": "Exempt"}}),
            ("flowschemas", {"metadata": {"name": "nodes"}, "spec": {}}),
            ("flowschemas",
             {"metadata": {"name": "heavy"},
              "spec": {"priorityLevelConfiguration": {"name": "batch"},
                       "matchingPrecedence": 100, "verbs": ["list"], "resources": ["pods"],
                       "subjects": [{"kind": "Group", "group": {"name": "ops"}}]}}))
    for kind, doc in docs:
        mine, ref = tser.from_dict(kind, doc), jser.from_dict(kind, doc)
        if kind == "flowschemas":
            a, b = mine.to_schema(), ref.to_schema()
            assert isinstance(mine, tflow.FlowSchemaConfiguration)
        else:
            a, b = mine.to_level(), ref.to_level()
            assert isinstance(mine, tflow.PriorityLevelConfiguration)
            assert (a.seats, a.queue_length, a.queue_timeout, a.exempt) == (
                b.seats, b.queue_length, b.queue_timeout, b.exempt)
        assert type(a).__module__ == "kubernetes_tpu_torch.server.flowcontrol"
        assert type(a).__name__ == type(b).__name__
        assert {k: v for k, v in vars(a).items() if not k.startswith("_")} == {
            k: v for k, v in vars(b).items() if not k.startswith("_")}
        assert json.dumps(mine.to_dict(), sort_keys=True) == json.dumps(
            ref.to_dict(), sort_keys=True)
