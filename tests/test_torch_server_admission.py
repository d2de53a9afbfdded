"""The port's admission against the JAX package's: the default chain and
each plugin in process, the same chain over HTTP, Pod Security levels, the
CEL subset, ValidatingAdmissionPolicies and HTTP webhooks, and the service
ClusterIP allocator.

The server-side cases of the JAX package's test_admission_policy.py,
test_podsecurity.py, test_bootstrap_admission.py (admission breadth),
test_admission_proxy.py (the admission chain; its proxier cases wait for
ROADMAP.md queue 1 item 7h) and test_ipalloc.py, each run on both packages
through test_torch_server.py's `twin` and compared after its normalization.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List

import pytest
from test_torch_server import PODS, Run, twin

# -- in-process admission ------------------------------------------------------


def admit(r: Run, label: str, store, obj, resource: str = "pods", op: str = "CREATE",
          user: str = "", chain=None) -> None:
    """Run a chain on obj; record the admitted wire form or the error."""
    adm = r.k("server.admission")
    chain = chain if chain is not None else adm.default_admission_chain()
    try:
        chain.run(store, resource, op, obj, user=user)
    except adm.AdmissionError as e:
        r.note(label, ["denied", e.code, e.reason, str(e)])
        return
    r.note(label, ["admitted", r.k("api.serialize").to_dict(obj)])


def scn_namespace_lifecycle(r: Run) -> None:
    t = r.k("api.types")
    MakePod = r.k("testing").MakePod
    store = r.store()
    admit(r, "missing-ns", store, MakePod("p", namespace="ghost").obj())
    admit(r, "default-ns", store, MakePod("p", namespace="default").obj())
    admit(r, "kube-system", store, MakePod("p", namespace="kube-system").obj())
    ns = t.Namespace(metadata=t.ObjectMeta(name="dying"))
    ns.metadata.deletion_timestamp = 123.0
    store.create("namespaces", ns)
    admit(r, "terminating", store, MakePod("p", namespace="dying").obj())


def scn_limit_ranger(r: Run) -> None:
    MakePod = r.k("testing").MakePod
    store = r.store()
    store.create("limitranges", r.k("api.policy").LimitRange.from_dict({
        "metadata": {"name": "lr", "namespace": "default"},
        "spec": {"limits": [{"type": "Container",
                             "defaultRequest": {"cpu": "100m", "memory": "64Mi"},
                             "default": {"cpu": "200m"}, "max": {"cpu": "2"},
                             "min": {"memory": "16Mi"}}]}}))
    admit(r, "defaults", store, MakePod("p").container("img").obj())
    admit(r, "explicit", store, MakePod("p").req({"cpu": "500m"}).obj())
    admit(r, "max", store, MakePod("p").req({"cpu": "4"}).obj())
    admit(r, "min", store, MakePod("p").req({"memory": "8Mi"}).obj())
    p = MakePod("nullres").container("img").obj()
    p.spec.containers[0].resources = None
    admit(r, "null-resources", store, p)


def scn_quota(r: Run) -> None:
    MakePod = r.k("testing").MakePod
    store = r.store()
    store.create("resourcequotas", r.k("api.policy").ResourceQuota.from_dict({
        "metadata": {"name": "q", "namespace": "default"},
        "spec": {"hard": {"requests.cpu": "1", "pods": "2"}}}))
    admit(r, "a", store, MakePod("a").req({"cpu": "600m"}).obj())
    store.create("pods", MakePod("a").req({"cpu": "600m"}).obj())
    admit(r, "b-cpu", store, MakePod("b").req({"cpu": "600m"}).obj())
    admit(r, "c", store, MakePod("c").req({"cpu": "100m"}).obj())
    store.create("pods", MakePod("c").req({"cpu": "100m"}).obj())
    admit(r, "d-pods", store, MakePod("d").obj())


def scn_toleration_restriction(r: Run) -> None:
    t = r.k("api.types")
    MakePod = r.k("testing").MakePod
    store = r.store()
    ns = t.Namespace(metadata=t.ObjectMeta(name="batch"))
    ns.metadata.annotations["scheduler.alpha.kubernetes.io/defaultTolerations"] = json.dumps(
        [{"key": "dedicated", "operator": "Equal", "value": "batch", "effect": "NoSchedule"}])
    store.create("namespaces", ns)
    admit(r, "merged", store, MakePod("p", namespace="batch").obj())
    ns = t.Namespace(metadata=t.ObjectMeta(name="strict"))
    ns.metadata.annotations["scheduler.alpha.kubernetes.io/tolerationsWhitelist"] = json.dumps(
        [{"key": "ok", "operator": "Exists"}])
    store.create("namespaces", ns)
    admit(r, "whitelist", store, MakePod("p", namespace="strict").toleration(
        "forbidden", operator="Exists").obj())
    admit(r, "whitelisted", store, MakePod("q", namespace="strict").toleration(
        "ok", operator="Exists").obj())


def scn_node_restriction(r: Run) -> None:
    MakeNode, MakePod = r.k("testing").MakeNode, r.k("testing").MakePod
    store = r.store()
    admit(r, "other-node", store, MakeNode("n2").obj(), "nodes", "UPDATE", "system:node:n1")
    admit(r, "own-node", store, MakeNode("n1").obj(), "nodes", "UPDATE", "system:node:n1")
    admit(r, "foreign-pod", store, MakePod("p").node("n2").obj(), "pods", "UPDATE",
          "system:node:n1")
    admit(r, "admin", store, MakeNode("n2").obj(), "nodes", "UPDATE", "admin")
    # the same restriction over HTTP (X-Remote-User in the open mode)
    store.create("pods", MakePod("p").node("n2").obj())
    srv = r.server(store)
    r.http(srv, "DELETE", f"{PODS}/p", headers={"X-Remote-User": "system:node:n1"})
    r.http(srv, "DELETE", f"{PODS}/p", headers={"X-Remote-User": "system:node:n2"})


def scn_chain_over_http(r: Run) -> None:
    store = r.store()
    store.create("resourcequotas", r.k("api.policy").ResourceQuota.from_dict({
        "metadata": {"name": "q", "namespace": "default"}, "spec": {"hard": {"pods": "0"}}}))
    srv = r.server(store)
    r.http(srv, "POST", PODS, {"metadata": {"name": "p"}, "spec": {"containers": [{"name": "c"}]}})
    srv2 = r.server()
    r.http(srv2, "POST", PODS, {"metadata": {"name": "p"},
                                "spec": {"containers": [{"name": "c"}]}})
    r.http(srv2, "POST", "/api/v1/namespaces/ghost/pods",
           {"metadata": {"name": "p"}, "spec": {"containers": [{"name": "c"}]}})
    # admission off: the bare store semantics
    srv3 = r.server(admission=None)
    r.http(srv3, "POST", PODS, {"metadata": {"name": "p"},
                                "spec": {"containers": [{"name": "c"}]}})


def scn_priority_and_defaults(r: Run) -> None:
    t = r.k("api.types")
    MakePod = r.k("testing").MakePod
    PriorityClass = r.k("api.policy").PriorityClass
    store = r.store()
    store.create("priorityclasses", PriorityClass(metadata=t.ObjectMeta(name="high"),
                                                  value=5000, preemption_policy="Never"))
    p = MakePod("p").req({"cpu": "1"}).obj()
    p.spec.priority_class_name = "high"
    admit(r, "resolved", store, p)
    p = MakePod("p").req({"cpu": "1"}).obj()
    p.spec.priority_class_name = "ghost"
    admit(r, "unknown", store, p)
    p = MakePod("p", namespace="kube-system").req({"cpu": "1"}).obj()
    p.spec.priority_class_name = "system-node-critical"
    admit(r, "system", store, p)
    p = MakePod("p2").req({"cpu": "1"}).obj()
    p.spec.priority_class_name = "system-node-critical"
    admit(r, "system-outside", store, p)
    p = MakePod("p").req({"cpu": "1"}).obj()
    p.spec.priority = 2_000_000_001
    admit(r, "overwritten", store, p)
    store2 = r.store()
    store2.create("priorityclasses", PriorityClass(metadata=t.ObjectMeta(name="base"),
                                                   value=7, global_default=True))
    admit(r, "global-default", store2, MakePod("p").req({"cpu": "1"}).obj())
    # service accounts: defaulted, then validated
    p2 = MakePod("p2").req({"cpu": "1"}).obj()
    p2.spec.service_account_name = "builder"
    admit(r, "sa-missing", store, p2)
    store.create("serviceaccounts", r.k("api.policy").ServiceAccount(
        metadata=t.ObjectMeta(name="builder", namespace="default")))
    p2 = MakePod("p2").req({"cpu": "1"}).obj()
    p2.spec.service_account_name = "builder"
    admit(r, "sa-present", store, p2)
    # default storage class on a claim
    st = r.k("api.storage")
    store.create("storageclasses", st.StorageClass(
        metadata=t.ObjectMeta(name="fast", namespace=""), is_default=True))
    pvc = st.PersistentVolumeClaim.from_dict({
        "metadata": {"name": "data", "namespace": "default"},
        "spec": {"resources": {"requests": {"storage": "1Gi"}}}})
    admit(r, "storage-class", store, pvc, "persistentvolumeclaims")
    adm = r.k("server.admission")
    admit(r, "always-pull", store, MakePod("p").req({"cpu": "1"}, image="img:1").obj(),
          chain=adm.AdmissionChain([adm.AlwaysPullImages()]))


def scn_breadth_plugins(r: Run) -> None:
    t = r.k("api.types")
    adm = r.k("server.admission")
    MakeNode, MakePod = r.k("testing").MakeNode, r.k("testing").MakePod
    store = r.store()
    ert = adm.AdmissionChain([adm.ExtendedResourceToleration()])
    p = MakePod("p").req({"cpu": "1", "tpu.dev/chips": "4"}).obj()
    admit(r, "ext-tol", store, p, chain=ert)
    admit(r, "ext-tol-again", store, p, chain=ert)
    admit(r, "ext-unqualified", store, MakePod("p").req(
        {"gpu": "1", "hugepages-512Mi": "512Mi", "kubernetes.io/batch-cpu": "1"}).obj(),
        chain=ert)
    admit(r, "taint-by-condition", store, MakeNode("n1").capacity({"cpu": "4"}).obj(),
          "nodes", chain=adm.AdmissionChain([adm.TaintNodesByCondition()]))
    anti = adm.AdmissionChain([adm.LimitPodHardAntiAffinityTopology()])
    p = MakePod("p").req({"cpu": "1"}).obj()
    p.spec.affinity = t.Affinity(pod_anti_affinity_required=[
        t.PodAffinityTerm(selector=None, topology_key="topology.kubernetes.io/zone")])
    admit(r, "anti-zone", store, p, chain=anti)
    p = MakePod("q").obj()
    p.spec.affinity = t.Affinity(pod_anti_affinity_required=[
        t.PodAffinityTerm(selector=None, topology_key="kubernetes.io/hostname")])
    admit(r, "anti-host", store, p, chain=anti)


def _restricted_ok(r: Run, ns: str = "default"):
    p = r.k("testing").MakePod("web", namespace=ns).req({"cpu": "100m"}).obj()
    for c in p.spec.containers:
        c.security_context = {"runAsNonRoot": True, "allowPrivilegeEscalation": False,
                              "capabilities": {"drop": ["ALL"]},
                              "seccompProfile": {"type": "RuntimeDefault"}}
    return p


def scn_pod_security(r: Run) -> None:
    t = r.k("api.types")
    ps = r.k("server.podsecurity")
    adm = r.k("server.admission")
    MakePod = r.k("testing").MakePod
    p = MakePod("p").req({"cpu": "1"}).obj()
    p.spec.host_network = True
    p.spec.host_pid = True
    p.spec.volumes.append(t.Volume(name="h", host_path="/etc"))
    p.spec.containers[0].security_context = {"privileged": True}
    r.note("baseline-host", ps.check_baseline(p))
    p = MakePod("p").req({"cpu": "1"}).obj()
    p.spec.containers[0].security_context = {"capabilities": {"add": ["CHOWN", "SYS_ADMIN"]}}
    r.note("baseline-caps", ps.check_baseline(p))
    r.note("restricted-bare", ps.check_restricted(MakePod("p").req({"cpu": "1"}).obj()))
    r.note("restricted-ok", ps.check_restricted(_restricted_ok(r)))
    p = _restricted_ok(r)
    for c in p.spec.containers:
        del c.security_context["runAsNonRoot"]
        del c.security_context["seccompProfile"]
    p.spec.security_context = {"runAsNonRoot": True, "seccompProfile": {"type": "RuntimeDefault"}}
    r.note("restricted-inherited", ps.check_restricted(p))
    store = r.store()
    for name, level in (("locked", "restricted"), ("open", None), ("weird", "bogus"),
                        ("base", "baseline")):
        ns = t.Namespace(metadata=t.ObjectMeta(name=name))
        if level:
            ns.metadata.labels["pod-security.kubernetes.io/enforce"] = level
        store.create("namespaces", ns)
    chain = adm.AdmissionChain([adm.PodSecurityAdmission()])
    admit(r, "locked-bad", store, MakePod("p", namespace="locked").req({"cpu": "1"}).obj(),
          chain=chain)
    admit(r, "locked-ok", store, _restricted_ok(r, "locked"), chain=chain)
    p = MakePod("p", namespace="open").obj()
    p.spec.host_network = True
    admit(r, "open", store, p, chain=chain)
    admit(r, "weird", store, MakePod("p", namespace="weird").req({"cpu": "1"}).obj(),
          chain=chain)
    p = MakePod("p", namespace="base").obj()
    p.spec.host_pid = True
    admit(r, "baseline-ns", store, p, chain=chain)
    ser = r.k("api.serialize")
    p = _restricted_ok(r)
    p.spec.host_pid = True
    p.spec.security_context = {"runAsUser": 1000}
    d = ser.to_dict(p)
    r.note("round-trip", [d, ser.to_dict(t.Pod.from_dict(d)) == d])


# -- the CEL subset --------------------------------------------------------------

CEL_CASES = [
    ("object.spec.replicas <= 5", {"spec": {"replicas": 3}}, {}),
    ("object.spec.replicas <= 5", {"spec": {"replicas": 9}}, {}),
    ("object.spec.a == 1 && object.spec.b == 'x'", {"spec": {"a": 1, "b": "x"}}, {}),
    ("object.spec.a == 2 || object.spec.b == 'x'", {"spec": {"a": 1, "b": "x"}}, {}),
    ("!(object.spec.a == 2)", {"spec": {"a": 1}}, {}),
    ("has(object.metadata.labels)", {"metadata": {"labels": {"a": "b"}}}, {}),
    ("has(object.metadata.labels)", {"metadata": {}}, {}),
    ("object.spec.replicas > 0", {}, {}),
    ("object.spec.x != 'y'", {}, {}),
    ("object.metadata.name.startsWith('web-')", {"metadata": {"name": "web-frontend"}}, {}),
    ("object.metadata.name.endsWith('end')", {"metadata": {"name": "web-frontend"}}, {}),
    ("object.metadata.name.contains('front')", {"metadata": {"name": "web-frontend"}}, {}),
    ("object.metadata.name.matches('^web-[a-z]+$')", {"metadata": {"name": "web-frontend"}}, {}),
    ("size(object.spec.containers) == 3", {"spec": {"containers": [1, 2, 3]}}, {}),
    ("object.spec.tier in ['gold', 'silver']", {"spec": {"tier": "gold"}}, {}),
    ("object.spec.tier in ['gold', 'silver']", {"spec": {"tier": "bronze"}}, {}),
    ("request.operation == 'CREATE'", {}, {"operation": "CREATE"}),
    ("object.spec.x == 'true'", {"spec": {"x": "true"}}, {}),
    ("object.spec.x == 'null'", {"spec": {"x": "null"}}, {}),
    ("object.spec.x == 'false'", {"spec": {"x": "False"}}, {}),
    ("object.spec.x == null", {"spec": {"x": None}}, {}),
    ("oldObject == null", {}, {}),
    ("object.spec.replicas * 2 + 1 < 10 - 1", {"spec": {"replicas": 3}}, {}),
    ("object.spec.replicas % 2 == 1 ? true : false", {"spec": {"replicas": 3}}, {}),
    ("__import__('os')", {}, {}),
    ("object.__class__", {}, {}),
    ("[x for x in object]", {}, {}),
    ("lambda: 1", {}, {}),
    ("open('/etc/passwd')", {}, {}),
    ("object.spec.replicas", {"spec": {"replicas": 3}}, {}),
    ("object.spec..bogus(", {}, {}),
    ("'abc'.size() == 3", {}, {}),
]


@pytest.mark.parametrize("i", range(len(CEL_CASES)))
def test_cel_parity(i):
    src, obj, req = CEL_CASES[i]

    def scn(r: Run) -> None:
        cel = r.k("server.celexpr")
        try:
            fn = cel.compile_expression(src)
            r.note("result", fn({"object": obj, "oldObject": None, "request": req}))
        except cel.ExpressionError as e:
            r.note("error", str(e))

    twin(scn)


# -- policies and webhooks over HTTP ---------------------------------------------


def make_policy(c, name, expression, message="denied by policy", resources=("pods",),
                operations=("*",), failure_policy="Fail", bind=True, ns_labels=None):
    c.create("validatingadmissionpolicies", {
        "kind": "ValidatingAdmissionPolicy", "metadata": {"name": name},
        "spec": {"matchConstraints": {"resourceRules": [
            {"resources": list(resources), "operations": list(operations)}]},
            "validations": [{"expression": expression, "message": message}],
            "failurePolicy": failure_policy}}, namespace=None)
    if bind:
        spec: Dict[str, Any] = {"policyName": name, "validationActions": ["Deny"]}
        if ns_labels is not None:
            spec["matchResources"] = {"namespaceSelector": {"matchLabels": ns_labels}}
        c.create("validatingadmissionpolicybindings", {
            "kind": "ValidatingAdmissionPolicyBinding",
            "metadata": {"name": f"{name}-binding"}, "spec": spec}, namespace=None)


def vpod(name, labels=None, ns="default"):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": ns, "labels": labels or {}},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}]}}


def scn_policies(r: Run) -> None:
    srv = r.server()
    c = r.client(srv)
    make_policy(c, "require-team", "has(object.metadata.labels.team)",
                message="every pod needs a team label")
    r.call("no-team", lambda: c.create("pods", vpod("p1")))
    r.call("team", lambda: c.create("pods", vpod("p2", {"team": "infra"})))
    r.call("del", lambda: c.delete("validatingadmissionpolicies", "require-team",
                                   namespace=None))
    r.call("restored", lambda: c.create("pods", vpod("p1")))
    make_policy(c, "inert", "false", bind=False)
    r.call("inert", lambda: c.create("pods", vpod("p3")))
    for name, env in (("prod", "prod"), ("dev", "dev")):
        c.create("namespaces", {"kind": "Namespace",
                                "metadata": {"name": name, "labels": {"env": env}}},
                 namespace=None)
    make_policy(c, "prod-only", "false", ns_labels={"env": "prod"})
    r.call("dev", lambda: c.create("pods", vpod("p-dev", ns="dev")))
    r.call("prod", lambda: c.create("pods", vpod("p-prod", ns="prod")))
    make_policy(c, "broken-fail", "object.spec..bogus(", failure_policy="Fail",
                ns_labels={"env": "dev"})
    r.call("broken-fail", lambda: c.create("pods", vpod("b1", ns="dev")))
    c.delete("validatingadmissionpolicies", "broken-fail", namespace=None)
    make_policy(c, "broken-ignore", "object.spec..bogus(", failure_policy="Ignore",
                ns_labels={"env": "dev"})
    r.call("broken-ignore", lambda: c.create("pods", vpod("b2", ns="dev")))
    make_policy(c, "no-updates", "false", operations=("UPDATE",), ns_labels={"env": "dev"})
    got = c.get("pods", "b2", namespace="dev")
    got["metadata"]["labels"] = {"x": "y"}
    r.call("update-denied", lambda: c.update("pods", got, namespace="dev"))
    make_policy(c, "no-scale-down",
                "oldObject == null || object.spec.replicas >= oldObject.spec.replicas",
                resources=("replicasets",), operations=("UPDATE",))
    c.create("replicasets", {"kind": "ReplicaSet", "metadata": {"name": "web"},
                             "spec": {"replicas": 3, "template": {
                                 "spec": {"containers": [{"name": "c"}]}}}})
    got = c.get("replicasets", "web")
    got["spec"]["replicas"] = 5
    r.call("scale-up", lambda: c.update("replicasets", got))
    got = c.get("replicasets", "web")
    got["spec"]["replicas"] = 2
    r.call("scale-down", lambda: c.update("replicasets", got))


class _Hook(BaseHTTPRequestHandler):
    """A scriptable admission webhook: `responder` on the server object."""

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0) or 0)
        review = json.loads(self.rfile.read(length))
        resp = self.server.responder(review)  # type: ignore[attr-defined]
        body = json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                           "response": resp}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def hook_server(r: Run):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Hook)
    httpd.responder = lambda review: {"allowed": True}  # type: ignore[attr-defined]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()

    def halt():
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=5)

    r.on_close(halt)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}/admit"


def webhook_cfg(kind: str, name: str, url: str, ops=("*",), **extra) -> Dict:
    return {"kind": kind, "metadata": {"name": name},
            "webhooks": [{"name": f"{name}.example.com", "clientConfig": {"url": url},
                          "rules": [{"resources": ["pods"], "operations": list(ops)}],
                          **extra}]}


def _jpatch(ops: List[Dict]) -> str:
    return base64.b64encode(json.dumps(ops).encode()).decode()


def scn_webhooks(r: Run) -> None:
    srv = r.server()
    c = r.client(srv)
    hook, url = hook_server(r)
    seen: List[Dict] = []

    def observe(review):
        req = review["request"]
        seen.append({k: req.get(k) for k in ("operation", "name", "namespace", "resource",
                                              "kind", "subResource")})
        return {"allowed": True}

    hook.responder = observe
    c.create("validatingwebhookconfigurations",
             webhook_cfg("ValidatingWebhookConfiguration", "observer", url), namespace=None)
    r.call("observed", lambda: c.create("pods", vpod("p9")))
    r.note("review", seen)
    c.delete("validatingwebhookconfigurations", "observer", namespace=None)

    hook.responder = lambda review: {"allowed": False,
                                     "status": {"message": "nope from webhook", "code": 403}}
    c.create("validatingwebhookconfigurations",
             webhook_cfg("ValidatingWebhookConfiguration", "deny", url, ops=("CREATE",)),
             namespace=None)
    r.call("denied", lambda: c.create("pods", vpod("p1")))
    r.call("unmatched", lambda: c.create("configmaps", {"kind": "ConfigMap",
                                                        "metadata": {"name": "cm"},
                                                        "data": {}}))
    c.delete("validatingwebhookconfigurations", "deny", namespace=None)

    hook.responder = lambda review: {"allowed": False, "status": {"message": "sneaky",
                                                                  "code": 200}}
    c.create("validatingwebhookconfigurations",
             webhook_cfg("ValidatingWebhookConfiguration", "sneaky", url), namespace=None)
    r.call("clamped", lambda: c.create("pods", vpod("px")))
    c.delete("validatingwebhookconfigurations", "sneaky", namespace=None)

    hook.responder = lambda review: {"allowed": True, "patchType": "JSONPatch", "patch": _jpatch(
        [{"op": "add", "path": "/metadata/labels", "value": {"injected": "true"}}])}
    c.create("mutatingwebhookconfigurations",
             webhook_cfg("MutatingWebhookConfiguration", "inject", url, ops=("CREATE",)),
             namespace=None)
    r.call("mutated", lambda: c.create("pods", vpod("m1")))
    r.call("mutated-get", lambda: c.get("pods", "m1"))
    c.delete("mutatingwebhookconfigurations", "inject", namespace=None)

    hook.responder = lambda review: {"allowed": True, "patchType": "JSONPatch", "patch": _jpatch(
        [{"op": "add", "path": "/metadata/labels/stamped", "value": "yes"}])}
    c.create("mutatingwebhookconfigurations",
             webhook_cfg("MutatingWebhookConfiguration", "stamper", url, ops=("UPDATE",)),
             namespace=None)
    r.call("merge-patch", lambda: c.patch("pods", "m1", {"metadata": {"labels": {"edited": "1"}}}))
    c.delete("mutatingwebhookconfigurations", "stamper", namespace=None)

    calls: List[str] = []

    def blocker(review):
        calls.append(review["request"]["operation"])
        return {"allowed": False, "status": {"message": "no"}}

    hook.responder = blocker
    c.create("validatingwebhookconfigurations",
             webhook_cfg("ValidatingWebhookConfiguration", "blocker", url), namespace=None)
    r.call("status-patch", lambda: c.request(
        "PATCH", "/api/v1/namespaces/default/pods/m1/status", {"status": {"phase": "Running"}},
        content_type="application/merge-patch+json"))
    r.note("status-calls", calls)
    c.delete("validatingwebhookconfigurations", "blocker", namespace=None)

    c.create("validatingwebhookconfigurations", webhook_cfg(
        "ValidatingWebhookConfiguration", "gone", "http://127.0.0.1:9/admit",
        timeoutSeconds=1, failurePolicy="Ignore"), namespace=None)
    r.call("unreachable-ignore", lambda: c.create("pods", vpod("u1")))
    c.delete("validatingwebhookconfigurations", "gone", namespace=None)
    c.create("validatingwebhookconfigurations", webhook_cfg(
        "ValidatingWebhookConfiguration", "gone-fail", "http://127.0.0.1:9/admit",
        timeoutSeconds=1), namespace=None)
    r.call("unreachable-fail", lambda: c.create("pods", vpod("u2")))


# -- ClusterIP allocation ----------------------------------------------------------


def svc(name, **spec):
    return {"kind": "Service", "metadata": {"name": name},
            "spec": {"selector": {"app": name}, "ports": [{"port": 80}], **spec}}


def scn_ipalloc(r: Run) -> None:
    ipa = r.k("server.ipalloc")

    def attempt(label: str, fn: Callable[[], Any]) -> None:
        try:
            r.note(label, fn())
        except ValueError as e:
            r.note(label, ["ValueError", str(e)])

    a = ipa.ClusterIPAllocator(r.store(), cidr="10.96.0.0/29")
    ips = [a.allocate() for _ in range(6)]
    r.note("seq", ips)
    attempt("exhausted", a.allocate)
    a.release(ips[2])
    attempt("reuse", a.allocate)
    b = ipa.ClusterIPAllocator(r.store(), cidr="10.96.0.0/24")
    for req in ("10.96.0.10", "10.96.0.10", "192.168.1.1", "not-an-ip"):
        attempt(f"req-{req}", lambda: b.allocate(req))
    store = r.store()
    store.create("services", r.k("api.networking").Service.from_dict(
        svc("pre", clusterIP="10.96.0.5")))
    attempt("repaired", lambda: ipa.ClusterIPAllocator(store, cidr="10.96.0.0/24").allocate(
        "10.96.0.5"))
    # served allocation
    srv = r.server()
    c = r.client(srv)
    out = r.call("web", lambda: c.create("services", svc("web")))
    ip = out["spec"]["clusterIP"]
    r.call("db", lambda: c.create("services", svc("db")))
    r.call("del-web", lambda: c.delete("services", "web"))
    r.call("reuse", lambda: c.create("services", svc("web2", clusterIP=ip)))
    r.call("conflict", lambda: c.create("services", svc("b", clusterIP=ip)))
    r.call("headless", lambda: c.create("services", svc("hs", clusterIP="None")))
    for _ in range(3):
        r.call("dup", lambda: c.create("services", svc("db")))
    r.call("after-dups", lambda: c.create("services", svc("a")))
    r.call("immutable-patch", lambda: c.patch("services", "a",
                                              {"spec": {"clusterIP": "10.96.0.200"}}))
    cur = c.get("services", "a")
    cur["spec"]["clusterIP"] = "10.96.0.201"
    r.call("immutable-put", lambda: c.update("services", cur))
    r.call("label-patch", lambda: c.patch("services", "a", {"metadata": {"labels": {"a": "b"}}}))
    srv.store.delete("services", "default/web2")
    r.call("store-delete-released", lambda: c.create("services", svc("web3", clusterIP=ip)))
    srv.store.create("services", r.k("api.networking").Service.from_dict(
        svc("direct", clusterIP="10.96.0.77")))
    r.call("store-create-marked", lambda: c.create("services", svc("clash",
                                                                   clusterIP="10.96.0.77")))


SCENARIOS = {
    "namespace_lifecycle": scn_namespace_lifecycle,
    "limit_ranger": scn_limit_ranger,
    "quota": scn_quota,
    "toleration_restriction": scn_toleration_restriction,
    "node_restriction": scn_node_restriction,
    "chain_over_http": scn_chain_over_http,
    "priority_and_defaults": scn_priority_and_defaults,
    "breadth_plugins": scn_breadth_plugins,
    "pod_security": scn_pod_security,
    "policies": scn_policies,
    "webhooks": scn_webhooks,
    "ipalloc": scn_ipalloc,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_admission_parity(name):
    twin(SCENARIOS[name])

