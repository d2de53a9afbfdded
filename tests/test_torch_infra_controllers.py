"""The port's service and tenant controllers against the JAX package's.

Each scenario follows a case of tests/test_infra_controllers.py (namespace
deletion, quota usage, endpoint slices, the horizontal pod autoscaler),
tests/test_bootstrap_admission.py and tests/test_observability.py (the
service-account, TTL-after-finished and event-TTL controllers),
tests/test_certificates.py (the CSR approver, signer and cleaner, with one
deterministic stub signer given to both packages) or
tests/test_aggregation.py (API-service availability, probed against the
same loopback servers: healthy, 404, 500 and a port with nothing
listening), and one runs the smoke's main_path_services at 50 nodes and 2
namespaces through each package's BatchScheduler. Every scenario runs once
on each package through the same call sequence on a FakeClock, and the two
runs are compared exactly as in tests/test_torch_controllers.py: the
normalized store dump, the event sequence with its resource versions, the
{pod: node} map and the reconcile counts.

Endpoint addresses are synthesized from pod uids, which differ between
the packages' sessions: each address is checked against `pod_ip` of its own
package's pod (named by the endpoint's target) and then masked; everything
else of a slice is compared exactly.
"""

import http.server
import socket
import threading
from types import SimpleNamespace

import pytest

import kubernetes_tpu.api.certificates as jcert
import kubernetes_tpu.api.dra as jdra
import kubernetes_tpu.api.events as jevents
import kubernetes_tpu.api.networking as jnet
import kubernetes_tpu.api.storage as jst
import kubernetes_tpu.controllers.certificates as jcsr
import kubernetes_tpu.controllers.endpointslice as jes
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.api.apiservice as tapisvc
import kubernetes_tpu_torch.api.certificates as tcert
import kubernetes_tpu_torch.api.dra as tdra
import kubernetes_tpu_torch.api.events as tevents
import kubernetes_tpu_torch.api.networking as tnet
import kubernetes_tpu_torch.api.policy as tpolicy
import kubernetes_tpu_torch.api.storage as tst
import kubernetes_tpu_torch.controllers.certificates as tcsr
import kubernetes_tpu_torch.controllers.endpointslice as tes
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.api.apiservice import APIService as JAPIService
from kubernetes_tpu.api.labels import NodeSelector as JNodeSelector
from kubernetes_tpu.api.policy import HorizontalPodAutoscaler as JHPA
from kubernetes_tpu.api.policy import ResourceQuota as JQuota
from kubernetes_tpu.api.types import ObjectMeta as JObjectMeta
from kubernetes_tpu.utils.featuregate import feature_gates as jgates
from kubernetes_tpu_torch.testing import run_bound_pods
from kubernetes_tpu_torch.utils.featuregate import feature_gates as tgates
from test_torch_controllers import _outcome, _pkg, make_rs

JAX_API = SimpleNamespace(MakeNode=jt.MakeNode, MakePod=jt.MakePod, ObjectMeta=JObjectMeta,
                          NodeSelector=JNodeSelector, storage=jst, dra=jdra)


def pkg(port):
    """test_torch_controllers' package namespace plus the modules of this
    slice."""
    m = _pkg(port)
    if port:
        m.net, m.cert, m.csr, m.es, m.events, m.st, m.dra = (tnet, tcert, tcsr, tes, tevents,
                                                           tst, tdra)
        m.HPA, m.Quota, m.APIService = (tpolicy.HorizontalPodAutoscaler, tpolicy.ResourceQuota,
                                        tapisvc.APIService)
        m.api = None
    else:
        m.net, m.cert, m.csr, m.es, m.events, m.st, m.dra = (jnet, jcert, jcsr, jes, jevents,
                                                           jst, jdra)
        m.HPA, m.Quota, m.APIService = JHPA, JQuota, JAPIService
        m.api = JAX_API
    return m


def _mask_addresses(m, store, out):
    """Check every endpoint address against its own package's pod_ip of the
    pod the endpoint targets, then mask it in the dump."""
    for s in store.list("endpointslices")[0]:
        for e in s.endpoints:
            pod = store.get("pods", e.target_ref)
            assert e.addresses == [m.es.pod_ip(pod)], (s.key, e.target_ref)
    for wire in out["dump"].get("endpointslices", {}).values():
        for e in wire["endpoints"]:
            e["addresses"] = ["<pod_ip>"]
    return out


def run_both(scenario, *args):
    """test_torch_controllers.run_both with endpoint addresses checked and
    masked; returns the port's outcome."""
    got = {}
    for name, port in (("jax", False), ("port", True)):
        m = pkg(port)
        store, controllers, extra = scenario(m, *args)
        got[name] = _mask_addresses(m, store, _outcome(m, store, controllers, extra))
    for field in ("dump", "history", "placements", "counts", "extra"):
        assert got["port"][field] == got["jax"][field], field
    return got["port"]


@pytest.fixture()
def dra_gate():
    for g in (jgates, tgates):
        g.set("DynamicResourceAllocation", True)
    yield
    for g in (jgates, tgates):
        g.set("DynamicResourceAllocation", False)


def set_phase(store, key, phase):
    def mutate(p):
        p.status.phase = phase
        return p

    store.guaranteed_update("pods", key, mutate)


def _ns(m, name):
    return m.types.Namespace(metadata=m.types.ObjectMeta(name=name, uid=m.types.new_uid()))


def _service(m, name="web", ns="default", app="web"):
    return m.net.Service.from_dict({
        "metadata": {"name": name, "namespace": ns, "uid": m.types.new_uid()},
        "spec": {"selector": {"app": app},
                 "ports": [{"name": "http", "port": 80, "targetPort": 8080}]}})


# -- namespace ---------------------------------------------------------------


def sc_namespace(m):
    """TestNamespaceController with every kind a tenant holds: the sweep's
    order follows the store's kinds, and a second pass removes the
    namespace."""
    store = m.Store()
    clock = m.Clock(100.0)
    for name in ("team-a", "team-b"):
        store.create("namespaces", _ns(m, name))
    for ns in ("team-a", "team-b"):
        store.create("resourcequotas", m.Quota.from_dict({
            "metadata": {"name": "q", "namespace": ns}, "spec": {"hard": {"pods": "9"}}}))
        store.create("pods", m.t.MakePod("p1", namespace=ns).obj())
        store.create("services", _service(m, ns=ns))
        store.create("replicasets", make_rs(m, name=f"rs-{ns}"))
    store.create("pods", m.t.MakePod("p2", namespace="team-a").obj())
    store.create("pods", m.t.MakePod("other").obj())
    ctl = m.ctl.NamespaceController(store, clock=clock)
    ctl.sync_all()
    ctl.mark_terminating("team-a")
    extra = {"marked": store.get("namespaces", "team-a").metadata.deletion_timestamp}
    ctl.process()
    extra["after_first"] = sorted(store.kinds())
    ctl.process()
    extra["left"] = sorted(k for k in store.kinds()
                           for o in store.list(k)[0]
                           if getattr(o.metadata, "namespace", "") == "team-a")
    extra["namespaces"] = sorted(n.metadata.name for n in store.list("namespaces")[0])
    return store, [ctl], extra


def test_namespace_deletion_matches_jax():
    out = run_both(sc_namespace)
    assert out["extra"]["marked"] == 100.0 and out["extra"]["left"] == []
    assert out["extra"]["namespaces"] == ["team-b"]
    assert "default/other" in out["dump"]["pods"]


# -- quota -------------------------------------------------------------------


def sc_quota(m, case):
    store = m.Store()
    store.create("resourcequotas", m.Quota.from_dict({
        "metadata": {"name": "q", "namespace": "default"},
        "spec": {"hard": {"requests.cpu": "4", "requests.memory": "8Gi", "cpu": "4",
                          "memory": "8Gi", "pods": "10", "count/replicasets": "5",
                          "count/services": "2"}}}))
    store.create("pods", m.t.MakePod("a").req({"cpu": "500m", "memory": "1Gi"}).obj())
    store.create("pods", m.t.MakePod("b").req({"cpu": "250m", "memory": "300Mi"})
                 .init_req({"cpu": "2"}).obj())
    store.create("pods", m.t.MakePod("done").req({"cpu": "1"}).phase("Succeeded").obj())
    store.create("pods", m.t.MakePod("elsewhere", namespace="other").req({"cpu": "1"}).obj())
    store.create("replicasets", make_rs(m, name="rs", replicas=0))
    ctl = m.ctl.ResourceQuotaController(store, clock=m.Clock(0.0))
    ctl.sync_all()
    ctl.process()
    extra = {"first": dict(store.get("resourcequotas", "default/q").used)}
    if case == "deletion":
        store.delete("pods", "default/a")
        store.create("services", _service(m))
        ctl.reconcile_once()
        extra["after"] = dict(store.get("resourcequotas", "default/q").used)
    return store, [ctl], extra


@pytest.mark.parametrize("case", ["usage", "deletion"])
def test_quota_usage_matches_jax(case):
    out = run_both(sc_quota, case)
    first = out["extra"]["first"]
    # init containers count beside the containers (the quota's sum, not the
    # scheduler's max); the terminal pod and the other namespace do not
    assert first["requests.cpu"] == first["cpu"] == "2750m"
    assert first["pods"] == "2" and first["count/replicasets"] == "1"
    assert first["requests.memory"] == str(2**30 + 300 * 2**20)
    if case == "deletion":
        assert out["extra"]["after"]["pods"] == "1"
        assert out["extra"]["after"]["count/services"] == "1"


# -- endpoint slices ---------------------------------------------------------


def sc_endpoints(m, case):
    store = m.Store()
    store.create("services", _service(m))
    ctl = m.ctl.EndpointSliceController(store, clock=m.Clock(0.0))
    ctl.sync_all()
    extra = {}
    if case == "tracks_ready":
        for i in range(3):
            store.create("pods", m.t.MakePod(f"w{i}").labels({"app": "web"})
                         .node(f"n{i}").obj())
        set_phase(store, "default/w0", "Running")
        set_phase(store, "default/w1", "Running")
        ctl.reconcile_once()
        set_phase(store, "default/w2", "Failed")  # terminal: leaves the slice
        ctl.reconcile_once()
    elif case == "exclusions":
        store.create("pods", m.t.MakePod("other").labels({"app": "db"}).node("n1").obj())
        store.create("pods", m.t.MakePod("pending").labels({"app": "web"}).obj())
        store.create("pods", m.t.MakePod("away", namespace="team-a").labels({"app": "web"})
                     .node("n1").obj())
        ctl.reconcile_once()
    elif case == "deletion":
        store.create("pods", m.t.MakePod("w").labels({"app": "web"}).node("n").obj())
        ctl.reconcile_once()
        extra["before"] = sorted(s.metadata.name for s in store.list("endpointslices")[0])
        store.delete("services", "default/web")
        ctl.reconcile_once()
    elif case == "chunked":
        ctl.max_endpoints = 2
        for i in range(5):
            store.create("pods", m.t.MakePod(f"w{i}").labels({"app": "web"}).node("n").obj())
        ctl.reconcile_once()
    else:  # low_ordinals: 11 slices shrunk to 2
        ctl.max_endpoints = 1
        for i in range(11):
            store.create("pods", m.t.MakePod(f"w{i:02d}").labels({"app": "web"})
                         .node("n").obj())
        ctl.reconcile_once()
        extra["before"] = len(store.list("endpointslices")[0])
        for i in range(2, 11):
            store.delete("pods", f"default/w{i:02d}")
        ctl.reconcile_once()
    extra["slices"] = sorted((s.metadata.name, len(s.endpoints))
                             for s in store.list("endpointslices")[0])
    return store, [ctl], extra


@pytest.mark.parametrize("case", ["tracks_ready", "exclusions", "deletion", "chunked",
                                  "low_ordinals"])
def test_endpoint_slices_match_jax(case):
    out = run_both(sc_endpoints, case)
    want = {"tracks_ready": [["web-0", 2]], "exclusions": [["web-0", 0]], "deletion": [],
            "chunked": [["web-0", 2], ["web-1", 2], ["web-2", 1]],
            "low_ordinals": [["web-0", 1], ["web-1", 1]]}[case]
    assert out["extra"]["slices"] == want
    if case == "tracks_ready":
        eps = out["dump"]["endpointslices"]["default/web-0"]["endpoints"]
        assert [e["conditions"]["ready"] for e in eps] == [True, True]
        assert eps[0]["targetRef"] == {"kind": "Pod", "namespace": "default", "name": "w0"}


def test_pod_ip_and_owner_ref_match_jax():
    for i in range(40):
        uid = f"uid-{i}-{'%08x' % (i * 2654435761 % 2**32)}"
        tpod = tt.MakePod("p").uid(uid).obj()
        assert tes.pod_ip(tpod) == jes.pod_ip(jt.MakePod("p").uid(uid).obj())
    svc = tnet.Service.from_dict({"metadata": {"name": "s", "uid": "u1"}})
    assert tes.svc_owner_ref(svc) == jes.svc_owner_ref(jnet.Service.from_dict(
        {"metadata": {"name": "s", "uid": "u1"}}))


# -- horizontal pod autoscaler ----------------------------------------------------


def _hpa_rs(m, replicas=2, target=50, minr=1, maxr=10, kind="ReplicaSet"):
    store = m.Store()
    rs = m.wl.ReplicaSet.from_dict({
        "metadata": {"name": "web", "uid": m.types.new_uid()},
        "spec": {"replicas": replicas, "selector": {"matchLabels": {"app": "web"}},
                 "template": {"metadata": {"labels": {"app": "web"}},
                              "spec": {"containers": [{"name": "c"}]}}}})
    store.create("replicasets", rs)
    store.create("horizontalpodautoscalers", m.HPA.from_dict({
        "metadata": {"name": "web"},
        "spec": {"scaleTargetRef": {"kind": kind, "name": "web"},
                 "minReplicas": minr, "maxReplicas": maxr,
                 "targetCPUUtilizationPercentage": target}}))
    return store


def _hot_pod(m, store, name, usage_milli, request="1"):
    pod = (m.t.MakePod(name).labels({"app": "web"}).req({"cpu": request}).node("n1")
           .phase("Running").obj())
    pod.metadata.annotations["metrics.k8s.io/cpu-usage"] = f"{usage_milli}m"
    store.create("pods", pod)


HPA_CASES = {
    "scale_up": dict(target=50, usage=(900, 900)),
    "tolerance": dict(target=50, usage=(520, 480)),
    "stabilization": dict(target=50, usage=(100, 100)),
    "max": dict(target=10, maxr=3, usage=(1000, 1000)),
    "no_metrics": dict(target=50, usage=()),
    "unknown_kind": dict(target=50, kind="CronJob", usage=(900, 900)),
}


def sc_hpa(m, case):
    kw = dict(HPA_CASES[case])
    usage = kw.pop("usage")
    store = _hpa_rs(m, **kw)
    clock = m.Clock(1000.0)
    ctl = m.ctl.HorizontalPodAutoscalerController(store, clock=clock,
                                                  downscale_stabilization=300)
    ctl.sync_all()
    for i, u in enumerate(usage):
        _hot_pod(m, store, f"w{i}", u)
    extra = {}
    if case == "stabilization":
        def stamp(h):
            h.last_scale_time = clock.now()
            return h

        store.guaranteed_update("horizontalpodautoscalers", "default/web", stamp)
        ctl.resync()
        extra["held"] = store.get("replicasets", "default/web").spec.replicas
        clock.step(301)
    ctl.resync()
    h = store.get("horizontalpodautoscalers", "default/web")
    extra.update(replicas=store.get("replicasets", "default/web").spec.replicas,
                 desired=h.desired_replicas, current=h.current_replicas,
                 last=h.last_scale_time)
    return store, [ctl], extra


@pytest.mark.parametrize("case", sorted(HPA_CASES))
def test_autoscaler_matches_jax(case):
    out = run_both(sc_hpa, case)["extra"]
    want = {"scale_up": 4, "tolerance": 2, "stabilization": 1, "max": 3, "no_metrics": 2,
            "unknown_kind": 2}[case]
    assert out["replicas"] == want
    if case == "stabilization":
        assert out["held"] == 2 and out["last"] == 1301.0


def sc_hpa_end_to_end(m):
    """TestHPAEndToEnd: the autoscaler scales the ReplicaSet's spec and the
    ReplicaSet controller makes the pods."""
    store = _hpa_rs(m, replicas=1, maxr=5)
    clock = m.Clock(0.0)
    rs_ctl = m.ctl.ReplicaSetController(store, clock=clock)
    hpa_ctl = m.ctl.HorizontalPodAutoscalerController(store, clock=clock)
    rs_ctl.sync_all()
    hpa_ctl.sync_all()
    rs_ctl.process()
    pods, _ = store.list("pods")

    def hot(p):
        p.metadata.annotations["metrics.k8s.io/cpu-usage"] = "1000m"
        p.spec.containers[0].resources = {"requests": {"cpu": "1"}}
        p.status.phase = "Running"
        return p

    store.guaranteed_update("pods", pods[0].key, hot)
    hpa_ctl.resync()
    rs_ctl.reconcile_once()
    return store, [rs_ctl, hpa_ctl], {"pods": len(store.list("pods")[0])}


def test_autoscaler_drives_replicaset_as_in_jax():
    assert run_both(sc_hpa_end_to_end)["extra"]["pods"] == 2


# -- service accounts, TTL after finished, event TTL --------------------------


def sc_service_accounts(m):
    store = m.Store()
    for name in ("team-a", "team-b"):
        store.create("namespaces", _ns(m, name))
    ctl = m.ctl.ServiceAccountController(store, clock=m.Clock(0.0))
    ctl.sync_all()
    ctl.run_until_stable()
    extra = {"first": sorted(sa.key for sa in store.list("serviceaccounts")[0])}
    store.guaranteed_update("namespaces", "team-b", _terminating(50.0))
    store.delete("serviceaccounts", "team-b/default")
    store.delete("serviceaccounts", "team-a/default")
    store.create("namespaces", _ns(m, "team-c"))
    ctl.run_until_stable()
    extra["after"] = sorted(sa.key for sa in store.list("serviceaccounts")[0])
    return store, [ctl], extra


def _terminating(ts):
    def mutate(ns):
        ns.metadata.deletion_timestamp = ts
        return ns
    return mutate


def test_service_account_controller_matches_jax():
    out = run_both(sc_service_accounts)["extra"]
    boot = ["default/default", "kube-node-lease/default", "kube-public/default",
            "kube-system/default"]
    assert out["first"] == sorted(boot + ["team-a/default", "team-b/default"])
    assert out["after"] == sorted(boot + ["team-a/default", "team-c/default"])


def _job(m, name, ttl, condition=None, completion=None):
    job = m.wl.Job.from_dict({
        "metadata": {"name": name, "namespace": "default", "uid": m.types.new_uid()},
        "spec": {"template": {"spec": {"containers": [{"name": "c"}]}},
                 **({"ttlSecondsAfterFinished": ttl} if ttl is not None else {})}})
    if condition:
        job.status.conditions.append({"type": condition, "status": "True"})
        job.status.completion_time = completion
    return job


def sc_ttl(m):
    store = m.Store()
    clock = m.Clock(1000.0)
    store.create("jobs", _job(m, "done", 60, "Complete", 1000.0))
    store.create("jobs", _job(m, "failed", 30, "Failed", 990.0))
    store.create("jobs", _job(m, "legacy", 20, "Complete", None))
    store.create("jobs", _job(m, "running", 10))
    store.create("jobs", _job(m, "keep", None, "Complete", 900.0))
    ctl = m.ctl.TTLAfterFinishedController(store, clock=clock)
    ctl.sync_all()
    seen = []
    for step in (0, 21, 40, 1):
        clock.step(step)
        ctl.run_until_stable()
        seen.append(sorted(j.metadata.name for j in store.list("jobs")[0]))
    return store, [ctl], {"seen": seen}


def test_ttl_after_finished_matches_jax():
    seen = run_both(sc_ttl)["extra"]["seen"]
    assert seen[0] == ["done", "failed", "keep", "legacy", "running"]
    # failed at 990 + 30; legacy (no timestamp) 20 s from first sight
    assert seen[1] == ["done", "keep", "running"]
    assert seen[2] == seen[3] == ["keep", "running"]  # done at 1000 + 60


def sc_event_ttl(m):
    store = m.Store()
    clock = m.Clock(1000.0)
    rec = m.events.EventRecorder(store, component="t", clock=clock)
    rec.event(m.t.MakePod("p").obj(), "Normal", "Scheduled", "x")
    ctl = m.ctl.EventTTLController(store, clock=clock, event_ttl=60.0)
    ctl.sync_all()
    ctl.run_until_stable()
    clock.step(30)
    rec.event(m.t.MakePod("q").obj(), "Warning", "FailedScheduling", "y")
    seen = []
    for step in (0, 31, 30):
        clock.step(step)
        ctl.run_until_stable()
        seen.append(sorted(e.involved_name for e in store.list("events")[0]))
    return store, [ctl], {"seen": seen}


def test_event_ttl_matches_jax():
    assert run_both(sc_event_ttl)["extra"]["seen"] == [["p", "q"], ["q"], []]


# -- certificates ------------------------------------------------------------


class StubSigner:
    """A deterministic signer: what the signing controller calls (mint)."""

    def __init__(self, fail=False):
        self.fail = fail

    def mint(self, user, groups, expiration_seconds=3600):
        if self.fail:
            raise RuntimeError("signing key unavailable")
        return f"tok:{user}:{','.join(groups)}:{expiration_seconds}"


def make_csr(m, name="node-csr-n1", user="system:node:n1", groups=("system:nodes",),
             requestor="system:bootstrap:kadm", requestor_groups=("system:bootstrappers",),
             signer=None, expiration=None):
    return m.cert.CertificateSigningRequest(
        metadata=m.types.ObjectMeta(name=name), request={"user": user, "groups": list(groups)},
        signer_name=signer or m.cert.KUBE_APISERVER_CLIENT_KUBELET, username=requestor,
        groups=list(requestor_groups), expiration_seconds=expiration)


RECOGNIZER_CASES = [
    {}, {"signer": "kubernetes.io/kube-apiserver-client"},
    {"groups": ("system:masters",)}, {"groups": ("system:nodes", "system:masters")},
    {"user": "system:admin"}, {"requestor_groups": ("system:authenticated",)},
    {"requestor": "system:node:n1", "requestor_groups": ("system:nodes",)},
]


@pytest.mark.parametrize("i", range(len(RECOGNIZER_CASES)))
def test_recognize_node_client_matches_jax(i):
    kw = RECOGNIZER_CASES[i]
    got = tcsr.recognize_node_client(make_csr(pkg(True), **kw))
    assert got == jcsr.recognize_node_client(make_csr(pkg(False), **kw))


def sc_csr(m, case):
    store = m.Store()
    clock = m.Clock(1000.0)
    ctls = []
    if case == "approve_sign":
        store.create("certificatesigningrequests", make_csr(m, expiration=600))
        store.create("certificatesigningrequests", make_csr(
            m, name="client", signer=m.cert.KUBE_APISERVER_CLIENT,
            groups=("system:nodes", "system:authenticated")))
    elif case == "unrecognized":
        store.create("certificatesigningrequests",
                     make_csr(m, user="system:admin", groups=("system:masters",)))
    elif case == "foreign_signer":
        csr = make_csr(m, name="ext", signer="example.com/monitoring-agent")
        csr.conditions.append(m.cert.CSRCondition(type=m.cert.APPROVED))
        store.create("certificatesigningrequests", csr)
    elif case == "signing_error":
        store.create("certificatesigningrequests", make_csr(m))
    if case in ("approve_sign", "unrecognized", "foreign_signer", "signing_error"):
        approver = m.ctl.CSRApprovingController(store, clock=clock)
        signing = m.csr.CSRSigningController(store, StubSigner(case == "signing_error"),
                                             clock=clock)
        ctls = [approver, signing]
        for c in ctls:
            c.sync_all()
            c.run_until_stable()
        if case == "approve_sign":
            # a second approval pass and a client CSR approved by hand
            def approve(obj):
                obj.conditions.append(m.cert.CSRCondition(type=m.cert.APPROVED,
                                                          last_update_time=clock.now()))
                return obj

            store.guaranteed_update("certificatesigningrequests", "client", approve)
            for c in ctls:
                c.run_until_stable()
    else:  # the cleaner: a daemon-loop sweep and an explicit monitor()
        old = make_csr(m, name="old-denied")
        old.metadata.creation_timestamp = 1000.0
        old.conditions.append(m.cert.CSRCondition(type="Denied"))
        issued = make_csr(m, name="old-issued")
        issued.metadata.creation_timestamp = 900.0
        issued.conditions.append(m.cert.CSRCondition(type=m.cert.APPROVED))
        issued.certificate = "tok"
        pending = make_csr(m, name="fresh-pending")
        pending.metadata.creation_timestamp = 990.0
        for c in (old, issued, pending):
            store.create("certificatesigningrequests", c)
        cleaner = m.ctl.CSRCleanerController(store, clock=clock)
        ctls = [cleaner]
        cleaner.sync_all()
        cleaner.reconcile_once()
        clock.step(3650)
        if case == "cleaner_sweep":
            cleaner.reconcile_once()
        else:
            cleaner.monitor()
    csrs = store.list("certificatesigningrequests")[0]
    extra = {c.metadata.name: [c.approved, c.denied, c.certificate,
                               [(k.type, k.reason, k.message) for k in c.conditions]]
             for c in csrs}
    return store, ctls, extra


@pytest.mark.parametrize("case", ["approve_sign", "unrecognized", "foreign_signer",
                                  "signing_error", "cleaner_sweep", "cleaner_monitor"])
def test_csr_flow_matches_jax(case):
    out = run_both(sc_csr, case)["extra"]
    if case == "approve_sign":
        assert out["node-csr-n1"][2] == "tok:system:node:n1:system:nodes:600"
        assert out["client"][2] == "tok:system:node:n1:system:nodes:3600"
    elif case == "unrecognized":
        assert out["node-csr-n1"][1] and not out["node-csr-n1"][2]
    elif case == "foreign_signer":
        assert out["ext"][2] == ""
    elif case == "signing_error":
        assert out["node-csr-n1"][3][-1] == ["Failed", "SigningError",
                                              "signing key unavailable"]
    else:
        assert sorted(out) == ["fresh-pending"]


# -- API-service availability ---------------------------------------------------


class _Health(http.server.BaseHTTPRequestHandler):
    code = 200

    def do_GET(self):  # noqa: N802 (http.server's name)
        self.send_response(self.server.code)
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def backends():
    """Loopback health servers answering 200, 404 and 500, and a port with
    nothing listening, shared by both packages' runs."""
    servers = {}
    for code in (200, 404, 500):
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Health)
        srv.code = code
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers[code] = srv
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    closed = sock.getsockname()[1]
    sock.close()
    urls = {code: f"http://127.0.0.1:{srv.server_address[1]}" for code, srv in servers.items()}
    urls["closed"] = f"http://127.0.0.1:{closed}"
    yield urls
    for srv in servers.values():
        srv.shutdown()
        srv.server_close()


def sc_apiservices(m, urls):
    store = m.Store()
    for i, (key, url) in enumerate(sorted(urls.items(), key=lambda kv: str(kv[0]))):
        store.create("apiservices", m.APIService(group=f"g{i}.example.com", service_url=url))
    store.create("apiservices", m.APIService(group="local.example.com"))
    ctl = m.ctl.APIServiceAvailabilityController(store, clock=m.Clock(0.0))
    ctl.sync_all()
    ctl.run_until_stable()
    # re-probing an unchanged backend writes nothing
    for s in store.list("apiservices")[0]:
        ctl._mark(s.metadata.name)
    ctl.process()
    extra = {s.metadata.name: [s.available, s.available_message.split(":")[0]]
             for s in store.list("apiservices")[0]}
    return store, [ctl], extra


def test_apiservice_availability_matches_jax(backends):
    out = run_both(sc_apiservices, backends)["extra"]
    assert sorted(v[0] for v in out.values()) == [False, False, True, True, True]
    assert out["v1.local.example.com"] == [True, "Local"]
    assert [False, "unreachable"] in out.values()
    assert [False, "healthz returned 500"] in out.values()


# -- the smoke's services path at a small size ---------------------------------------


SVC_NODES, SVC_TEAMS, SVC_BASE, SVC_VOL = 50, 2, 8, 2


def sc_services_path(m):
    """The scenario of chip_smoke.svc_run at 50 nodes, 2 namespaces of 8 ->
    20 -> 8 api replicas, 2 + 2 volume and claim pods: the quotas, Services,
    Deployments and autoscalers, scale out and in on the metrics stand-in,
    the StatefulSet's claims bound and attached, the claim template's
    generated claims allocated, then one namespace torn down."""
    store = m.Store()
    clock = m.Clock(0.0)
    side = tt.fallback_workload(0, SVC_NODES, 0, zones=5, slice_every=10, devices_per_slice=8,
                                csi_limit=3, prebound=0, provision=0, static=0, dra_one=1,
                                dra_two=0, spread=0, api=m.api)
    for kind in ("nodes", "csinodes", "deviceclasses", "resourceslices"):
        for obj in side[kind]:
            store.create(kind, obj)
    store.create("storageclasses", m.st.StorageClass(metadata=m.types.ObjectMeta(name="fast"),
                                                     provisioner=tt.FALLBACK_DRIVER))
    for i in range(SVC_VOL):
        pv = m.st.PersistentVolume(metadata=m.types.ObjectMeta(name=f"pv-db-{i}"))
        pv.spec.capacity = 10 * 2**30
        pv.spec.access_modes = ["ReadWriteOnce"]
        pv.spec.storage_class_name = "fast"
        pv.spec.csi_driver = tt.FALLBACK_DRIVER
        store.create("persistentvolumes", pv)
    sched = m.batch(store, clock)
    sched.sync()
    demand, running = {}, {}

    def usage(pod):
        ns = pod.metadata.namespace
        if pod.status.phase != "Running" or ns not in demand or not running.get(ns):
            return None
        return demand[ns] // running[ns]

    hpa = m.ctl.HorizontalPodAutoscalerController(store, clock=clock, usage_fn=usage)
    nsc = m.ctl.NamespaceController(store, clock=clock)
    ctls = [nsc, m.ctl.ServiceAccountController(store, clock=clock),
            m.ctl.DeploymentController(store, clock=clock),
            m.ctl.ReplicaSetController(store, clock=clock),
            m.ctl.StatefulSetController(store, clock=clock),
            m.ctl.PersistentVolumeBinder(store, clock=clock),
            m.ctl.ResourceClaimController(store, clock=clock),
            m.ctl.GarbageCollector(store, clock=clock),
            m.ctl.ResourceQuotaController(store, clock=clock),
            m.ctl.EndpointSliceController(store, clock=clock),
            hpa, m.ctl.AttachDetachController(store, clock=clock)]
    for c in ctls:
        c.sync_all()
        c.reconcile_once()

    def drive(rounds):
        for _ in range(rounds):
            running.clear()
            for p in store.list("pods")[0]:
                if p.status.phase == "Running":
                    running[p.metadata.namespace] = running.get(p.metadata.namespace, 0) + 1
            for c in ctls:
                c.reconcile_once()
            hpa.resync()
            sched.run_until_idle()
            for c in ctls:
                c.pump()
            run_bound_pods(store)
            clock.step(1.0)

    def deployment(ns, name, replicas, template=""):
        spec = {"containers": [{"name": "c", "resources": {
            "requests": {"cpu": "500m", "memory": "1Gi"}}}]}
        if template:
            spec["resourceClaims"] = [{"name": "gpu", "resourceClaimTemplateName": template}]
        return m.wl.Deployment.from_dict({
            "metadata": {"name": name, "namespace": ns, "uid": m.types.new_uid()},
            "spec": {"replicas": replicas, "selector": {"matchLabels": {"app": name}},
                     "template": {"metadata": {"labels": {"app": name}}, "spec": spec}}})

    teams = [f"team-{i}" for i in range(SVC_TEAMS)]
    for ns in teams:
        store.create("namespaces", _ns(m, ns))
        store.create("resourcequotas", m.Quota.from_dict({
            "metadata": {"name": "quota", "namespace": ns, "uid": m.types.new_uid()},
            "spec": {"hard": {"requests.cpu": "40", "requests.memory": "80Gi", "pods": "80",
                              "count/services": "5"}}}))
        store.create("services", _service(m, name="api", ns=ns, app="api"))
        store.create("deployments", deployment(ns, "api", SVC_BASE))
        store.create("horizontalpodautoscalers", m.HPA(
            metadata=m.types.ObjectMeta(name="api", namespace=ns, uid=m.types.new_uid()),
            target_kind="Deployment", target_name="api", min_replicas=SVC_BASE,
            max_replicas=4 * SVC_BASE, target_cpu_utilization=50))

    def replicas():
        return [store.get("horizontalpodautoscalers", f"{ns}/api").desired_replicas
                for ns in teams]

    drive(3)
    seen = {"setup": replicas()}
    for ns in teams:
        demand[ns] = SVC_BASE * 625
    drive(4)
    seen["scale_out"] = replicas()
    for ns in teams:
        demand[ns] = SVC_BASE * 250
    clock.step(301.0)
    drive(3)
    seen["scale_in"] = replicas()
    tmpl = m.dra.ResourceClaimTemplate(requests=[m.dra.DeviceRequest(
        name="gpu", device_class_name=tt.FALLBACK_DEVICE_CLASS, count=1)])
    tmpl.metadata.name, tmpl.metadata.namespace = "gpu-one", teams[0]
    store.create("resourceclaimtemplates", tmpl)
    store.create("statefulsets", m.wl.StatefulSet.from_dict({
        "metadata": {"name": "db", "namespace": teams[0], "uid": m.types.new_uid()},
        "spec": {"replicas": SVC_VOL, "serviceName": "db", "podManagementPolicy": "Parallel",
                 "selector": {"matchLabels": {"app": "db"}},
                 "template": {"metadata": {"labels": {"app": "db"}},
                              "spec": {"containers": [{"name": "c", "resources": {
                                  "requests": {"cpu": "500m", "memory": "1Gi"}}}]}},
                 "volumeClaimTemplates": [{"metadata": {"name": "data"}, "spec": {
                     "accessModes": ["ReadWriteOnce"], "storageClassName": "fast",
                     "resources": {"requests": {"storage": "10Gi"}}}}]}}))
    store.create("deployments", deployment(teams[0], "infer", SVC_VOL, "gpu-one"))
    drive(3)
    seen["claims"] = sorted((c.metadata.name, c.allocation is not None)
                            for c in store.list("resourceclaims")[0])
    seen["attachments"] = len(store.list("volumeattachments")[0])
    nsc.mark_terminating(teams[-1])
    drive(3)
    seen["namespaces"] = sorted(n.metadata.name for n in store.list("namespaces")[0])
    return store, ctls, seen


def test_services_path_matches_jax(dra_gate):
    out = run_both(sc_services_path)
    seen = out["extra"]
    peak = SVC_BASE * 5 // 2
    assert seen["setup"] == [SVC_BASE] * SVC_TEAMS
    assert seen["scale_out"] == [peak] * SVC_TEAMS
    assert seen["scale_in"] == [SVC_BASE] * SVC_TEAMS
    assert len(seen["claims"]) == SVC_VOL and all(a for _, a in seen["claims"])
    assert seen["attachments"] == SVC_VOL
    assert seen["namespaces"] == [f"team-{i}" for i in range(SVC_TEAMS - 1)]
    assert not any(k.startswith(f"team-{SVC_TEAMS - 1}/") for k in out["placements"])
    assert all(out["placements"].values())
    slices = out["dump"]["endpointslices"]
    assert sorted(slices) == ["team-0/api-0"]
    assert len(slices["team-0/api-0"]["endpoints"]) == SVC_BASE
