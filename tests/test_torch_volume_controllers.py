"""The port's PV binder, attach/detach and resource-claim controllers
against the JAX package's.

Each scenario follows a case of tests/test_volume_controllers.py (the PV
controller's binding, release and reclaim; the attach/detach reconciler;
template claims generated, recorded, reaped and regenerated; the serial
scheduler resolving a template claim through the DRA plugin) and runs on
both packages through the same call sequence, compared exactly as in
tests/test_torch_infra_controllers.py: the normalized store dump, the
event sequence with its resource versions, the {pod: node} map and the
reconcile counts.
"""

import pytest

from kubernetes_tpu.scheduler import Framework as JFramework
from kubernetes_tpu.scheduler.plugins import default_plugins as jdefault
from kubernetes_tpu.scheduler.serial import Scheduler as JScheduler
from kubernetes_tpu_torch.controllers.volume import attachment_name as tattachment
from kubernetes_tpu_torch.controllers.resourceclaim import claim_name_for as tclaim_name
from kubernetes_tpu_torch.scheduler.plugins import default_plugins as tdefault
from kubernetes_tpu_torch.scheduler.runtime import Framework as TFramework
from kubernetes_tpu_torch.scheduler.serial import Scheduler as TScheduler
from kubernetes_tpu.controllers.volume import attachment_name as jattachment
from kubernetes_tpu.controllers.resourceclaim import claim_name_for as jclaim_name
from test_torch_infra_controllers import dra_gate, run_both  # noqa: F401 (a fixture)


def make_pv(m, name, capacity, class_name="", modes=("ReadWriteOnce",), reclaim="Retain",
            claim_ref=""):
    return m.st.PersistentVolume.from_dict({
        "metadata": {"name": name},
        "spec": {"capacity": {"storage": capacity}, "accessModes": list(modes),
                 **({"storageClassName": class_name} if class_name else {}),
                 "persistentVolumeReclaimPolicy": reclaim,
                 **({"claimRef": {"namespace": claim_ref.split("/")[0],
                                  "name": claim_ref.split("/")[1]}} if claim_ref else {})}})


def make_pvc(m, name, request, class_name=None, modes=("ReadWriteOnce",), volume=""):
    spec = {"accessModes": list(modes), "resources": {"requests": {"storage": request}}}
    if class_name is not None:
        spec["storageClassName"] = class_name
    c = m.st.PersistentVolumeClaim.from_dict(
        {"metadata": {"name": name, "namespace": "default"}, "spec": spec})
    c.spec.volume_name = volume
    return c


def _class(m, name, mode="Immediate", default=False):
    meta = {"name": name}
    if default:
        meta["annotations"] = {"storageclass.kubernetes.io/is-default-class": "true"}
    return m.st.StorageClass.from_dict({"metadata": meta, "volumeBindingMode": mode})


def _binder_steps(m, case):
    """(setup, then) lists of store writes, one list per binder pass."""
    pv, pvc = (lambda *a, **k: ("persistentvolumes", make_pv(m, *a, **k)),
               lambda *a, **k: ("persistentvolumeclaims", make_pvc(m, *a, **k)))
    sc = lambda *a, **k: ("storageclasses", _class(m, *a, **k))  # noqa: E731
    delete = lambda kind, key: ("delete", kind, key)  # noqa: E731
    return {
        "binds_without_pod": [[pv("pv-a", 10_000_000_000), pvc("data", 5_000_000_000)]],
        "smallest_wins": [[pv("pv-big", 100), pv("pv-small", 10), pv("pv-tiny", 4),
                           pvc("c", 8)]],
        "class_must_match": [[pv("pv-fast", 10, "fast"), pvc("c", 5, "")],
                             [pvc("c2", 5, "fast")]],
        "access_modes": [[pv("pv-rwo", 10), pvc("c", 5, modes=("ReadWriteMany",))]],
        "prebound_pv": [[pv("pv-pre", 10, claim_ref="default/mine"), pvc("mine", 5)]],
        "prebound_waits": [[pv("pv-wait", 10, reclaim="Delete", claim_ref="default/later")],
                           [pvc("later", 5)]],
        "missing_pv": [[pvc("c", 5, volume="does-not-exist")]],
        "claim_before_pv": [[pvc("c", 5, volume="pv-late")], [pv("pv-late", 10)]],
        "wffc_left": [[sc("wffc", "WaitForFirstConsumer"), pv("pv-w", 10, "wffc"),
                       pvc("c", 5, "wffc")]],
        "release_retain": [[pv("pv-r", 10), pvc("c", 5)],
                           [delete("persistentvolumeclaims", "default/c")]],
        "reclaim_delete": [[pv("pv-d", 10, reclaim="Delete"), pvc("c", 5)],
                           [delete("persistentvolumeclaims", "default/c")]],
        "default_class": [[sc("standard", default=True), pv("pv-s", 10, "standard"),
                           pvc("c", 5, None)]],
    }[case]


BINDER_CASES = ["binds_without_pod", "smallest_wins", "class_must_match", "access_modes",
                "prebound_pv", "prebound_waits", "missing_pv", "claim_before_pv", "wffc_left",
                "release_retain", "reclaim_delete", "default_class"]


def sc_binder(m, case):
    store = m.Store()
    binder = m.ctl.PersistentVolumeBinder(store, clock=m.Clock(0.0))
    binder.sync_all()
    seen = []
    for writes in _binder_steps(m, case):
        for w in writes:
            if w[0] == "delete":
                store.delete(w[1], w[2])
            else:
                store.create(*w)
        binder.run_until_stable()
        seen.append(sorted([c.key, c.spec.volume_name, c.phase]
                           for c in store.list("persistentvolumeclaims")[0])
                    + sorted([v.metadata.name, v.spec.claim_ref, v.phase]
                             for v in store.list("persistentvolumes")[0]))
    return store, [binder], {"seen": seen}


WANT = {
    "binds_without_pod": ["default/data", "pv-a", "Bound"],
    "smallest_wins": ["default/c", "pv-small", "Bound"],
    "access_modes": ["default/c", "", "Pending"],
    "prebound_pv": ["default/mine", "pv-pre", "Bound"],
    "missing_pv": ["default/c", "does-not-exist", "Pending"],
    "wffc_left": ["default/c", "", "Pending"],
    "default_class": ["default/c", "pv-s", "Bound"],
}


@pytest.mark.parametrize("case", BINDER_CASES)
def test_pv_binder_matches_jax(case):
    seen = run_both(sc_binder, case)["extra"]["seen"]
    if case in WANT:
        assert WANT[case] in seen[-1]
    elif case == "class_must_match":
        assert ["default/c", "", "Pending"] in seen[-1]
        assert ["default/c2", "pv-fast", "Bound"] in seen[-1]
    elif case == "prebound_waits":
        assert ["pv-wait", "default/later", "Available"] in seen[0]
        assert ["default/later", "pv-wait", "Bound"] in seen[1]
    elif case == "claim_before_pv":
        assert ["default/c", "pv-late", "Bound"] in seen[1]
    elif case == "release_retain":
        assert seen[1] == [["pv-r", "default/c", "Released"]]
    else:  # reclaim_delete
        assert seen[1] == []


def sc_attach_detach(m):
    store = m.Store()
    binder = m.ctl.PersistentVolumeBinder(store, clock=m.Clock(0.0))
    binder.sync_all()
    ad = m.ctl.AttachDetachController(store, clock=m.Clock(0.0))
    ad.sync_all()
    for n in ("n1", "n2"):
        store.create("nodes", m.t.MakeNode(n).capacity({"cpu": "8"}).obj())
    pv = make_pv(m, "pv-a", 10)
    pv.spec.csi_driver = "csi.example.com"
    store.create("persistentvolumes", pv)
    store.create("persistentvolumes", make_pv(m, "pv-b", 10))
    store.create("persistentvolumeclaims", make_pvc(m, "data", 5))
    store.create("persistentvolumeclaims", make_pvc(m, "logs", 6))
    binder.run_until_stable()
    for name, claim, node in (("p", "data", "n1"), ("q", "logs", "n2"), ("r", "data", "n2"),
                              ("unbound", "logs", "")):
        store.create("pods", m.t.MakePod(name).req({"cpu": "100m"}).pvc(claim).obj())
        if node:
            store.bind("default", name, node)
    ad.run_until_stable()
    seen = [sorted((va.metadata.name, va.attacher, va.attached)
                   for va in store.list("volumeattachments")[0])]
    store.delete("pods", "default/p")
    store.delete("pods", "default/q")
    ad.run_until_stable()
    seen.append(sorted(va.metadata.name for va in store.list("volumeattachments")[0]))
    return store, [binder, ad], {"seen": seen}


def test_attach_detach_matches_jax():
    seen = run_both(sc_attach_detach)["extra"]["seen"]
    assert [v[0] for v in seen[0]] == ["va-pv-a-n1", "va-pv-a-n2", "va-pv-b-n2"]
    assert ["va-pv-a-n1", "csi.example.com", True] in seen[0]
    assert seen[1] == ["va-pv-a-n2"]
    assert tattachment("pv", "n") == jattachment("pv", "n")


def _template(m, store, name="gpu-tmpl"):
    t = m.dra.ResourceClaimTemplate(requests=[m.dra.DeviceRequest(
        name="gpu", device_class_name="gpu.example.com")])
    t.metadata.name, t.metadata.namespace = name, "default"
    store.create("resourceclaimtemplates", t)


def _claiming_pod(m, name):
    pod = m.t.MakePod(name).req({"cpu": "100m"}).obj()
    pod.spec.resource_claim_templates = [("gpu", "gpu-tmpl")]
    return pod


def sc_claims(m, case):
    store = m.Store()
    rc = m.ctl.ResourceClaimController(store, clock=m.Clock(0.0))
    rc.sync_all()
    ctls = [rc]
    if case == "late_template":
        store.create("pods", _claiming_pod(m, "early"))
        rc.run_until_stable()
    _template(m, store)
    if case != "late_template":
        store.create("pods", _claiming_pod(m, {"spawn": "worker", "orphan": "gone",
                                               "recreated": "w3", "sweep": "w2"}[case]))
    rc.run_until_stable()
    extra = {"first": sorted(c.key for c in store.list("resourceclaims")[0])}
    if case == "orphan":
        store.delete("pods", "default/gone")
        rc.run_until_stable()
    elif case == "recreated":
        store.delete("pods", "default/w3")
        store.create("pods", _claiming_pod(m, "w3"))  # before the controller reaps
        rc.run_until_stable()
    elif case == "sweep":
        store.delete("pods", "default/w2")
        # a fresh controller that never saw the delete: only the sweep finds
        # the orphan
        rc2 = m.ctl.ResourceClaimController(store, clock=m.Clock(0.0))
        rc2.sync_all()
        rc2._dirty.clear()
        rc2.reap_orphans()
        ctls.append(rc2)
    extra["claims"] = sorted((c.key, c.metadata.owner_references[0]["name"],
                              c.requests[0].device_class_name)
                             for c in store.list("resourceclaims")[0])
    extra["statuses"] = sorted((p.key, sorted(p.status.resource_claim_statuses.items()))
                               for p in store.list("pods")[0])
    return store, ctls, extra


@pytest.mark.parametrize("case", ["spawn", "orphan", "recreated", "sweep", "late_template"])
def test_resource_claim_controller_matches_jax(case):
    out = run_both(sc_claims, case)["extra"]
    want = {"spawn": [["default/worker-gpu", "worker", "gpu.example.com"]], "orphan": [],
            "recreated": [["default/w3-gpu", "w3", "gpu.example.com"]], "sweep": [],
            # the JAX controller watches no templates: a pod created before
            # its template waits for its own next event (ROADMAP queue 3)
            "late_template": []}[case]
    assert out["claims"] == want
    assert tclaim_name("p", "gpu") == jclaim_name("p", "gpu") == "p-gpu"


def sc_template_scheduling(m):
    """test_scheduler_resolves_template_claim: the pod waits for its
    generated claim, then the DRA plugin allocates it once the controller
    stamps status.resourceClaimStatuses."""
    store = m.Store()
    _template(m, store)
    dc = m.dra.DeviceClass()
    dc.metadata.name = "gpu.example.com"
    store.create("deviceclasses", dc)
    store.create("nodes", m.t.MakeNode("n1").capacity(
        {"cpu": "8", "memory": "16Gi", "pods": "10"}).obj())
    sl = m.dra.ResourceSlice(node_name="n1", devices=[m.dra.Device(name="gpu0")])
    sl.metadata.name = "n1-slice"
    store.create("resourceslices", sl)
    rc = m.ctl.ResourceClaimController(store, clock=m.Clock(0.0))
    rc.sync_all()
    clock = m.Clock(0.0)
    sched = (TScheduler(store, TFramework(tdefault()), clock=clock) if m.port
             else JScheduler(store, JFramework(jdefault()), clock=clock))
    sched.sync()
    store.create("pods", _claiming_pod(m, "worker"))
    rc.run_until_stable()
    sched.run_until_idle()
    claim = store.get("resourceclaims", "default/worker-gpu")
    return store, [rc], {"node": store.get("pods", "default/worker").spec.node_name,
                         "allocated": claim.allocation.node_name if claim.allocation else None}


def test_scheduler_resolves_template_claim(dra_gate):  # noqa: F811 (the fixture)
    out = run_both(sc_template_scheduling)["extra"]
    assert out == {"node": "n1", "allocated": "n1"}
