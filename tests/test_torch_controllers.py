"""The port's workload control loop against the JAX package's.

Each scenario follows a case of tests/test_controllers.py or
tests/test_infra_controllers.py (ReplicaSet, Deployment rollout, rollback
and scale down, node lifecycle, garbage collection, taint eviction,
disruption budgets, the full control loop through the batch scheduler). It
runs once on each package through the same call sequence on a FakeClock,
with seeded objects from each package's MakePod/MakeNode, and the two runs
are compared exactly: the normalized store dump (every object's `to_dict`,
uids mapped by mint order and the uid tail in controller-made names
masked), the store's event sequence with its resource versions, the
{pod: node} map and each controller's reconcile counts.

No node agent is ported yet (ROADMAP item 7h): pods move to Running through
the stand-in `testing.run_bound_pods`, and nodes heartbeat through
`testing.renew_node_leases`, on both packages alike.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu.api.policy as jpolicy
import kubernetes_tpu.api.serialize as jser
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.api.workloads as jwl
import kubernetes_tpu.controllers as jctl
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.api.policy as tpolicy
import kubernetes_tpu_torch.api.serialize as tser
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.api.workloads as twl
import kubernetes_tpu_torch.controllers as tctl
import kubernetes_tpu_torch.testing as ttesting
from kubernetes_tpu.api.labels import Selector as JSelector
from kubernetes_tpu.scheduler import Framework as JFramework
from kubernetes_tpu.scheduler.batch import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.plugins import default_plugins as jdefault
from kubernetes_tpu.store import APIStore as JStore
from kubernetes_tpu.store import NotFoundError as JNotFound
from kubernetes_tpu.utils import FakeClock as JClock
from kubernetes_tpu_torch.api.labels import Selector as TSelector
from kubernetes_tpu_torch.scheduler.runtime import Framework as TFramework
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.plugins import default_plugins as tdefault
from kubernetes_tpu_torch.store import APIStore as TStore
from kubernetes_tpu_torch.store import NotFoundError as TNotFound
from kubernetes_tpu_torch.testing import (history_lines, normalize_uids, normalized_dump,
                                          reconcile_counts, renew_node_leases,
                                          run_bound_pods)
from kubernetes_tpu_torch.utils import FakeClock as TClock


def _pkg(port: bool):
    if port:
        return SimpleNamespace(
            port=True, Store=TStore, NotFound=TNotFound, ctl=tctl, wl=twl, types=ttypes,
            PDB=tpolicy.PodDisruptionBudget, Selector=TSelector, t=ttesting, Clock=TClock,
            ser=tser, session=ttypes._uid_session,
            batch=lambda store, clock: TBatch(store, TFramework(tdefault()), device="cpu",
                                              solver="auto", pipeline_binds=False,
                                              clock=clock))
    return SimpleNamespace(
        port=False, Store=JStore, NotFound=JNotFound, ctl=jctl, wl=jwl, types=jtypes,
        PDB=jpolicy.PodDisruptionBudget, Selector=JSelector, t=jtesting, Clock=JClock,
        ser=jser, session=jtypes._uid_session,
        batch=lambda store, clock: JBatch(store, JFramework(jdefault()), solver="auto",
                                          pipeline_binds=False, clock=clock))


def _outcome(m, store, controllers, extra):
    dump = normalized_dump(store, m.ser.to_dict, m.session)
    return {
        "dump": dump,
        "history": history_lines(store, m.session),
        "placements": {k: w["spec"].get("nodeName", "")
                       for k, w in dump.get("pods", {}).items()},
        "counts": reconcile_counts(controllers),
        "extra": json.loads(normalize_uids(json.dumps(extra), m.session)),
    }


def run_both(scenario, *args):
    """Run `scenario(m, *args) -> (store, controllers, extra)` on both
    packages and assert the outcomes equal; return the port's."""
    got = {}
    for name, port in (("jax", False), ("port", True)):
        m = _pkg(port)
        store, controllers, extra = scenario(m, *args)
        got[name] = _outcome(m, store, controllers, extra)
    for field in ("dump", "history", "placements", "counts", "extra"):
        assert got["port"][field] == got["jax"][field], field
    return got["port"]


def make_rs(m, name="web", replicas=3, cpu="100m"):
    labels = {"app": name}
    return m.wl.ReplicaSet.from_dict({
        "metadata": {"name": name, "uid": m.types.new_uid()},
        "spec": {"replicas": replicas, "selector": {"matchLabels": labels},
                 "template": {"metadata": {"labels": labels},
                              "spec": {"containers": [{"name": "c", "resources": {
                                  "requests": {"cpu": cpu}}}]}}},
    })


def make_dep(m, name="api", replicas=4, image="v1", cpu="", surge=1, unavailable=0,
             strategy="RollingUpdate"):
    res = {"resources": {"requests": {"cpu": cpu}}} if cpu else {}
    return m.wl.Deployment.from_dict({
        "metadata": {"name": name, "uid": m.types.new_uid()},
        "spec": {"replicas": replicas, "selector": {"matchLabels": {"app": name}},
                 "strategy": {"type": strategy,
                              "rollingUpdate": {"maxSurge": surge,
                                                "maxUnavailable": unavailable}},
                 "template": {"metadata": {"labels": {"app": name}},
                              "spec": {"containers": [{"name": "c", "image": image,
                                                       **res}]}}},
    })


def _set(attr_path, value):
    """A guaranteed_update mutation setting obj.<a>.<b>... = value."""
    def mutate(obj):
        *head, last = attr_path
        target = obj
        for a in head:
            target = getattr(target, a)
        setattr(target, last, value)
        return obj
    return mutate


def _image(value):
    def mutate(d):
        d.spec.template.spec.containers[0].image = value
        return d
    return mutate


def _pods(store):
    return sorted(p.key for p in store.list("pods")[0])


# -- ReplicaSet ---------------------------------------------------------------


def sc_rs(m, case):
    store = m.Store()
    rsc = m.ctl.ReplicaSetController(store, clock=m.Clock(100.0))
    rsc.sync_all()
    store.create("replicasets", make_rs(m, replicas=3 if case == "scale" else 2))
    rsc.run_until_stable()
    extra = {"first": _pods(store)}
    if case == "scale":
        store.guaranteed_update("replicasets", "default/web", _set(("spec", "replicas"), 1))
    elif case == "replace":
        store.delete("pods", _pods(store)[0])
    else:  # cascade
        store.delete("replicasets", "default/web")
    rsc.run_until_stable()
    extra["after"] = _pods(store)
    owners = {r["kind"] for p in store.list("pods")[0] for r in p.metadata.owner_references}
    extra["owner_kinds"] = sorted(owners)
    return store, [rsc], extra


@pytest.mark.parametrize("case", ["scale", "replace", "cascade"])
def test_replicaset_matches_jax(case):
    out = run_both(sc_rs, case)
    n = {"scale": 1, "replace": 2, "cascade": 0}[case]
    assert len(out["extra"]["after"]) == n
    if n:
        assert out["extra"]["owner_kinds"] == ["ReplicaSet"]


# -- Deployment ---------------------------------------------------------------


def _run_all(store):
    """tests/test_controllers.py's hand step with no scheduler: every pod
    not Running is marked Running, bound or not."""
    for p in store.list("pods")[0]:
        if p.status.phase != "Running":
            store.update_pod_status(p.metadata.namespace, p.metadata.name,
                                    lambda st: setattr(st, "phase", "Running"))


def _reconcile(ctls, rounds, store=None, run=run_bound_pods):
    for _ in range(rounds):
        for c in ctls:
            c.reconcile_once()
        if store is not None:
            run(store)


def sc_deployment(m, case):
    store = m.Store()
    clock = m.Clock(100.0)
    dc = m.ctl.DeploymentController(store, clock=clock)
    rsc = m.ctl.ReplicaSetController(store, clock=clock)
    ctls = [dc, rsc]
    for c in ctls:
        c.sync_all()
    strategy = "Recreate" if case == "recreate" else "RollingUpdate"
    store.create("deployments", make_dep(m, replicas=6 if case == "scale_down" else 4,
                                         strategy=strategy))
    running = store if case in ("rollout", "rollback", "recreate") else None
    _reconcile(ctls, 5, running, _run_all)
    extra = {"initial": _pods(store)}
    if case == "scale_down":
        store.guaranteed_update("deployments", "default/api", _set(("spec", "replicas"), 2))
        _reconcile(ctls, 5)
    else:
        store.guaranteed_update("deployments", "default/api", _image("v2"))
        _reconcile(ctls, 16, store, _run_all)
        if case == "rollback":
            store.guaranteed_update("deployments", "default/api", _image("v1"))
            _reconcile(ctls, 16, store, _run_all)
    rses = store.list("replicasets")[0]
    extra["rs"] = sorted((rs.metadata.name, rs.spec.template.spec.containers[0].image,
                          rs.spec.replicas,
                          rs.metadata.annotations.get("deployment.kubernetes.io/revision"))
                         for rs in rses)
    extra["pods"] = _pods(store)
    return store, ctls, extra


@pytest.mark.parametrize("case", ["rollout", "rollback", "scale_down", "recreate"])
def test_deployment_matches_jax(case):
    out = run_both(sc_deployment, case)
    rs = out["extra"]["rs"]
    live = [r for r in rs if r[2] > 0]
    assert len(live) == 1
    want_image = {"rollout": "v2", "rollback": "v1", "scale_down": "v1", "recreate": "v2"}
    assert live[0][1] == want_image[case]
    assert len(out["extra"]["pods"]) == (2 if case == "scale_down" else 4)
    if case == "rollback":
        # the re-activated template takes the next revision
        assert live[0][3] == "3"
    assert all("pod-template-hash" in w["metadata"]["labels"]
               for w in out["dump"]["pods"].values())


# -- node lifecycle ------------------------------------------------------------


def sc_node_lifecycle(m):
    clock = m.Clock(100.0)
    store = m.Store()
    store.create("nodes", m.t.MakeNode("n0").capacity({"cpu": "4", "memory": "8Gi"}).obj())
    renew_node_leases(store, m.wl.Lease, ["n0"], clock.now())
    nlc = m.ctl.NodeLifecycleController(store, clock=clock, grace_period=40.0)
    nlc.sync_all()
    nlc.monitor()
    tolerant = m.t.MakePod("tolerant").req({"cpu": "1"}).toleration(
        "node.kubernetes.io/not-ready", operator="Exists", effect="NoExecute").obj()
    store.create("pods", m.t.MakePod("victim").req({"cpu": "1"}).obj())
    store.create("pods", tolerant)
    store.bind("default", "victim", "n0")
    store.bind("default", "tolerant", "n0")
    clock.step(41)
    nlc.monitor()
    node = store.get("nodes", "n0")
    extra = {"tainted": sorted((t.key, t.effect) for t in node.spec.taints),
             "pods_while_down": _pods(store)}
    renew_node_leases(store, m.wl.Lease, ["n0"], clock.now())
    nlc.monitor()
    extra["taints_after"] = [t.key for t in store.get("nodes", "n0").spec.taints]
    extra["ready"] = {c.type: c.status for c in store.get("nodes", "n0").status.conditions}
    return store, [nlc], extra


def test_node_lifecycle_matches_jax():
    out = run_both(sc_node_lifecycle)
    assert ["node.kubernetes.io/not-ready", "NoExecute"] in out["extra"]["tainted"]
    assert out["extra"]["pods_while_down"] == ["default/tolerant"]
    assert out["extra"]["taints_after"] == [] and out["extra"]["ready"] == {"Ready": "True"}


# -- garbage collector --------------------------------------------------------


def sc_gc(m, case):
    store = m.Store()
    rs = make_rs(m, name="rs", replicas=1)
    store.create("replicasets", rs)
    pod = m.t.MakePod("owned").obj()
    uid = rs.metadata.uid if case == "orphan" else "old-uid"
    pod.metadata.owner_references = [{"kind": "ReplicaSet", "name": "rs", "uid": uid,
                                      "controller": True}]
    store.create("pods", pod)
    store.create("pods", m.t.MakePod("free").obj())
    gc = m.ctl.GarbageCollector(store, clock=m.Clock(0.0))
    gc.sync_all()
    swept = [gc.sweep()]
    if case == "orphan":
        store.delete("replicasets", "default/rs")
        swept.append(gc.sweep())
    swept.append(gc.reconcile_once())
    return store, [gc], {"swept": swept, "pods": _pods(store)}


@pytest.mark.parametrize("case", ["orphan", "uid_mismatch"])
def test_garbage_collector_matches_jax(case):
    out = run_both(sc_gc, case)
    assert out["extra"]["pods"] == ["default/free"]


def sc_gc_cascade(m):
    """Deployment deleted: the GC removes its ReplicaSets (owner gone), then
    their pods, through events and its periodic sweep."""
    store = m.Store()
    clock = m.Clock(0.0)
    ctls = [m.ctl.DeploymentController(store, clock=clock),
            m.ctl.ReplicaSetController(store, clock=clock),
            m.ctl.GarbageCollector(store, clock=clock)]
    for c in ctls:
        c.sync_all()
    for name in ("a", "b"):
        store.create("deployments", make_dep(m, name=name, replicas=3))
    _reconcile(ctls, 4, store)
    store.delete("deployments", "default/a")
    for _ in range(4):
        clock.step(31)
        _reconcile(ctls[2:], 1)
    return store, ctls, {"pods": _pods(store),
                         "rs": sorted(r.metadata.name for r in store.list("replicasets")[0])}


def test_gc_cascade_through_owner_references_matches_jax():
    out = run_both(sc_gc_cascade)
    assert out["extra"]["pods"] and all(k.startswith("default/b-") for k in out["extra"]["pods"])
    assert len(out["extra"]["rs"]) == 1


# -- disruption ------------------------------------------------------------------


DISRUPTION_CASES = {
    "min_available_absolute": (dict(min_available=3), 5, True),
    "max_unavailable_percent": (dict(max_unavailable="20%"), 10, True),
    "unbound_not_healthy": (dict(min_available=1), 3, False),
}


def sc_disruption(m, case):
    store = m.Store()
    ctl = m.ctl.DisruptionController(store, clock=m.Clock(0.0))
    ctl.sync_all()
    if case == "pod_events_retrigger":
        kw, n, bound = dict(min_available=1), 0, True
    else:
        kw, n, bound = DISRUPTION_CASES[case]

    def pods(k, start=0):
        for i in range(start, start + k):
            b = m.t.MakePod(f"w{i}").labels({"app": "web"})
            store.create("pods", (b.node("n1") if bound else b).obj())

    pods(n)
    store.create("poddisruptionbudgets", m.PDB(
        metadata=m.types.ObjectMeta(name="pdb", namespace="default"),
        selector=m.Selector.from_match_labels({"app": "web"}), **kw))
    ctl.reconcile_once()
    allowed = [store.get("poddisruptionbudgets", "default/pdb").disruptions_allowed]
    if case == "pod_events_retrigger":
        pods(2)
        ctl.reconcile_once()
        allowed.append(store.get("poddisruptionbudgets", "default/pdb").disruptions_allowed)
    return store, [ctl], {"allowed": allowed}


@pytest.mark.parametrize("case,want", [("min_available_absolute", [2]),
                                       ("max_unavailable_percent", [2]),
                                       ("unbound_not_healthy", [0]),
                                       ("pod_events_retrigger", [0, 1])])
def test_disruption_matches_jax(case, want):
    assert run_both(sc_disruption, case)["extra"]["allowed"] == want


# -- taint eviction --------------------------------------------------------------


UNREACHABLE = "node.kubernetes.io/unreachable"
PRESSURE = "node.kubernetes.io/memory-pressure"


def sc_taint_eviction(m, case):
    store = m.Store()
    clock = m.Clock(100.0)
    store.create("nodes", m.t.MakeNode("n1").obj())
    ctl = m.ctl.TaintEvictionController(store, clock=clock)
    ctl.sync_all()
    Tol, Taint = m.types.Toleration, m.types.Taint
    pod = m.t.MakePod("p").node("n1").obj()
    tols = {
        "untolerated": [],
        "toleration_seconds": [Tol(key=UNREACHABLE, operator="Exists", effect="NoExecute",
                                   toleration_seconds=30)],
        "forever": [Tol(key=UNREACHABLE, operator="Exists", effect="NoExecute")],
        "tighten": [Tol(key=UNREACHABLE, operator="Exists", effect="NoExecute",
                        toleration_seconds=600),
                    Tol(key=PRESSURE, operator="Exists", effect="NoExecute",
                        toleration_seconds=5)],
        "loosen": [Tol(key=UNREACHABLE, operator="Exists", effect="NoExecute",
                       toleration_seconds=600),
                   Tol(key=PRESSURE, operator="Exists", effect="NoExecute",
                       toleration_seconds=5)],
        "cancel": [Tol(key=UNREACHABLE, operator="Exists", effect="NoExecute",
                       toleration_seconds=60)],
    }[case]
    pod.spec.tolerations = tols
    store.create("pods", pod)

    def taints(keys):
        return _set(("spec", "taints"), [Taint(key=k, effect="NoExecute") for k in keys])

    alive = []

    def step(seconds):
        clock.step(seconds)
        ctl.tick()
        alive.append(_pods(store))

    store.guaranteed_update("nodes", "n1", taints(
        [UNREACHABLE, PRESSURE] if case == "loosen" else [UNREACHABLE]))
    ctl.reconcile_once()
    alive.append(_pods(store))
    if case == "tighten":
        store.guaranteed_update("nodes", "n1", taints([UNREACHABLE, PRESSURE]))
        ctl.reconcile_once()
        step(6)
    elif case == "loosen":
        store.guaranteed_update("nodes", "n1", taints([UNREACHABLE]))
        ctl.reconcile_once()
        step(10)
        step(600)
    elif case == "cancel":
        store.guaranteed_update("nodes", "n1", taints([]))
        ctl.reconcile_once()
        step(120)
    else:
        step(31)
        step(10_000)
    return store, [ctl], {"alive": alive}


@pytest.mark.parametrize("case,last_alive", [
    ("untolerated", False), ("toleration_seconds", False), ("forever", True),
    ("tighten", False), ("loosen", False), ("cancel", True)])
def test_taint_eviction_matches_jax(case, last_alive):
    alive = run_both(sc_taint_eviction, case)["extra"]["alive"]
    assert bool(alive[-1]) == last_alive
    if case in ("toleration_seconds", "tighten", "loosen"):
        assert alive[0] == ["default/p"]  # tolerated at first
    if case == "loosen":
        assert alive[1] == ["default/p"]  # the longer deadline holds


# -- the full control loop through the batch scheduler ------------------------------


def _cluster(m, store, seed, n_nodes, zones=2):
    rng = np.random.default_rng(seed)
    for i in range(n_nodes):
        cpu = int(rng.choice([4, 8]))
        store.create("nodes", m.t.MakeNode(f"n{i}")
                     .labels({"topology.kubernetes.io/zone": f"z{i % zones}"})
                     .capacity({"cpu": str(cpu), "memory": f"{2 * cpu}Gi", "pods": "110"})
                     .obj())


def sc_full_loop(m, seed):
    """test_controllers.py TestFullControlLoop: a Deployment scales into pods
    the batch scheduler binds and the stand-in runs; status flows back."""
    store = m.Store()
    clock = m.Clock(0.0)
    _cluster(m, store, seed, 4)
    sched = m.batch(store, clock)
    sched.sync()
    ctls = [m.ctl.DeploymentController(store, clock=clock),
            m.ctl.ReplicaSetController(store, clock=clock)]
    for c in ctls:
        c.sync_all()
    store.create("deployments", make_dep(m, name="web", replicas=8, cpu="500m"))
    for _ in range(8):
        for c in ctls:
            c.reconcile_once()
        sched.run_until_idle()
        run_bound_pods(store)
    dep = store.get("deployments", "default/web")
    return store, ctls, {"ready": dep.status.ready_replicas,
                         "phases": sorted({p.status.phase for p in store.list("pods")[0]})}


@pytest.mark.parametrize("seed", [0, 1])
def test_full_control_loop_matches_jax(seed):
    out = run_both(sc_full_loop, seed)
    assert out["extra"] == {"ready": 8, "phases": ["Running"]}
    assert len(out["placements"]) == 8 and all(out["placements"].values())


def sc_node_failure(m):
    """test_controllers.py test_node_failure_reschedules_pods: n0 stops
    heartbeating; the node lifecycle controller taints and evicts, the
    ReplicaSet replaces, the scheduler binds the replacements elsewhere."""
    clock = m.Clock(0.0)
    store = m.Store()
    for i in range(3):
        store.create("nodes", m.t.MakeNode(f"n{i}").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": "110"}).obj())
    names = [f"n{i}" for i in range(3)]
    renew_node_leases(store, m.wl.Lease, names, clock.now())
    sched = m.batch(store, clock)
    sched.sync()
    rsc = m.ctl.ReplicaSetController(store, clock=clock)
    nlc = m.ctl.NodeLifecycleController(store, clock=clock, grace_period=40.0)
    for c in (rsc, nlc):
        c.sync_all()
    store.create("replicasets", make_rs(m, replicas=3))
    for _ in range(4):
        rsc.reconcile_once()
        sched.run_until_idle()
        run_bound_pods(store)
    before = {p.key: p.spec.node_name for p in store.list("pods")[0]}
    clock.step(41)
    renew_node_leases(store, m.wl.Lease, names[1:], clock.now())
    nlc.monitor()
    for _ in range(6):
        rsc.reconcile_once()
        sched.run_until_idle()
        run_bound_pods(store)
    return store, [rsc, nlc], {"before": sorted(before.items())}


def test_node_failure_reschedules_pods_matches_jax():
    out = run_both(sc_node_failure)
    assert len(out["placements"]) == 3
    assert all(n in ("n1", "n2") for n in out["placements"].values())


def sc_churn(m, seed):
    """The smoke's main_path_controllers at a small size: a DaemonSet on
    every node, Deployments with PDBs and the default RollingUpdate budget,
    then a rolling update, a NoExecute drain and a cascading delete, all
    through the batch scheduler."""
    store = m.Store()
    clock = m.Clock(0.0)
    _cluster(m, store, seed, 8, zones=4)
    sched = m.batch(store, clock)
    sched.sync()
    ctls = [m.ctl.DeploymentController(store, clock=clock),
            m.ctl.ReplicaSetController(store, clock=clock),
            m.ctl.TaintEvictionController(store, clock=clock),
            m.ctl.DaemonSetController(store, clock=clock),
            m.ctl.DisruptionController(store, clock=clock),
            m.ctl.GarbageCollector(store, clock=clock)]
    for c in ctls:
        c.sync_all()
    store.create("daemonsets", m.wl.DaemonSet.from_dict({
        "metadata": {"name": "node-agent", "uid": m.types.new_uid()},
        "spec": {"selector": {"matchLabels": {"app": "node-agent"}},
                 "template": {"metadata": {"labels": {"app": "node-agent"}},
                              "spec": {"containers": [{"name": "a", "resources": {
                                  "requests": {"cpu": "100m", "memory": "128Mi"}}}]}}}}))
    for d in range(3):
        store.create("deployments", make_dep(m, name=f"web-{d}", replicas=8, cpu="500m",
                                             surge=2, unavailable=2))
        store.create("poddisruptionbudgets", m.PDB(
            metadata=m.types.ObjectMeta(name=f"web-{d}", namespace="default"),
            selector=m.Selector.from_match_labels({"app": f"web-{d}"}),
            max_unavailable="10%"))

    def drive(rounds):
        for _ in range(rounds):
            for c in ctls:
                c.reconcile_once()
            ctls[2].tick()
            sched.run_until_idle()
            run_bound_pods(store)
            clock.step(1.0)

    drive(6)
    steps = {"setup": len(store.list("pods")[0])}
    for d in range(3):
        store.guaranteed_update("deployments", f"default/web-{d}", _image("v2"))
    drive(10)
    steps["update"] = sorted((rs.metadata.name, rs.spec.replicas)
                             for rs in store.list("replicasets")[0])
    Taint = m.types.Taint
    for name in ("n0", "n1"):
        store.guaranteed_update("nodes", name, _set(
            ("spec", "taints"), [Taint(key="drain", effect="NoExecute")]))
    drive(8)
    steps["drained"] = sorted(p.key for p in store.list("pods")[0]
                              if p.spec.node_name in ("n0", "n1"))
    store.delete("deployments", "default/web-2")
    for _ in range(3):
        clock.step(31.0)
        drive(2)
    steps["pdbs"] = sorted((b.metadata.name, b.disruptions_allowed)
                           for b in store.list("poddisruptionbudgets")[0])
    ds = store.get("daemonsets", "default/node-agent")
    steps["ds"] = (ds.status.desired_number_scheduled, ds.status.current_number_scheduled)
    return store, ctls, steps


@pytest.mark.parametrize("seed", [0, 1])
def test_churn_rollout_drain_cascade_matches_jax(seed):
    out = run_both(sc_churn, seed)
    steps = out["extra"]
    # only the DaemonSet's tolerating pods stay on the drained nodes
    assert all(k.startswith("default/node-agent-") for k in steps["drained"])
    web = [k for k in out["placements"] if k.startswith("default/web-")]
    assert len(web) == 16 and not any(k.startswith("default/web-2-") for k in web)
    assert all(n for n in out["placements"].values())


# -- the pod tracer's evict -> replace links -------------------------------------


def sc_evict_replace(m):
    """tests/test_controlplane_obs.py test_evict_replace_chain_links_and_completes
    with the Running stand-in in place of the hollow kubelets: two bound
    pods of a ReplicaSet are deleted, and the tracer links each evicted
    span to its replacement's."""
    store = m.Store()
    clock = m.Clock(0.0)
    for i in range(2):
        store.create("nodes", m.t.MakeNode(f"hollow-{i}").capacity(
            {"cpu": "16", "memory": "64Gi", "pods": "110"}).obj())
    kw = dict(solver="exact", batch_size=1024, pipeline_binds=False, clock=clock,
              trace_sample_k=64)
    sched = (TBatch(store, TFramework(tdefault()), device="cpu", **kw) if m.port
             else JBatch(store, JFramework(jdefault()), **kw))
    sched.sync()
    rsc = m.ctl.ReplicaSetController(store, clock=clock)
    rsc.sync_all()
    store.create("replicasets", make_rs(m, replicas=4))

    def rounds():
        for _ in range(5):
            rsc.reconcile_once()
            sched.run_until_idle()
            run_bound_pods(store)
            clock.step(1.0)

    rounds()
    victims = sorted(p.key for p in store.list("pods")[0] if p.spec.node_name)[:2]
    for v in victims:
        store.delete("pods", v)
    sched.pump_events()  # DELETED taps record the owner links
    rounds()
    spans = sorted(
        ({k: s.get(k) for k in ("pod", "replaces", "replaced_by", "complete", "deleted",
                                "pops", "stamps_ms")}
         for s in sched.podtrace.snapshot()["spans"]), key=lambda s: s["pod"])
    return store, [rsc], {"spans": spans, "victims": victims}


def test_evict_replace_chain_matches_jax_pod_tracer():
    out = run_both(sc_evict_replace)
    spans, victims = out["extra"]["spans"], out["extra"]["victims"]
    old = [s for s in spans if s["deleted"]]
    new = [s for s in spans if s["replaces"]]
    assert len(old) == 2 and all(s["replaced_by"] for s in old)
    assert len(new) == 2 and all(s["complete"] for s in new)
    assert {s["replaces"] for s in new} == set(victims)
