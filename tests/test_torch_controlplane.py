"""The port's leader-elected control plane and the schedulers' background
loops against the JAX package's, on the CPU (`device="cpu"` on the port).

A background loop's batch boundaries follow the clock, in the JAX package
as in the port, so these tests compare end states, never placement maps:
which replica leads, the pods bound and how often each was bound (the
store's bind transitions), PDB status, the Job's completed indexes, the
Deployments' replica counts, and that every thread is gone after stop().
The cases are the JAX package's test_controlplane.py (its node-agent
restart case waits for ROADMAP.md queue 1 item 7h), the start() loops of
Scheduler, BatchScheduler, PartitionedScheduler and MPScheduler's thread
path, and one run of the whole slice at a small size: an APIServer with
flow control and audit, two ControlPlane replicas with the default
controllers, Deployments created, scaled and deleted over HTTP while an
Informer watches, and the leader stopped halfway through.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import pytest
import torch
from test_torch_server import Run, twin, wait

from kubernetes_tpu_torch.testing import renew_node_leases
from kubernetes_tpu_torch.utils.leakcheck import assert_no_thread_leaks


def _dev(r: Run) -> Dict[str, Any]:
    return {"device": "cpu"} if r.k.is_port else {}


def cluster(r: Run, n: int, cpu: str = "16", pods: str = "100"):
    """A store with n nodes and their heartbeat Leases (the node agent's
    stand-in), so the node lifecycle controller keeps them schedulable."""
    store = r.store()
    MakeNode = r.k("testing").MakeNode
    for i in range(n):
        store.create("nodes", MakeNode(f"n{i}").capacity(
            {"cpu": cpu, "memory": "64Gi", "pods": pods}).obj())
    renew_node_leases(store, r.k("api.workloads").Lease, [f"n{i}" for i in range(n)],
                      time.monotonic())
    return store


def control_plane(r: Run, store, ident: str, batch: bool = True, **kw):
    kw.setdefault("lease_duration", 0.6)
    kw.setdefault("renew_deadline", 0.4)
    kw.setdefault("retry_period", 0.05)
    cp = r.k("server.controlplane").ControlPlane(
        store, identity=ident, use_batch_scheduler=batch, **_dev(r), **kw)
    r.on_close(cp.stop)
    return cp.start()


def bind_counts(store) -> Dict[str, int]:
    """Unbound -> bound transitions per pod key, from the store's history."""
    out: Dict[str, int] = {}
    for ev in store.history_events():
        if (ev.kind == "pods" and ev.type == "MODIFIED" and ev.obj.spec.node_name
                and (ev.prev is None or not ev.prev.spec.node_name)):
            out[ev.obj.key] = out.get(ev.obj.key, 0) + 1
    return out


def crash(cp) -> None:
    """The leader dies: its renewals stop and its components stop mid-flight."""
    cp.elector.try_acquire_or_renew = lambda: False
    cp._stop_components()


def hand_over(r: Run, cp) -> None:
    """The leader stops gracefully: its components stop, then its lease
    goes. The port's ControlPlane.stop() does both in that order. The JAX
    package's releases the lease first, so a standby would lead while the
    old components still write (ROADMAP.md queue 3): its side stops the
    components by hand first."""
    if not r.k.is_port:
        cp._stop_components()
    cp.stop()


# -- leader election and failover ----------------------------------------------------


def scn_single_leader(r: Run) -> None:
    store = cluster(r, 1, cpu="8", pods="50")
    cp1 = control_plane(r, store, "cp-1", batch=False,
                        controllers=("replicaset", "deployment", "disruption"))
    r.note("cp1-leads", bool(wait(lambda: cp1.is_leader, 5)))
    cp2 = control_plane(r, store, "cp-2", batch=False,
                        controllers=("replicaset", "deployment", "disruption"))
    time.sleep(0.3)
    r.note("standby", [cp2.is_leader, cp2.scheduler is None, cp2.controllers])
    r.note("lease-holder", store.get("leases", "kube-system/kube-controlplane").holder_identity)
    store.create("pods", r.k("testing").MakePod("p0").req({"cpu": "1"}).obj())
    r.note("bound", wait(lambda: store.get("pods", "default/p0").spec.node_name, 10))


def scn_failover_no_double_binds(r: Run) -> None:
    store = cluster(r, 1)
    MakePod = r.k("testing").MakePod
    cp1 = control_plane(r, store, "cp-1",
                        controllers=("replicaset", "deployment", "disruption"))
    r.note("cp1-leads", bool(wait(lambda: cp1.is_leader, 5)))
    cp2 = control_plane(r, store, "cp-2",
                        controllers=("replicaset", "deployment", "disruption"))
    for i in range(5):
        store.create("pods", MakePod(f"pre-{i}").req({"cpu": "100m"}).obj())
    r.note("pre-bound", bool(wait(lambda: all(
        store.get("pods", f"default/pre-{i}").spec.node_name for i in range(5)), 10)))
    crash(cp1)
    r.note("cp2-leads", bool(wait(lambda: cp2.is_leader, 5)))
    r.note("scheduler", type(cp2.scheduler).__name__)
    for i in range(5):
        store.create("pods", MakePod(f"post-{i}").req({"cpu": "100m"}).obj())
    r.note("post-bound", bool(wait(lambda: all(
        store.get("pods", f"default/post-{i}").spec.node_name for i in range(5)), 10)))
    cp2.scheduler.flush_binds()
    r.note("nodes", sorted({p.spec.node_name for p in store.list("pods")[0]}))
    r.note("binds", sorted(bind_counts(store).items()))


def scn_pdb_status(r: Run) -> None:
    pol, types = r.k("api.policy"), r.k("api.types")
    store = cluster(r, 1, cpu="8", pods="50")
    store.create("poddisruptionbudgets", pol.PodDisruptionBudget(
        metadata=types.ObjectMeta(name="web-pdb", namespace="default"),
        selector=r.k("api.labels").Selector.from_match_labels({"app": "web"}),
        min_available=1))
    cp = control_plane(r, store, "cp-1", batch=False,
                       controllers=("replicaset", "deployment", "disruption"))
    r.note("leads", bool(wait(lambda: cp.is_leader, 5)))
    for i in range(3):
        store.create("pods", r.k("testing").MakePod(f"w{i}").labels({"app": "web"}).req(
            {"cpu": "100m"}).obj())
    r.note("allowed", wait(lambda: store.get(
        "poddisruptionbudgets", "default/web-pdb").disruptions_allowed == 2, 10))
    r.note("wire", r.k("api.serialize").to_dict(
        store.get("poddisruptionbudgets", "default/web-pdb"))["status"])


def scn_restart_mid_backlog(r: Run) -> None:
    store = cluster(r, 4)
    fw = r.k("scheduler.runtime").Framework
    plugins = r.k("scheduler.plugins").default_plugins
    BatchScheduler = r.k("scheduler.batch").BatchScheduler
    s1 = BatchScheduler(store, fw(plugins()), batch_size=10, solver="exact", **_dev(r))
    s1.sync()
    for i in range(60):
        store.create("pods", r.k("testing").MakePod(f"r-{i}").req({"cpu": "100m"}).obj())
    s1.schedule_batch()
    s1.flush_binds()
    before = sum(1 for p in store.list("pods")[0] if p.spec.node_name)
    s1.stop()
    s2 = BatchScheduler(store, fw(plugins()), batch_size=64, solver="exact", **_dev(r))
    r.on_close(s2.stop)
    s2.sync()
    s2.start()
    r.note("drained", bool(wait(lambda: sum(
        1 for p in store.list("pods")[0] if p.spec.node_name) == 60, 20)))
    s2.stop()
    r.note("counts", [before, s2.scheduled_count, sorted(set(bind_counts(store).values()))])
    r.note("map", sorted((p.key, p.spec.node_name) for p in store.list("pods")[0]))


def scn_indexed_job_failover(r: Run) -> None:
    wl, types = r.k("api.workloads"), r.k("api.types")
    pci = r.k("controllers.job").pod_completion_index
    store = cluster(r, 1, cpu="32")
    cp1 = control_plane(r, store, "cp-1", batch=False, controllers=("job",))
    r.note("cp1-leads", bool(wait(lambda: cp1.is_leader, 5)))
    cp2 = control_plane(r, store, "cp-2", batch=False, controllers=("job",))
    job = wl.Job.from_dict({
        "metadata": {"name": "train"},
        "spec": {"parallelism": 6, "completions": 6, "completionMode": "Indexed",
                 "template": {"spec": {"containers": [
                     {"name": "w", "resources": {"requests": {"cpu": "100m"}}}]}}}})
    job.metadata.uid = types.new_uid()
    store.create("jobs", job)
    r.note("six", bool(wait(lambda: len(store.list("pods")[0]) == 6, 10)))

    def done(x):
        x.status.phase = "Succeeded"
        return x

    for p in store.list("pods")[0]:
        if pci(p) < 3:
            store.guaranteed_update("pods", p.key, done)
    r.note("three", bool(wait(lambda: store.get("jobs", "default/train").status.succeeded == 3,
                              10)))
    crash(cp1)
    r.note("cp2-leads", bool(wait(lambda: cp2.is_leader, 5)))

    def finish():
        for p in store.list("pods")[0]:
            if not p.is_terminal():
                store.guaranteed_update("pods", p.key, done)
        return store.get("jobs", "default/train").is_finished()

    r.note("finished", bool(wait(finish, 10)))
    j = store.get("jobs", "default/train")
    by_index: Dict[int, List[str]] = {}
    for p in store.list("pods")[0]:
        by_index.setdefault(pci(p), []).append(p.status.phase)
    r.note("end", [j.status.completed_indexes, j.status.succeeded, sorted(by_index.items())])


# -- the schedulers' start() loops -------------------------------------------------------


def _loop_end_state(r: Run, store, n_pods: int) -> List[Any]:
    pods = store.list("pods")[0]
    per_node: Dict[str, int] = {}
    for p in pods:
        if p.spec.node_name:
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name, 0) + 1
    return [sum(1 for p in pods if p.spec.node_name), len(pods),
            sorted(set(bind_counts(store).values())),
            max(per_node.values()) if per_node else 0]


def scn_serial_loop(r: Run) -> None:
    store = cluster(r, 3, cpu="4", pods="20")
    fw = r.k("scheduler.runtime").Framework(r.k("scheduler.plugins").default_plugins())
    s = r.k("scheduler.serial").Scheduler(store, fw)
    r.on_close(s.stop)
    s.sync()
    s.start()
    r.note("alive", s._thread.is_alive())
    for i in range(20):
        store.create("pods", r.k("testing").MakePod(f"s{i}").req({"cpu": "500m"}).obj())
    r.note("bound", bool(wait(lambda: sum(1 for p in store.list("pods")[0]
                                          if p.spec.node_name) == 20, 20)))
    # an unschedulable pod parks in the unschedulable tier
    store.create("pods", r.k("testing").MakePod("big").req({"cpu": "64"}).obj())
    r.note("parked", bool(wait(lambda: s.queue.lengths()[2] == 1, 10)))
    s.stop()
    r.note("stopped", [s._thread, s._watch])
    r.note("end", _loop_end_state(r, store, 21) + [s.scheduled_count])


def scn_batch_loop(r: Run) -> None:
    store = cluster(r, 4, cpu="8", pods="40")
    fw = r.k("scheduler.runtime").Framework(r.k("scheduler.plugins").default_plugins())
    s = r.k("scheduler.batch").BatchScheduler(store, fw, solver="auto", batch_size=32,
                                              **_dev(r))
    r.on_close(s.stop)
    sampler = r.k("obs.resource").ResourceSampler(interval_s=60.0)
    s.attach_resource_sampler(sampler)
    s.sync()
    s.start()
    r.note("alive", s._thread.is_alive())
    r.note("registered", sorted(sampler._threads))
    MakePod = r.k("testing").MakePod
    for wave in range(3):
        store.create_many("pods", [MakePod(f"b{wave}-{i}").req({"cpu": "250m"}).obj()
                                   for i in range(40)], consume=True)
        r.note(f"wave{wave}", bool(wait(lambda: sum(
            1 for p in store.list("pods")[0] if p.spec.node_name) == 40 * (wave + 1), 20)))
    s.stop()
    r.note("stopped", [s._thread, s._bind_worker])
    r.note("end", _loop_end_state(r, store, 120) + [s.scheduled_count, s.failed_count])
    st = s.sched_stats()
    r.note("stats", [st["scheduled"], sorted(st), sorted(st["stages"])])


SCENARIOS = {
    "single_leader": scn_single_leader,
    "failover_no_double_binds": scn_failover_no_double_binds,
    "pdb_status": scn_pdb_status,
    "restart_mid_backlog": scn_restart_mid_backlog,
    "indexed_job_failover": scn_indexed_job_failover,
    "serial_loop": scn_serial_loop,
    "batch_loop": scn_batch_loop,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controlplane_parity(name):
    twin(SCENARIOS[name])


# -- the whole slice at a small size ------------------------------------------------------


def deployment(name: str, replicas: int) -> Dict:
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "selector": {"matchLabels": {"app": name}},
                     "template": {"metadata": {"labels": {"app": name}},
                                  "spec": {"containers": [{
                                      "name": "c", "image": "pause",
                                      "resources": {"requests": {"cpu": "500m",
                                                                 "memory": "1Gi"}}}]}}}}


def scn_whole_slice(r: Run) -> None:
    """APIServer + two ControlPlanes + an Informer, all traffic over HTTP:
    3 Deployments of 20 scaled to 60 (a merge PATCH each), the leader
    stopped once half of the new pods are bound, then deleted."""
    store = cluster(r, 24, cpu="8", pods="110")
    srv = r.server(store, flowcontrol="default", audit="default")
    c = r.client(srv)
    cps = [control_plane(r, store, f"cp-{i}", lease_duration=2.0, renew_deadline=1.5,
                         retry_period=0.1) for i in range(2)]
    r.note("one-leader", bool(wait(lambda: sum(cp.is_leader for cp in cps) == 1, 10)))
    inf = r.k("server.client").Informer(c, "pods")
    inf.start()
    r.on_close(inf.stop)

    def bound_in_cache():
        return sum(1 for o in list(inf.cache.values()) if o.spec.node_name)

    codes: List[Any] = []

    def req(label: str, fn) -> None:
        """A workload request; the bodies carry RVs that the controllers'
        background writes interleave, so only the outcome is recorded."""
        try:
            fn()
            codes.append([label, "ok"])
        except r.k("server.client").APIError as e:
            codes.append([label, e.code])

    for i in range(3):
        req(f"create-d{i}", lambda: c.create("deployments", deployment(f"d{i}", 20)))
    r.note("step1", bool(wait(lambda: bound_in_cache() == 60, 30)))
    # all three scaled; once half of the 120 new pods are bound the leader
    # stops, the standby takes the lease and binds the rest
    for i in range(3):
        req(f"scale-d{i}", lambda: c.patch("deployments", f"d{i}", {"spec": {"replicas": 60}}))
    r.note("half", bool(wait(lambda: bound_in_cache() >= 120, 30)))
    leader = next(cp for cp in cps if cp.is_leader)
    standby = next(cp for cp in cps if cp is not leader)
    hand_over(r, leader)
    r.note("standby-leads", bool(wait(lambda: standby.is_leader, 6.0)))
    every = len(r.k("server.controlplane").DEFAULT_CONTROLLERS)
    r.note("standby-started", bool(wait(lambda: standby.scheduler is not None
                                        and len(standby.controllers) == every, 30)))
    r.note("step2", bool(wait(lambda: bound_in_cache() == 180, 40)))
    standby.scheduler.flush_binds()
    pods = store.list("pods")[0]
    r.note("per-deployment", sorted(
        (name, sum(1 for p in pods if p.metadata.labels.get("app") == name
                   and p.spec.node_name)) for name in ("d0", "d1", "d2")))
    r.note("binds", [len(bind_counts(store)), sorted(set(bind_counts(store).values()))])
    r.note("status", bool(wait(lambda: all(
        store.get("deployments", f"default/d{i}").status.replicas == 60 for i in range(3)),
        20)))
    r.note("cache==store", bool(wait(lambda: sorted(
        (k, o.spec.node_name, o.metadata.resource_version) for k, o in list(inf.cache.items()))
        == sorted((p.key, p.spec.node_name, p.metadata.resource_version)
                  for p in store.list("pods")[0]), 10)))
    st, body = r.http(srv, "GET", "/debug/schedstats", record=False)
    r.note("schedstats", [st, standby.scheduler._bind_origin in body])
    for i in range(3):
        req(f"delete-d{i}", lambda: c.delete("deployments", f"d{i}"))
    r.note("empty", bool(wait(lambda: not inf.cache and not store.list("pods")[0], 40)))
    r.note("requests", codes)


def test_whole_slice_small():
    got = twin(scn_whole_slice)
    assert ["step2", True] in got and ["empty", True] in got


def test_stop_releases_the_lease_after_the_components():
    """The port's ControlPlane.stop() stops its components while it still
    holds the lease, and releases it after. The JAX package releases it
    first (ROADMAP.md queue 3). Read from the lease's holder at the moment
    the replica's scheduler stops."""
    from test_torch_server import JAX, PORT, Pkg

    seen: Dict[str, Any] = {}
    with assert_no_thread_leaks(grace=5.0):
        for root in (JAX, PORT):
            k = Pkg(root)
            store = k("store").APIStore()
            lease = "kube-system/kube-controlplane"

            class Scheduler:
                def sync(self):
                    pass

                def start(self):
                    pass

                def stop(self, root=root, store=store):
                    seen[root] = store.get("leases", lease).holder_identity

            cp = k("server.controlplane").ControlPlane(
                store, "cp-0", controllers=(), scheduler_factory=lambda _s: Scheduler(),
                lease_duration=0.6, renew_deadline=0.4, retry_period=0.05,
                **({"device": "cpu"} if k.is_port else {})).start()
            try:
                assert wait(lambda: cp.is_leader, 5)
            finally:
                cp.stop()
            assert store.get("leases", lease).holder_identity == ""
    assert seen == {JAX: "", PORT: "cp-0"}


# -- the device rule ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card():
    """ControlPlane and the loops' schedulers default to device="cuda" and
    raise where there is no card; the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.scheduler.mpsched import MPScheduler
    from kubernetes_tpu_torch.scheduler.partition import PartitionedScheduler
    from kubernetes_tpu_torch.scheduler.plugins import default_plugins
    from kubernetes_tpu_torch.scheduler.runtime import Framework
    from kubernetes_tpu_torch.server.controlplane import ControlPlane
    from kubernetes_tpu_torch.store import APIStore

    with assert_no_thread_leaks(grace=5.0):
        store = APIStore()
        for build in (lambda: ControlPlane(store, "cp-0"),
                      lambda: BatchScheduler(store, Framework(default_plugins())),
                      lambda: PartitionedScheduler(
                          store, lambda: Framework(default_plugins()), partitions=2),
                      lambda: MPScheduler(store, lambda: Framework(default_plugins()),
                                          processes=1)):
            with pytest.raises(RuntimeError, match="cuda"):
                build()
        cp = ControlPlane(store, "cp-0", device="cpu")
        assert cp.device == torch.device("cpu")
