"""Seeded workloads shared by the port's tests (tests/test_torch_*.py).

One generator per workload of tests/test_batch_parity.py, plus seeded
mixed ones. Each takes a testing module (`kubernetes_tpu.testing` or
`kubernetes_tpu_torch.testing`, which share one MakePod/MakeNode API) and returns
(nodes, pods[, pre-bound pods]), so the same objects can be built for the
JAX package and for the port. This module imports neither jax nor the JAX
package when it is imported (only its JAX comparisons do, inside the test),
so the card-only tests can use it on a machine without JAX. The chip
smoke's gang workloads (chip_smoke.py gang_workloads, preempt_workloads)
run here at a small size in both packages.
"""

import random

import numpy as np
import pytest
import torch

import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu_torch.scheduler.cache import Cache
from kubernetes_tpu_torch.snapshot import tensorizer as ttz

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"

def wl_basic_fit_spread(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi"}).obj() for i in range(8)]
    pods = [m.MakePod(f"p{i}").req({"cpu": "1", "memory": "2Gi"}).obj() for i in range(24)]
    return nodes, pods


def wl_heterogeneous(m):
    rng = random.Random(42)
    nodes = [m.MakeNode(f"n{i}").capacity({
        "cpu": str(rng.choice([2, 4, 8, 16])), "memory": f"{rng.choice([4, 8, 32])}Gi",
        "pods": str(rng.choice([5, 110]))}).obj() for i in range(12)]
    pods = [m.MakePod(f"p{i}").req({
        "cpu": f"{rng.choice([100, 250, 500, 1000, 3000])}m",
        "memory": f"{rng.choice([128, 512, 2048])}Mi"}).priority(rng.choice([0, 0, 10])).obj()
        for i in range(40)]
    return nodes, pods


def wl_overcommit(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "2"}).obj() for i in range(3)]
    pods = [m.MakePod(f"p{i}").req({"cpu": "1500m"}).obj() for i in range(6)]
    return nodes, pods


def wl_best_effort(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "4", "memory": "8Gi"}).obj() for i in range(4)]
    pods = [m.MakePod(f"p{i}").req({}).obj() for i in range(10)]
    return nodes, pods


def wl_node_selector_affinity(m):
    nodes = [m.MakeNode(f"n{i}").labels({"disk": "ssd" if i % 2 == 0 else "hdd",
                                         "zone": f"z{i % 3}"}).capacity({"cpu": "8"}).obj()
             for i in range(6)]
    pods = [m.MakePod(f"sel{i}").node_selector({"disk": "ssd"}).req({"cpu": "500m"}).obj()
            for i in range(6)]
    pods += [m.MakePod(f"aff{i}").node_affinity_in("zone", ["z0", "z1"]).req({"cpu": "500m"}).obj()
             for i in range(4)]
    pods += [m.MakePod(f"pref{i}").preferred_node_affinity(10, "disk", ["hdd"])
             .req({"cpu": "500m"}).obj() for i in range(4)]
    return nodes, pods


def wl_taints(m):
    nodes = [m.MakeNode("tainted1").taints([{"key": "gpu", "value": "true", "effect": "NoSchedule"}])
             .capacity({"cpu": "8"}).obj(),
             m.MakeNode("soft").taints([{"key": "old", "value": "1", "effect": "PreferNoSchedule"}])
             .capacity({"cpu": "8"}).obj(),
             m.MakeNode("clean").capacity({"cpu": "8"}).obj()]
    pods = [m.MakePod(f"plain{i}").req({"cpu": "500m"}).obj() for i in range(4)]
    pods += [m.MakePod(f"tol{i}").toleration("gpu", "true", effect="NoSchedule")
             .req({"cpu": "500m"}).obj() for i in range(2)]
    return nodes, pods


def wl_unschedulable_node(m):
    nodes = [m.MakeNode("cordoned").unschedulable().capacity({"cpu": "8"}).obj(),
             m.MakeNode("open").capacity({"cpu": "8"}).obj()]
    pods = [m.MakePod(f"p{i}").req({"cpu": "500m"}).obj() for i in range(3)]
    return nodes, pods


def wl_host_ports(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "8"}).obj() for i in range(3)]
    pods = [m.MakePod(f"p{i}").req({"cpu": "100m"}, host_port=8080).obj() for i in range(4)]
    return nodes, pods


def wl_image_locality(m):
    big = 800 * 1024 * 1024
    nodes = [m.MakeNode("warm").images({"model-server:latest": big}).capacity({"cpu": "8"}).obj(),
             m.MakeNode("cold1").capacity({"cpu": "8"}).obj(),
             m.MakeNode("cold2").capacity({"cpu": "8"}).obj()]
    pods = [m.MakePod(f"p{i}").req({"cpu": "100m"}).container("model-server:latest").obj()
            for i in range(2)]
    return nodes, pods


def wl_pts_do_not_schedule(m):
    nodes = [m.MakeNode(f"n{i}").labels({ZONE: f"z{i % 3}"}).capacity({"cpu": "16"}).obj()
             for i in range(6)]
    pods = [m.MakePod(f"w{i}").labels({"app": "web"}).req({"cpu": "100m"})
            .topology_spread(1, ZONE, "DoNotSchedule", {"app": "web"}).obj() for i in range(12)]
    return nodes, pods


def wl_pts_schedule_anyway(m):
    nodes = [m.MakeNode(f"n{i}").labels({ZONE: "a" if i < 2 else "b"}).capacity({"cpu": "16"}).obj()
             for i in range(4)]
    pods = [m.MakePod(f"w{i}").labels({"app": "w"}).req({"cpu": "100m"})
            .topology_spread(1, ZONE, "ScheduleAnyway", {"app": "w"}).obj() for i in range(8)]
    return nodes, pods


def wl_mixed_constraints_stress(m):
    rng = random.Random(7)
    nodes = []
    for i in range(10):
        n = m.MakeNode(f"n{i}").labels({ZONE: f"z{i % 4}", "tier": rng.choice(["a", "b"])}) \
            .capacity({"cpu": "8", "memory": "16Gi", "pods": "20"})
        if i % 5 == 0:
            n = n.taints([{"key": "spot", "value": "true", "effect": "NoSchedule"}])
        nodes.append(n.obj())
    pods = []
    for i in range(30):
        p = m.MakePod(f"p{i}").labels({"grp": f"g{i % 3}"}).req({
            "cpu": f"{rng.choice([100, 500, 1000])}m", "memory": f"{rng.choice([256, 1024])}Mi"})
        if i % 3 == 0:
            p = p.topology_spread(2, ZONE, "DoNotSchedule", {"grp": f"g{i % 3}"})
        if i % 4 == 0:
            p = p.toleration("spot", "true", effect="NoSchedule")
        if i % 7 == 0:
            p = p.preferred_node_affinity(5, "tier", ["a"])
        pods.append(p.obj())
    return nodes, pods


def wl_interpod_anti_affinity(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "8"}).obj() for i in range(3)]
    pods = [m.MakePod(f"w{i}").labels({"app": "web"}).req({"cpu": "100m"})
            .pod_anti_affinity(HOST, {"app": "web"}).obj() for i in range(3)]
    return nodes, pods


def wl_seeded_mixed(seed, n_nodes=12, n_pods=40):
    """A seeded mixed workload: zones, taints, priorities, PTS of both kinds,
    inter-pod affinity of every kind, host ports, pre-bound holders."""

    def build(m):
        rng = random.Random(seed)
        nodes = []
        for i in range(n_nodes):
            b = m.MakeNode(f"n{i}").labels({ZONE: f"z{i % 3}", "tier": rng.choice("ab")}) \
                .capacity({"cpu": str(rng.choice([4, 8, 16])),
                           "memory": f"{rng.choice([8, 16, 32])}Gi", "pods": "30"})
            if rng.random() < 0.2:
                b = b.taints([{"key": "spot", "value": "1", "effect": "NoSchedule"}])
            elif rng.random() < 0.2:
                b = b.taints([{"key": "old", "value": "1", "effect": "PreferNoSchedule"}])
            nodes.append(b.obj())
        bound = []
        for i in range(3):
            b = m.MakePod(f"held{i}").labels({"app": "db"}).req({"cpu": "250m"}) \
                .pod_anti_affinity(HOST, {"app": "db"}) \
                .preferred_pod_affinity(10, ZONE, {"app": "web"}).obj()
            b.spec.node_name = f"n{rng.randrange(n_nodes)}"
            bound.append(b)
        pods = []
        for i in range(n_pods):
            app = rng.choice(["web", "db", "cache", "batch"])
            b = m.MakePod(f"p{i}").labels({"app": app}).priority(rng.choice([0, 0, 5])).req({
                "cpu": f"{rng.choice([100, 250, 500, 1000])}m",
                "memory": f"{rng.choice([128, 512, 1024, 2048])}Mi"})
            r = rng.random()
            if app == "db" and r < 0.6:
                b = b.pod_anti_affinity(HOST, {"app": "db"})
            if app == "web":
                b = b.topology_spread(1, ZONE, "ScheduleAnyway", {"app": "web"})
                if r < 0.5:
                    b = b.preferred_pod_affinity(40, ZONE, {"app": "db"})
            if app == "cache":
                b = b.topology_spread(1, ZONE, "DoNotSchedule", {"app": "cache"})
                if r < 0.4:
                    b = b.pod_affinity(ZONE, {"app": "db"})
                else:
                    b = b.preferred_pod_anti_affinity(20, HOST, {"app": "cache"})
            if app == "batch" and r < 0.3:
                b = m.MakePod(f"p{i}").labels({"app": app}).req({"cpu": "100m"},
                                                                 host_port=9000)
            if rng.random() < 0.3:
                b = b.toleration("spot", "1", effect="NoSchedule")
            if rng.random() < 0.2:
                b = b.preferred_node_affinity(rng.choice([5, 50]), "tier", ["a"])
            pods.append(b.obj())
        return nodes, pods, bound

    build.__name__ = f"wl_seeded_mixed_{seed}"
    return build


def wl_repair_kinds(m):
    """Every kind the repair check reports: required hostname anti-affinity,
    holders' anti-affinity against incoming pods, required zone affinity,
    DoNotSchedule spread with and without minDomains; two nodes lack the
    zone key."""
    nodes = []
    for i in range(16):
        labels = {HOST: f"n{i}"}
        if i < 14:
            labels[ZONE] = f"z{i % 4}"
        nodes.append(m.MakeNode(f"n{i}").labels(labels)
                     .capacity({"cpu": "32", "memory": "64Gi", "pods": "110"}).obj())
    bound = []
    for i, node in enumerate(("n0", "n5", "n9")):
        b = m.MakePod(f"holder{i}").labels({"app": "guard"}).req({"cpu": "100m"}) \
            .pod_anti_affinity(HOST, {"app": "web"}).obj()
        b.spec.node_name = node
        bound.append(b)
    pods = []
    for i in range(40):
        kind = i % 5
        b = m.MakePod(f"k{i}").req({"cpu": "100m"})
        if kind == 0:
            b = b.labels({"app": "db"}).pod_anti_affinity(HOST, {"app": "db"})
        elif kind == 1:
            b = b.labels({"app": "web"})
        elif kind == 2:
            b = b.labels({"app": "aff"}).pod_affinity(ZONE, {"app": "db"})
        elif kind == 3:
            b = b.labels({"app": "sp"}).topology_spread(1, ZONE, "DoNotSchedule", {"app": "sp"},
                                                         min_domains=6)
        else:
            b = b.labels({"app": "sq"}).topology_spread(1, ZONE, "DoNotSchedule", {"app": "sq"})
        pods.append(b.obj())
    return nodes, pods, bound


CHECK_FIELDS = ("topo_id", "rn_key", "rn_sel", "ea_grp", "ra_key", "ra_sel",
                "class_matches_selcls", "class_holds_grp", "grp_key", "aff_ok", "ct_class",
                "ct_key", "ct_sel", "ct_max_skew", "ct_min_domains")


def placed_check_case(workload, seed, placed_frac=0.9):
    """A seeded random placement of a workload's pending pods, as the numpy
    arguments of repair_check (the port's tensorizer builds the tables):
    (args tuple in repair_check order, d_max). The pod axis is padded to a
    pow2 bucket >= 256 and the counts include every placed pod."""
    from kubernetes_tpu_torch.ops.solver import make_inputs

    nodes, pods, bound = unpack(workload(tt))
    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = cache.update_snapshot()
    cluster = ttz.build_cluster_tensors(snap)
    batch = ttz.build_pod_batch(pods, snap, cluster)
    inp, d_max = make_inputs(cluster, batch, "cpu")
    f = {k: getattr(inp, k).numpy() for k in CHECK_FIELDS + ("selcls_count", "grp_count")}
    rng = np.random.default_rng(seed)
    p, n = len(pods), cluster.n
    node_of = rng.integers(0, n, size=p).astype(np.int32)
    node_of[rng.random(p) > placed_frac] = -1
    cls = np.asarray(batch.class_of_pod, dtype=np.int32)
    selcls = f["selcls_count"].astype(np.int64)
    grp = f["grp_count"].astype(np.int64)
    for i in np.nonzero(node_of >= 0)[0]:
        selcls[:, node_of[i]] += f["class_matches_selcls"][cls[i]]
        grp[:, node_of[i]] += f["class_holds_grp"][cls[i]]
    pb = max(256, 1 << (p - 1).bit_length())
    node_pad = np.full(pb, -1, np.int32)
    node_pad[:p] = node_of
    cls_pad = np.zeros(pb, np.int32)
    cls_pad[:p] = cls
    args = (node_pad, cls_pad, selcls.astype(np.int32), grp.astype(np.int32)) + tuple(
        f[k] for k in CHECK_FIELDS)
    return args, d_max


PARITY_WORKLOADS = [wl_basic_fit_spread, wl_heterogeneous, wl_overcommit, wl_best_effort,
                    wl_node_selector_affinity, wl_taints, wl_unschedulable_node, wl_host_ports,
                    wl_image_locality, wl_pts_do_not_schedule, wl_pts_schedule_anyway,
                    wl_mixed_constraints_stress, wl_interpod_anti_affinity]
MIXED_WORKLOADS = [wl_seeded_mixed(s) for s in range(4)]


def unpack(built):
    nodes, pods = built[0], built[1]
    bound = built[2] if len(built) > 2 else []
    return nodes, pods, bound


@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS + [wl_repair_kinds],
                         ids=lambda w: w.__name__)
def test_workload_is_deterministic_and_well_formed(workload):
    """Two builds give the same specs (the seed fixes everything) and every
    object has a unique name."""
    a, b = unpack(workload(tt)), unpack(workload(tt))
    for xs, ys in zip(a, b):
        assert [x.metadata.name for x in xs] == [y.metadata.name for y in ys]
        assert [x.spec for x in xs] == [y.spec for y in ys]
        assert len({x.metadata.name for x in xs}) == len(xs)
    nodes, pods, bound = a
    assert nodes and pods
    assert all(p.spec.node_name for p in bound)
    assert not any(p.spec.node_name for p in pods)


def check_mirrors_after_churn(device):
    """Drive five rounds of bound-pod churn through the port's TensorCache
    and check, every round, that the device mirrors equal the host arrays
    (a fresh upload) and that the incremental host rows equal a rebuild."""
    cache = Cache()
    for i in range(30):
        cache.add_node(tt.MakeNode(f"n{i}").labels({ZONE: f"z{i % 3}"})
                       .capacity({"cpu": "8", "memory": "16Gi", "pods": "50"}).obj())
    tc = ttz.TensorCache()
    for step in range(5):
        for j in range(4):
            p = tt.MakePod(f"d{step}-{j}").labels({"app": "w"}).req({"cpu": "250m"}).obj()
            p.spec.node_name = f"n{(step * 4 + j) % 30}"
            cache.add_pod(p)
        snap = cache.update_snapshot()
        cluster, changed = tc.cluster_tensors(snap)
        pending = [tt.MakePod(f"s{step}-{j}").labels({"app": "w"}).req({"cpu": "100m"})
                   .topology_spread(2, ZONE, "DoNotSchedule", {"app": "w"}).obj()
                   for j in range(6)]
        ttz.build_pod_batch(pending, snap, cluster, reuse=tc, changed_nodes=changed)
        views = tc.device_views(cluster, device)
        for f in ttz.TensorCache.DEVICE_FIELDS:
            assert views[f].device.type == device.type
            assert views[f].dtype == torch.int32
            np.testing.assert_array_equal(views[f].cpu().numpy(), getattr(cluster, f), err_msg=f)
        np.testing.assert_array_equal(views["selcls_count"].cpu().numpy(), cluster.selcls_count)
        fresh = ttz.build_cluster_tensors(snap)
        for f in ttz.TensorCache.DEVICE_FIELDS:
            np.testing.assert_array_equal(getattr(cluster, f), getattr(fresh, f), err_msg=f)


# -- the chip smoke's gang workloads at a small size, held against JAX ------------

GANG_SIZES = {"nodes": 100, "batch": 4096, "gang_members": 5, "preempt_members": 8}


def _schedulers(port):
    """(store, make-scheduler) of one package, the JAX one without pipelined
    binds (the port binds synchronously)."""
    if port:
        from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
        from kubernetes_tpu_torch.store import APIStore

        return APIStore(), lambda store, **kw: BatchScheduler(store, device="cpu", **kw)
    from kubernetes_tpu.scheduler import Framework
    from kubernetes_tpu.scheduler.batch import BatchScheduler as JBatch
    from kubernetes_tpu.scheduler.plugins import default_plugins
    from kubernetes_tpu.store import APIStore as JStore

    return JStore(), lambda store, **kw: JBatch(store, Framework(default_plugins()),
                                                pipeline_binds=False, **kw)


@pytest.mark.parametrize("solver", ["fast", "exact"])
@pytest.mark.parametrize("name", ["GangScheduling_2k_250", "GangScheduling_5000"])
def test_chip_smoke_gang_workloads_match_jax(name, solver):
    import chip_smoke

    import kubernetes_tpu.testing as jt

    maps = []
    for port, m in ((False, jt), (True, tt)):
        nodes, gangs, batch = chip_smoke.gang_workloads(GANG_SIZES)(m)[name]
        store, make = _schedulers(port)
        store.create_many("nodes", nodes)
        sched = make(store, batch_size=batch, solver=solver)
        sched.sync()
        for pg, _ms in gangs:
            store.create("podgroups", pg)
        store.create_many("pods", [p for _pg, ms in gangs for p in ms])
        sched.run_until_idle()
        pods, _ = store.list("pods")
        assert all(p.spec.node_name for p in pods) and sched.gang_vetoes == 0
        maps.append({p.metadata.name: p.spec.node_name for p in pods})
    assert maps[0] == maps[1]


@pytest.mark.parametrize("name", ["GangPreemption", "GangPreemption_5000"])
def test_chip_smoke_preempt_workloads_match_jax(name):
    """The cover evicts the same victims and the gang lands on the same nodes;
    the uncoverable gang is vetoed in both with no further eviction."""
    import time

    import chip_smoke

    import kubernetes_tpu.testing as jt

    outs = []
    for port, m in ((False, jt), (True, tt)):
        nodes, bound, n_gang, n_big = chip_smoke.preempt_workloads(GANG_SIZES)(m)[name]
        store, make = _schedulers(port)
        store.create_many("nodes", nodes)
        store.create_many("pods", bound)
        sched = make(store, batch_size=1024, solver="fast", pod_initial_backoff=0.05,
                     pod_max_backoff=0.2)
        sched.sync()
        w = store.watch(kind="pods", maxsize=100_000)
        for gname, n in (("gp", n_gang), ("gbig", n_big)):
            pg, members = chip_smoke.gang_pods(gname, n, "3", prio=100, m=m)
            store.create("podgroups", pg)
            store.create_many("pods", members)
            deadline = time.time() + 10.0
            while time.time() < deadline:
                sched.run_until_idle()
                sched.queue.flush_backoff_completed()
                sched.pump_events()
                if sum(1 for p in store.list("pods")[0]
                       if p.metadata.name.startswith("gp-") and p.spec.node_name) >= n_gang:
                    break
                time.sleep(0.02)
        pods, _ = store.list("pods")
        deleted = sorted(ev.obj.metadata.name for ev in w.drain() if ev.type == "DELETED")
        stats = sched.gangpreempt.stats()
        outs.append((deleted, {p.metadata.name: p.spec.node_name for p in pods
                               if not p.metadata.name.startswith("low-")},
                     stats["preempted"], stats["victims"]))
    assert outs[0] == outs[1]
    deleted, placement, preempted, victims = outs[1]
    assert preempted == 1 and victims == len(deleted) > 0
    assert sum(1 for k, v in placement.items() if k.startswith("gp-") and v) == len(
        [k for k in placement if k.startswith("gp-")])
    assert not any(v for k, v in placement.items() if k.startswith("gbig-"))
