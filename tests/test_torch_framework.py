"""The port's framework, runtime and default plugins against the JAX
package's, tolerance 0.

For each scenario (the plugin tables of tests/test_plugins.py, the parity
workloads of tests/test_batch_parity.py and numpy-seeded clusters) the same
nodes, bound pods and pending pods are built in both packages. Every default
plugin's PreFilter, Filter (status code, reasons, plugin, per node), PreScore
and normalized Score (per node), PreEnqueue and QueueSort, and the Framework's
run_pre_filter / run_filter / run_score totals, run_filter_with_nominated_pods
and the PreFilterExtensions (run_remove_pod / run_add_pod) must be equal.
"""

import numpy as np
import pytest
from test_torch_workloads import HOST, MIXED_WORKLOADS, PARITY_WORKLOADS, ZONE, unpack

import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.scheduler import framework as jfw
from kubernetes_tpu.scheduler import runtime as jrt
from kubernetes_tpu.scheduler.plugins import default_plugins as jdefault
from kubernetes_tpu_torch.scheduler import framework as tfw
from kubernetes_tpu_torch.scheduler import runtime as trt
from kubernetes_tpu_torch.scheduler.plugins import default_plugins as tdefault

PKGS = {"jax": (jt, jfw, jrt, jdefault), "port": (tt, tfw, trt, tdefault)}


def np_cluster(seed, n_nodes=10, n_pods=16, n_bound=12):
    """A numpy-seeded cluster (nodes, pending pods, bound pods) for
    either testing module: capacities, requests, zones, taints, images,
    priorities, spread constraints and (anti-)affinity terms drawn from one
    default_rng(seed)."""

    def build(m):
        rng = np.random.default_rng(seed)
        nodes = []
        for i in range(n_nodes):
            b = m.MakeNode(f"n{i}").labels({ZONE: f"z{int(rng.integers(3))}",
                                             "tier": "ab"[int(rng.integers(2))]}) \
                .capacity({"cpu": str(int(rng.choice([2, 4, 8]))),
                           "memory": f"{int(rng.choice([4, 8, 16]))}Gi",
                           "pods": str(int(rng.choice([4, 110])))})
            if rng.random() < 0.2:
                b = b.taints([{"key": "spot", "value": "true",
                               "effect": ["NoSchedule", "PreferNoSchedule"][int(rng.integers(2))]}])
            if rng.random() < 0.3:
                b = b.images({"app:v1": int(rng.integers(100, 900)) * 1024 * 1024})
            if rng.random() < 0.1:
                b = b.unschedulable()
            nodes.append(b.obj())

        def pod(name):
            b = m.MakePod(name).labels({"app": f"a{int(rng.integers(3))}"}).req({
                "cpu": f"{int(rng.choice([100, 500, 1000, 2500]))}m",
                "memory": f"{int(rng.choice([256, 1024, 3072]))}Mi"},
                host_port=int(rng.choice([0, 0, 0, 8080]))).priority(int(rng.choice([0, 5, 10])))
            k = int(rng.integers(8))
            if k == 0:
                b = b.topology_spread(1, ZONE, "DoNotSchedule", {"app": "a0"})
            elif k == 1:
                b = b.topology_spread(2, ZONE, "ScheduleAnyway", {"app": "a1"})
            elif k == 2:
                b = b.pod_anti_affinity(HOST, {"app": "a2"})
            elif k == 3:
                b = b.pod_affinity(ZONE, {"app": "a1"})
            elif k == 4:
                b = b.preferred_pod_affinity(7, ZONE, {"app": "a0"})
            elif k == 5:
                b = b.preferred_node_affinity(4, "tier", ["a"])
            if rng.random() < 0.3:
                b = b.toleration("spot", "true")
            if rng.random() < 0.2:
                b = b.container("app:v1")
            return b.obj()

        pending = [pod(f"p{i}") for i in range(n_pods)]
        bound = []
        for i in range(n_bound):
            p = pod(f"b{i}")
            p.spec.node_name = f"n{int(rng.integers(n_nodes))}"
            bound.append(p)
        return nodes, pending, bound

    build.__name__ = f"np_cluster_{seed}"
    return build


# -- the tables of tests/test_plugins.py as scenarios ----------------------------


def sc_fit_table(m):
    nodes = [m.MakeNode("n1").capacity({"cpu": "2", "memory": "4Gi", "pods": "10"}).obj(),
             m.MakeNode("full").capacity({"cpu": "2", "memory": "4Gi", "pods": "1"}).obj(),
             m.MakeNode("gpu").capacity({"cpu": "2", "memory": "4Gi",
                                         "example.com/gpu": "2"}).obj()]
    bound = [m.MakePod("existing").req({"cpu": "1500m", "memory": "3Gi"}).node("n1").obj(),
             m.MakePod("one").req({"cpu": "100m"}).node("full").obj()]
    pods = [m.MakePod("fits").req({"cpu": "1", "memory": "2Gi"}).obj(),
            m.MakePod("cpu").req({"cpu": "1"}).obj(),
            m.MakePod("both").req({"cpu": "1", "memory": "2Gi"}).obj(),
            m.MakePod("gpu").req({"cpu": "100m", "example.com/gpu": "1"}).obj(),
            m.MakePod("zero").req({}).obj()]
    return nodes, pods, bound


def sc_node_rules(m):
    nodes = [m.MakeNode("ssd").labels({"disk": "ssd", ZONE: "a"}).capacity({"cpu": "8"}).obj(),
             m.MakeNode("hdd").labels({"disk": "hdd", ZONE: "b"}).capacity({"cpu": "8"}).obj(),
             m.MakeNode("taint").taints([{"key": "k", "value": "v", "effect": "NoSchedule"},
                                         {"key": "s", "value": "1",
                                          "effect": "PreferNoSchedule"}])
             .capacity({"cpu": "8"}).obj(),
             m.MakeNode("cordon").unschedulable().capacity({"cpu": "8"}).obj(),
             m.MakeNode("warm").images({"img:1": 500 * 1024 * 1024}).capacity({"cpu": "8"}).obj()]
    bound = [m.MakePod("porty").req({"cpu": "100m"}, host_port=80).node("ssd").obj()]
    pods = [m.MakePod("sel").node_selector({"disk": "ssd"}).req({"cpu": "1"}).obj(),
            m.MakePod("aff").node_affinity_in("disk", ["hdd"]).req({"cpu": "1"}).obj(),
            m.MakePod("pref").preferred_node_affinity(10, "disk", ["hdd"])
            .preferred_node_affinity(3, ZONE, ["a"]).req({"cpu": "1"}).obj(),
            m.MakePod("tol").toleration("k", "v", effect="NoSchedule").req({"cpu": "1"}).obj(),
            m.MakePod("cordon-tol").toleration("node.kubernetes.io/unschedulable", "",
                                               operator="Exists").req({"cpu": "1"}).obj(),
            m.MakePod("port").req({"cpu": "1"}, host_port=80).obj(),
            m.MakePod("named").node("hdd").req({"cpu": "1"}).obj(),
            m.MakePod("image").container("img:1").req({"cpu": "1"}).obj()]
    # a pod with spec.node_name set is NodeName-filtered, not bound here
    for p in pods:
        if p.metadata.name == "named":
            p.spec.node_name = "hdd"
    return nodes, pods, bound


def sc_spread_table(m):
    nodes = [m.MakeNode(f"n{i}").labels({ZONE: "a" if i < 2 else "b"}).obj() for i in range(4)]
    nodes.append(m.MakeNode("plain").obj())
    bound = [m.MakePod(f"e{i}").labels({"app": "web"}).node("n0").obj() for i in range(2)]
    bound.append(m.MakePod("e9").labels({"app": "web"}).node("n2").obj())
    pods = [m.MakePod("skew").labels({"app": "web"})
            .topology_spread(1, ZONE, "DoNotSchedule", {"app": "web"}).obj(),
            m.MakePod("mind").labels({"app": "web"})
            .topology_spread(1, ZONE, "DoNotSchedule", {"app": "web"}, min_domains=3).obj(),
            m.MakePod("soft").labels({"app": "web"})
            .topology_spread(1, ZONE, "ScheduleAnyway", {"app": "web"}).obj(),
            m.MakePod("host").labels({"app": "web"})
            .topology_spread(1, HOST, "ScheduleAnyway", {"app": "web"}).obj()]
    return nodes, pods, bound


def sc_affinity_table(m):
    nodes = [m.MakeNode("na").labels({ZONE: "a"}).obj(), m.MakeNode("nb").labels({ZONE: "b"}).obj()]
    bound = [m.MakePod("svc").labels({"app": "db"}).node("na").obj(),
             m.MakePod("w1").labels({"app": "web"}).node("na").obj(),
             m.MakePod("grumpy").pod_anti_affinity(ZONE, {"app": "cache"}).node("nb").obj(),
             m.MakePod("needy").pod_affinity(ZONE, {"app": "api"}).node("nb").obj(),
             m.MakePod("other", namespace="other").labels({"app": "q"}).node("nb").obj()]
    pods = [m.MakePod("req").pod_affinity(ZONE, {"app": "db"}).obj(),
            m.MakePod("first").labels({"app": "new"}).pod_affinity(ZONE, {"app": "new"}).obj(),
            m.MakePod("lonely").pod_affinity(ZONE, {"app": "new"}).obj(),
            m.MakePod("anti").labels({"app": "web"}).pod_anti_affinity(ZONE, {"app": "web"}).obj(),
            m.MakePod("cache").labels({"app": "cache"}).obj(),
            m.MakePod("api").labels({"app": "api"}).obj(),
            m.MakePod("ns").pod_affinity(ZONE, {"app": "q"}).obj(),
            m.MakePod("pref").preferred_pod_affinity(10, ZONE, {"app": "db"})
            .preferred_pod_anti_affinity(4, ZONE, {"app": "web"}).obj()]
    return nodes, pods, bound


TABLES = [sc_fit_table, sc_node_rules, sc_spread_table, sc_affinity_table]
SCENARIOS = TABLES + PARITY_WORKLOADS + MIXED_WORKLOADS + [np_cluster(s) for s in range(6)]


# -- the harness -----------------------------------------------------------------


def key(st):
    return (st.code.name, tuple(st.reasons), st.plugin)


def build_snapshot(fw_mod, nodes, bound):
    nis = {n.metadata.name: fw_mod.NodeInfo(n) for n in nodes}
    for p in bound:
        nis[p.spec.node_name].add_pod(fw_mod.PodInfo(p))
    return fw_mod.Snapshot(nis)


def plugin_rows(plugin, fw_mod, pod, snap, queued):
    """One plugin's every extension point on one pod, in the order the
    framework calls them."""
    state = fw_mod.CycleState()
    state.write("Snapshot", snap)
    state.write("TotalNodes", len(snap))
    nis = snap.node_info_list
    row = {}
    if hasattr(plugin, "pre_enqueue"):
        row["pre_enqueue"] = key(plugin.pre_enqueue(pod))
    if hasattr(plugin, "less"):
        row["less"] = [plugin.less(queued(pod, 1.0), queued(other, t))
                       for other, t in ((pod, 1.0), (pod, 0.5), (pod, 2.0))]
    if hasattr(plugin, "pre_filter"):
        res, st = plugin.pre_filter(state, pod, snap)
        row["pre_filter"] = (key(st), None if res is None else res.node_names)
    if hasattr(plugin, "filter"):
        row["filter"] = [key(plugin.filter(state, pod, ni)) for ni in nis]
    if hasattr(plugin, "score"):
        if hasattr(plugin, "pre_score"):
            row["pre_score"] = key(plugin.pre_score(state, pod, nis))
        scores = {}
        for ni in nis:
            s, st = plugin.score(state, pod, ni)
            assert st.is_success()
            scores[ni.node.metadata.name] = s
        row["raw_score"] = dict(scores)
        if hasattr(plugin, "normalize_score"):
            plugin.normalize_score(state, pod, scores)
        row["score"] = scores
    return row


def framework_rows(fw, fw_mod, pod, snap, bound):
    """The runtime over all default plugins: prefilter, filter per node,
    score totals of the feasible nodes, then the same filters after removing
    and re-adding one bound pod through the PreFilterExtensions, and with
    that pod as a nominated pod."""
    state = fw_mod.CycleState()
    res, st = fw.run_pre_filter(state, pod, snap)
    out = {"pre_filter": (key(st), res.node_names)}
    if not st.is_success():
        return out
    nis = snap.node_info_list
    filt = [fw.run_filter(state, pod, ni) for ni in nis]
    out["filter"] = [key(f) for f in filt]
    feasible = [ni for ni, f in zip(nis, filt) if f.is_success()]
    if feasible:
        out["pre_score"] = key(fw.run_pre_score(state, pod, feasible))
        out["totals"] = fw.run_score(state, pod, feasible)
    if bound:
        victim = bound[0]
        ni = snap.get(victim.spec.node_name).clone()
        st2 = state.clone()
        ni.remove_pod(victim)
        out["remove"] = key(fw.run_remove_pod(st2, pod, victim, ni))
        out["after_remove"] = key(fw.run_filter(st2, pod, ni))
        ni.add_pod(fw_mod.PodInfo(victim))
        out["add"] = key(fw.run_add_pod(st2, pod, victim, ni))
        out["after_add"] = key(fw.run_filter(st2, pod, ni))
        other = snap.node_info_list[-1]
        out["nominated"] = key(fw.run_filter_with_nominated_pods(
            state.clone(), pod, other, [victim]))
    return out


def tables(pkg, scenario):
    m, fw_mod, rt, dp = PKGS[pkg]
    nodes, pods, bound = unpack(scenario(m))
    snap = build_snapshot(fw_mod, nodes, bound)
    fw = rt.Framework(dp())
    from kubernetes_tpu.scheduler.queue import QueuedPodInfo as JQ
    from kubernetes_tpu_torch.scheduler.queue import QueuedPodInfo as TQ

    qcls = TQ if pkg == "port" else JQ

    def queued(pod, t):
        return qcls(pod=pod, timestamp=t)

    out = []
    for pod in pods[:8]:
        rows = {p.name: plugin_rows(p, fw_mod, pod, snap, queued) for p in fw.plugins
                if p.name != "DefaultPreemption"}
        rows["framework"] = framework_rows(fw, fw_mod, pod, snap, bound)
        out.append((pod.metadata.name, rows))
    return out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_plugins_and_runtime_match_jax(scenario):
    want = tables("jax", scenario)
    got = tables("port", scenario)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, w), (_, g) in zip(want, got):
        assert g.keys() == w.keys()
        for plugin in w:
            assert g[plugin] == w[plugin], (name, plugin)


def test_default_plugin_order_is_the_jax_order_without_the_fallback_plugins():
    # the volume plugins came with the fallback classes: the lists are equal
    want = [p.name for p in jdefault()]
    assert [p.name for p in tdefault()] == want
    tf, jf = trt.Framework(tdefault()), jrt.Framework(jdefault())
    for point in ("pre_enqueue_plugins", "pre_filter_plugins", "filter_plugins",
                  "post_filter_plugins", "pre_score_plugins", "score_plugins"):
        assert ([p.name for p in getattr(tf, point)]
                == [p.name for p in getattr(jf, point)]), point
    assert tf.weights == jf.weights
    assert tf.queue_sort_plugin.name == jf.queue_sort_plugin.name == "PrioritySort"


@pytest.mark.parametrize("seed", range(8))
def test_default_normalize_score_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for reverse in (False, True):
        raw = {f"n{i}": int(v) for i, v in enumerate(rng.integers(0, 50, size=7) * (seed % 3 != 0))}
        want, got = dict(raw), dict(raw)
        jfw.default_normalize_score(100, reverse, want)
        tfw.default_normalize_score(100, reverse, got)
        assert got == want


def test_status_cycle_state_and_prefilter_result_match_jax():
    for mod in (jfw, tfw):
        assert mod.Status.unresolvable("x", plugin="P").is_rejected()
        assert mod.Status.skip("P").is_skip()
        assert not mod.Status.error("e").is_rejected()
    for make in ("success", "skip"):
        assert key(getattr(tfw.Status, make)()) == key(getattr(jfw.Status, make)())
    assert key(tfw.Status.unresolvable("a", "b", plugin="P")) == \
        key(jfw.Status.unresolvable("a", "b", plugin="P"))
    for mod in (jfw, tfw):
        a = mod.PreFilterResult({"n1", "n2"})
        assert a.merge(mod.PreFilterResult(None)).node_names == {"n1", "n2"}
        assert a.merge(mod.PreFilterResult({"n2", "n3"})).node_names == {"n2"}
        assert mod.PreFilterResult(None).all_nodes()
        cs = mod.CycleState()
        cs.write("k", [1])
        cs.skip_filter_plugins.add("P")
        c2 = cs.clone()
        c2.skip_filter_plugins.add("Q")
        assert cs.read("k") == [1] and c2.read_or_none("x") is None
        assert cs.skip_filter_plugins == {"P"}


@pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated"])
def test_fit_score_computes_the_pod_request_once_a_cycle(monkeypatch, strategy):
    """NodeResourcesFit.score reads the pod's non-zero request from the
    CycleState after the first node: the calls to compute_pod_resource_request
    in one per-pod cycle do not grow with the node count, and the scores
    equal the JAX package's."""
    import kubernetes_tpu_torch.api as tapi
    from kubernetes_tpu.scheduler.plugins import NodeResourcesFit as JFit
    from kubernetes_tpu_torch.scheduler.plugins import NodeResourcesFit as TFit
    from kubernetes_tpu_torch.scheduler.serial import Scheduler as TScheduler
    from kubernetes_tpu_torch.store import APIStore as TStore

    real = tapi.compute_pod_resource_request
    calls = []

    def counting(pod, *a, **kw):
        calls.append(pod.metadata.name)
        return real(pod, *a, **kw)

    monkeypatch.setattr(tapi, "compute_pod_resource_request", counting)
    per_cycle = {}
    for n in (10, 50):
        store = TStore()
        for i in range(n):
            store.create("nodes", tt.MakeNode(f"n{i}").capacity(
                {"cpu": str(2 + i % 7), "memory": f"{4 + i % 5}Gi", "pods": "110"}).obj())
        sched = TScheduler(store, trt.Framework(tdefault()))
        sched.sync()
        pod = tt.MakePod("p").req({"cpu": "500m", "memory": "1Gi"}).obj()
        calls.clear()
        res = sched.schedule_pod(pod)
        assert res.suggested_host and res.feasible_nodes == n
        per_cycle[n] = len(calls)
    assert per_cycle[10] == per_cycle[50] <= 3
    # the cached request scores as the recomputed one did, on every node
    m = {"port": tt, "jax": jt}
    rows = []
    for pkg, fit, fw_mod in (("jax", JFit, jfw), ("port", TFit, tfw)):
        nodes = [m[pkg].MakeNode(f"n{i}").capacity(
            {"cpu": str(2 + i % 7), "memory": f"{4 + i % 5}Gi"}).obj() for i in range(50)]
        bound = [m[pkg].MakePod(f"b{i}").req({"cpu": "1"}).node(f"n{i}").obj()
                 for i in range(0, 50, 3)]
        snap = build_snapshot(fw_mod, nodes, bound)
        plugin = fit(strategy=strategy)
        state = fw_mod.CycleState()
        pod = m[pkg].MakePod("p").req({"cpu": "300m"}).obj()
        plugin.pre_filter(state, pod, snap)
        rows.append([plugin.score(state, pod, ni)[0] for ni in snap.node_info_list])
    assert rows[0] == rows[1]
