"""The port's partitioned scheduler (scheduler/partition.py) held against
the JAX package's on the same seeded inputs, on the CPU (the plain
versions of kernels B, C, D and A): the counterparts of
tests/test_partition.py run on both packages, with equal {pod: node} maps,
partition rows, and conflict / reroute / death counts wherever the JAX
result is deterministic — concurrent=False always, concurrent=True where no
pod crosses shards (disjoint shards make the drive order irrelevant).
Where a race decides the outcome (a killed partition's in-flight binds),
both packages are held to the same invariants instead: every pod bound
exactly once, conservation through the coordinator-aware checker.

Also: the coordinator branch of testing.pod_conservation_report catches a
pod accounted by two pipelines, the partition series count, and start()
names the item that brings the background mode. Tolerance 0.
"""

import copy
import gc
import importlib

import pytest

PKGS = ("jax", "port")
HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


class Pkg:
    """One package's surfaces, so a scenario is written once."""

    def __init__(self, name):
        root = "kubernetes_tpu" if name == "jax" else "kubernetes_tpu_torch"

        def mod(m):
            return importlib.import_module(f"{root}.{m}")

        self.name = name
        self.t = mod("testing")
        self.store_mod = mod("store")
        self.part = mod("scheduler.partition")
        self.batch = mod("scheduler.batch")
        self.queue = mod("scheduler.queue")
        self.fi = mod("chaos.faultinject")
        self.metrics = mod("server.metrics")
        self.labels = mod("api.labels")
        self.types = mod("api.types")
        self._fw = mod("scheduler.runtime").Framework
        self._plugins = mod("scheduler.plugins").default_plugins
        self.kw = {"device": "cpu"} if name == "port" else {}

    def fw(self):
        return self._fw(self._plugins())

    def store(self, **kw):
        return self.store_mod.APIStore(**kw)

    def coord(self, store, partitions=2, **kw):
        kw.setdefault("batch_size", 64)
        kw.setdefault("solver", "fast")
        return self.part.PartitionedScheduler(store, self.fw, partitions=partitions,
                                              **self.kw, **kw)

    def batch_sched(self, store, **kw):
        return self.batch.BatchScheduler(store, self.fw(), **self.kw, **kw)

    def node(self, name, labels=None, cpu="16"):
        labels = dict(labels or {})
        labels.setdefault(HOST, name)
        return self.t.MakeNode(name).labels(labels).capacity(
            {"cpu": cpu, "memory": "64Gi", "pods": "110"}).obj()

    def nodes(self, n, cpu="16", zones=0):
        return [self.node(f"node-{i}", {ZONE: f"zone-{i % zones}"} if zones else None, cpu)
                for i in range(n)]

    def pods(self, n, pfx="p", cpu="500m"):
        return [self.t.MakePod(f"{pfx}-{i}").req({"cpu": cpu, "memory": "1Gi"}).obj()
                for i in range(n)]

    def affinity(self, name, key, app, anti=False):
        pod = self.t.MakePod(name).req({"cpu": "100m"}).obj()
        term = self.types.PodAffinityTerm(
            topology_key=key, selector=self.labels.Selector.from_match_labels({"app": app}))
        pod.spec.affinity = (self.types.Affinity(pod_anti_affinity_required=[term]) if anti
                             else self.types.Affinity(pod_affinity_required=[term]))
        return pod


P = {name: Pkg(name) for name in PKGS}


@pytest.fixture(autouse=True)
def _force_mutation_detector(monkeypatch):
    # both packages' stores run with the detector on and are checked at
    # teardown: the pipelines share one store and one event stream
    gens = [P[name].t.mutation_detector_guard(monkeypatch) for name in PKGS]
    for g in gens:
        next(g)
    yield
    for g in gens:
        next(g, None)


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    for p in P.values():
        p.fi.disarm()


@pytest.fixture(autouse=True)
def _collect_schedulers():
    # every pipeline registers in its package's weak scheduler registry;
    # collect so a later test never reads these coordinators
    yield
    gc.collect()


def drain(sched):
    sched.run_until_idle()
    sched.flush_binds()


def placements(store):
    return sorted((p.key, p.spec.node_name) for p in store.list("pods")[0])


def bind_transitions(store):
    out = {}
    for ev in store.history_events():
        if ev.kind != "pods" or ev.type != "MODIFIED":
            continue
        if ev.obj.spec.node_name and (ev.prev is None or not ev.prev.spec.node_name):
            out[ev.obj.key] = out.get(ev.obj.key, 0) + 1
    return out


ROW_KEYS = ("index", "dead", "nodes", "scheduled", "failed", "conflicts", "reroutes",
            "breaker", "queue")


def summary(ps):
    """What the two packages must agree on: the counters and partition rows."""
    st = ps.sched_stats()
    return {"scheduled": st["scheduled"], "failed": st["failed"],
            "conflicts": st["conflicts"], "reroutes": st["reroutes"],
            "dispatch_faults": st["dispatch_faults"], "live": st["live"],
            "partitions_absorbed": st["partitions_absorbed"],
            "residual": st["residual"],
            "rows": [{k: r[k] for k in ROW_KEYS} for r in st["rows"]]}


def both(scenario, *args, **kw):
    return {name: scenario(P[name], *args, **kw) for name in PKGS}


# ---------------------------------------------------------------------------
# (a) partitions=1 parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("columnar", [True, False])
def test_partitions_1_is_byte_identical(columnar):
    """partitions=1 is pure delegation: the same placements, RVs and event
    stream as a standalone BatchScheduler of the port, and the JAX
    package's placements."""
    def run(p, build):
        store = p.store()
        for n in p.nodes(24):
            store.create("nodes", n)
        s = build(store)
        s.sync()
        store.create_many("pods", p.pods(300), consume=True)
        drain(s)
        events = [(ev.type, ev.kind, ev.resource_version,
                   ev.obj.key if hasattr(ev.obj, "key") else None,
                   getattr(ev.obj.spec, "node_name", None) if ev.kind == "pods" else None)
                  for ev in store.history_events()]
        return placements(store), events

    t = P["port"]
    pl_a, ev_a = run(t, lambda st: t.batch_sched(st, batch_size=256, solver="fast",
                                                  columnar=columnar))
    pl_b, ev_b = run(t, lambda st: t.coord(st, partitions=1, batch_size=256,
                                           columnar=columnar))
    j = P["jax"]
    pl_j, ev_j = run(j, lambda st: j.coord(st, partitions=1, batch_size=256,
                                           columnar=columnar))
    assert pl_a == pl_b == pl_j
    assert ev_a == ev_b == ev_j
    assert len(pl_a) == 300 and all(node for _k, node in pl_a)


def test_partitions_1_has_no_hooks_or_residual():
    for p in P.values():
        ps = p.coord(p.store(), partitions=1)
        pipe = ps.pipelines[0]
        assert pipe._pod_gate is None and pipe._node_filter is None
        assert pipe.reroute_hook is None and pipe.conflict_sink is None
        assert pipe.partition_index is None and pipe.sched_stats()["partition"] is None
        assert ps._residual is None and not ps._residual_enabled


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("concurrent", [False, True])
def test_hash_routing_splits_nodes_and_pods_disjointly(concurrent):
    def run(p):
        store = p.store()
        for n in p.nodes(40):
            store.create("nodes", n)
        ps = p.coord(store, batch_size=256, concurrent=concurrent)
        ps.sync()
        counts = [pipe.cache.node_count() for pipe in ps.pipelines]
        store.create_many("pods", p.pods(400, "hr"), consume=True)
        drain(ps)
        bound = [pod for pod in store.list("pods")[0] if pod.spec.node_name]
        by_part = {0: set(), 1: set()}
        for pod in bound:
            by_part[ps.router.partition_of_node_name(pod.spec.node_name)].add(
                pod.spec.node_name)
        rep = p.t.assert_pod_conservation(store, ps, [pod.key for pod in bound])
        return (placements(store), counts, summary(ps), rep["counts"],
                sorted(by_part[0]), sorted(by_part[1]))

    got = both(run)
    assert got["jax"] == got["port"]
    pl, counts, summ, cons, b0, b1 = got["port"]
    assert sum(counts) == 40 and all(counts)
    assert len(pl) == 400 and all(node for _k, node in pl)
    assert b0 and b1 and not set(b0) & set(b1)
    assert cons["bound"] == 400 and summ["conflicts"] == summ["reroutes"] == 0


def test_zone_routing_keeps_zones_whole():
    def run(p):
        store = p.store()
        nodes = p.nodes(24, zones=4)
        for n in nodes:
            store.create("nodes", n)
        ps = p.coord(store, partition_by="zone")
        ps.sync()
        owners = {n.metadata.name: ps.router.partition_of_node_name(n.metadata.name)
                  for n in nodes}
        return owners, [pipe.cache.node_count() for pipe in ps.pipelines]

    got = both(run)
    assert got["jax"] == got["port"]
    owners, counts = got["port"]
    for z in range(4):
        assert len({o for name, o in owners.items() if int(name.split("-")[1]) % 4 == z}) == 1
    assert sum(counts) == 24


def test_spanning_pods_pin_to_designated_partition():
    def run(p):
        aff = p.affinity("aff", HOST, "db")
        plain = p.t.MakePod("plain").req({"cpu": "100m"}).obj()
        gang = p.t.MakePod("g0").labels({"pod-group.scheduling/name": "grp"}).obj()
        spread = p.t.MakePod("sp").labels({"app": "s"}).topology_spread(
            1, ZONE, "DoNotSchedule", {"app": "s"}).obj()
        r = p.part.PartitionRouter(4)
        pods = [aff, plain, gang, spread] + p.pods(32, "route")
        return ([p.part.spans_partitions(x) for x in pods],
                [r.partition_of_pod(x) for x in pods])

    got = both(run)
    assert got["jax"] == got["port"]
    spans, parts = got["port"]
    assert spans[:4] == [True, False, True, True]
    assert parts[0] == parts[2] == parts[3] == 0


# ---------------------------------------------------------------------------
# (c) re-route + residual
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("concurrent", [False, True])
def test_shard_unschedulable_pod_reroutes_and_binds(concurrent):
    def run(p):
        store = p.store()
        nodes = p.nodes(8)
        r = p.part.PartitionRouter(2)
        shard0 = [n for n in nodes if r.observe_node(n) == 0]
        shard1 = [n for n in nodes if r.observe_node(n) == 1]
        for n in shard0[:1] + shard1:
            store.create("nodes", n)
        ps = p.coord(store, batch_size=256, concurrent=concurrent)
        ps.sync()
        n_pods = 30 * (1 + len(shard1))
        store.create_many("pods", p.pods(n_pods, "rr"), consume=True)
        drain(ps)
        rep = p.t.assert_pod_conservation(store, ps, [f"default/rr-{i}" for i in range(n_pods)])
        return placements(store), summary(ps), rep["counts"], n_pods

    got = both(run)
    pl, summ, cons, n_pods = got["port"]
    assert cons["bound"] == n_pods and summ["reroutes"] > 0
    if not concurrent:
        assert got["jax"] == got["port"]
    else:
        # the hop lands in a queue that may be mid-drive: the counts and the
        # conservation hold, the exact map is the interleaving's
        assert got["jax"][2] == cons


def test_residual_pass_places_spanning_pod_with_global_view():
    def run(p):
        store = p.store()
        nodes = p.nodes(8)
        probe = p.part.PartitionRouter(2)
        shard1 = [n for n in nodes if probe.observe_node(n) == 1]
        for n in nodes:
            store.create("nodes", n)
        ps = p.coord(store)
        ps.sync()
        anchor = p.t.MakePod("anchor").labels({"app": "db"}).req({"cpu": "100m"}).obj()
        anchor.spec.node_name = shard1[0].metadata.name
        store.create("pods", anchor)
        store.create("pods", p.affinity("aff", HOST, "db"))
        drain(ps)
        return (store.get("pods", "default/aff").spec.node_name, shard1[0].metadata.name,
                summary(ps))

    got = both(run)
    assert got["jax"] == got["port"]
    node, want, summ = got["port"]
    assert node == want
    assert summ["residual"]["passes"] >= 1 and summ["residual"]["scheduled"] >= 1


def test_residual_disabled_parks_locally():
    def run(p):
        store = p.store()
        for n in p.nodes(4):
            store.create("nodes", n)
        ps = p.coord(store, residual=False)
        ps.sync()
        store.create("pods", p.t.MakePod("too-big").req({"cpu": "64"}).obj())
        drain(ps)
        return ps.residual_passes, ["default/too-big" in pipe.queue.tracked_keys()
                                    for pipe in ps.pipelines]

    got = both(run)
    assert got["jax"] == got["port"]
    assert got["port"][0] == 0 and any(got["port"][1])


# ---------------------------------------------------------------------------
# (b) conflicts: exactly-once binding under a cross-partition race
# ---------------------------------------------------------------------------


def test_is_bind_conflict_recognizer():
    msgs = ["pod default/x is already bound to node-3", "pods default/x not found",
            "injected fault at store.bind_many", "ALREADY BOUND", ""]
    got = {name: [P[name].store_mod.is_bind_conflict(m) for m in msgs] for name in PKGS}
    assert got["jax"] == got["port"]
    assert got["port"][:3] == [True, False, False]


def test_cross_partition_race_binds_exactly_once():
    """Both partitions hold the SAME pods (a double-routing race), both
    assume and bind; the store arbitrates, the loser absorbs the conflict
    through conflict_sink, and every pod is bound exactly once."""
    def run(p):
        store = p.store()
        for n in p.nodes(8):
            store.create("nodes", n)
        ps = p.coord(store, concurrent=False)
        ps.sync()
        store.create_many("pods", p.pods(20, "race"), consume=True)
        for pipe in ps.pipelines:
            pipe.pump_events()
        for pipe in ps.pipelines:
            other = ps.pipelines[1 - pipe.partition_index]
            for key in list(other.queue.tracked_keys()):
                pipe.queue.add_requeued([p.queue.QueuedPodInfo(
                    pod=store.get("pods", key), timestamp=pipe.clock.now())])
        before = sum(p.metrics.partition_conflicts_total.value(partition=str(i))
                     for i in range(2))
        drain(ps)
        trans = bind_transitions(store)
        p.t.assert_pod_conservation(store, ps, [f"default/race-{i}" for i in range(20)])
        after = sum(p.metrics.partition_conflicts_total.value(partition=str(i))
                    for i in range(2))
        return (placements(store), summary(ps), sorted(trans.values()),
                [pipe.cache.assumed_count() for pipe in ps.pipelines], after - before)

    got = both(run)
    assert got["jax"] == got["port"]
    pl, summ, trans, assumed, series = got["port"]
    assert len(pl) == 20 and all(n for _k, n in pl)
    assert trans == [1] * 20
    assert summ["conflicts"] > 0 and series == summ["conflicts"]
    assert assumed == [0, 0]


def test_foreign_bound_event_cleans_stale_queue_entry():
    def run(p):
        store = p.store()
        nodes = p.nodes(8)
        for n in nodes:
            store.create("nodes", n)
        ps = p.coord(store)
        ps.sync()
        pod = p.pods(1, "stale")[0]
        store.create("pods", pod)
        for pipe in ps.pipelines:
            pipe.pump_events()
        owner = ps.router.partition_of_pod(pod)
        loser = ps.pipelines[1 - owner]
        loser.queue.add_requeued([p.queue.QueuedPodInfo(pod=store.get("pods", pod.key),
                                                        timestamp=loser.clock.now())])
        had = loser.queue.contains(pod.key)
        target = next(n.metadata.name for n in nodes
                      if ps.router.partition_of_node_name(n.metadata.name) == owner)
        store.bind(pod.metadata.namespace, pod.metadata.name, target)
        loser.pump_events()
        ps.pipelines[owner].pump_events()
        return owner, had, loser.queue.contains(pod.key), \
            ps.pipelines[owner].cache.contains(pod.key)

    got = both(run)
    assert got["jax"] == got["port"]
    assert got["port"][1:] == (True, False, True)


# ---------------------------------------------------------------------------
# (d) partition death absorption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("concurrent", [False, True])
def test_partition_hard_kill_absorbed_with_conservation(concurrent):
    """A kill plan on partition-1's second drive cycle: the survivor absorbs
    the shard. Whether the corpse's in-flight binds land before or after the
    survivor's resync is a race, so both packages are held to the same
    invariants rather than to one map."""
    def run(p):
        store = p.store()
        for n in p.nodes(12):
            store.create("nodes", n)
        ps = p.coord(store, concurrent=concurrent)
        ps.sync()
        store.create_many("pods", p.pods(200, "kk"), consume=True)
        deaths0 = p.metrics.partition_deaths_total.value(partition="1")
        p.fi.arm([p.fi.FaultPlan("partition.dispatch", "kill", match="partition-1", after=1)])
        try:
            ps.run_until_idle()
        finally:
            p.fi.disarm()
        drain(ps)
        rep = p.t.assert_pod_conservation(store, ps, [f"default/kk-{i}" for i in range(200)])
        return (ps.partitions_absorbed, ps.router.live_partitions(), rep["counts"]["bound"],
                sorted(set(bind_transitions(store).values())),
                ps.pipelines[0].cache.node_count(),
                p.metrics.partition_deaths_total.value(partition="1") - deaths0)

    got = both(run)
    assert got["jax"] == got["port"] == (1, [0], 200, [1], 12, 1)


def test_dispatch_fail_plan_is_absorbed():
    def run(p):
        store = p.store()
        for n in p.nodes(6):
            store.create("nodes", n)
        ps = p.coord(store, concurrent=False)
        ps.sync()
        store.create_many("pods", p.pods(60, "df"), consume=True)
        p.fi.arm([p.fi.FaultPlan("partition.dispatch", "fail", count=3)])
        try:
            drain(ps)
        finally:
            p.fi.disarm()
        return placements(store), summary(ps)

    got = both(run)
    assert got["jax"] == got["port"]
    pl, summ = got["port"]
    assert summ["dispatch_faults"] == 3 and all(n for _k, n in pl) and len(pl) == 60


@pytest.mark.parametrize("concurrent", [False, True])
def test_kill_partition_entrypoint(concurrent):
    def run(p):
        store = p.store()
        for n in p.nodes(8):
            store.create("nodes", n)
        ps = p.coord(store, concurrent=concurrent)
        ps.sync()
        store.create_many("pods", p.pods(100, "ke"), consume=True)
        drain(ps)
        before = ps.scheduled_count
        ps.kill_partition(1)
        store.create_many("pods", p.pods(50, "ke2"), consume=True)
        drain(ps)
        return before, ps.router.live_partitions(), placements(store), \
            ps.pipelines[0].cache.node_count(), summary(ps)

    got = both(run)
    assert got["jax"] == got["port"]
    before, live, pl, nodes, _summ = got["port"]
    assert before == 100 and live == [0] and nodes == 8
    assert len(pl) == 150 and all(n for _k, n in pl)


def test_kill_partition_is_idempotent():
    def run(p):
        store = p.store()
        for n in p.nodes(6):
            store.create("nodes", n)
        ps = p.coord(store)
        ps.sync()
        ps.kill_partition(1)
        ps.kill_partition(1)
        return ps.partitions_absorbed, ps.router.live_partitions()

    got = both(run)
    assert got["jax"] == got["port"] == (1, [0])


# ---------------------------------------------------------------------------
# observability + router unit coverage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("concurrent", [False, True])
def test_sched_stats_merged_and_per_partition_rows(concurrent):
    def run(p):
        store = p.store()
        for n in p.nodes(10):
            store.create("nodes", n)
        ps = p.coord(store, concurrent=concurrent)
        ps.sync()
        store.create_many("pods", p.pods(100, "ob"), consume=True)
        drain(ps)
        st = ps.sched_stats()
        sections = [pipe.sched_stats()["partition"] for pipe in ps.pipelines]
        probes = [pipe._partition_window_probe() for pipe in ps.pipelines]
        merged = {k: v["batches"] for k, v in st["stages_merged"].items()}
        return (placements(store), summary(ps), sections, probes, merged,
                {k: st[k] for k in ("partitions", "partition_by", "concurrent_drive")})

    got = both(run)
    assert got["jax"] == got["port"]
    pl, summ, sections, probes, merged, head = got["port"]
    assert head == {"partitions": 2, "partition_by": "hash", "concurrent_drive": concurrent}
    assert summ["scheduled"] == 100 and summ["live"] == 2
    assert sum(r["nodes"] for r in summ["rows"]) == 10
    assert merged.get("solve", 0) >= 2
    for i, sec in enumerate(sections):
        assert sec["index"] == i and sec["nodes"] == summ["rows"][i]["nodes"]
        assert probes[i] == {"index": i, "conflicts": 0, "reroutes": 0}


def test_router_absorb_remaps_all_slots_to_survivors():
    def run(p):
        r = p.part.PartitionRouter(3)
        survivors = r.absorb(1)
        return (survivors, [r.partition_of_node_name(f"node-{i}") for i in range(64)],
                [r.partition_of_pod(x) for x in p.pods(16)])

    got = both(run)
    assert got["jax"] == got["port"]
    survivors, nodes, pods = got["port"]
    assert survivors == [0, 2] and set(nodes + pods) <= {0, 2}


def test_router_next_hop_is_bounded_and_clears():
    def run(p):
        r = p.part.PartitionRouter(3)
        pod = p.pods(1, "hop")[0]
        cur = home = r.partition_of_pod(pod)
        hops = []
        while True:
            nxt = r.next_hop(pod, cur)
            if nxt is None:
                break
            hops.append(nxt)
            cur = nxt
        return home, hops, r.override_count()

    got = both(run)
    assert got["jax"] == got["port"]
    home, hops, left = got["port"]
    assert len(hops) == len(set(hops)) <= 2 and left == 0


def test_queue_contains_is_consistent_across_tiers():
    def run(p):
        q = p.queue.SchedulingQueue()
        pod = p.pods(1, "qc")[0]
        out = []
        q.add(pod)
        out.append(q.contains(pod.key))
        qp = q.pop(timeout=0)
        out.append(q.contains(pod.key))
        q.add_backoff([qp])
        out.append(q.contains(pod.key))
        q.delete_key(pod.key)
        out.append(q.contains(pod.key))
        q.add_unschedulable(qp)
        out.append(q.contains(pod.key))
        q.clear()
        out.append(q.contains(pod.key))
        q.add_requeued([qp])
        out.append((q.contains(pod.key), q.lengths()))
        return out

    got = both(run)
    assert got["jax"] == got["port"]
    assert got["port"] == [True, False, True, False, True, False, (True, (1, 0, 0))]


def test_zone_label_migration_moves_node_between_shards():
    def run(p):
        store = p.store()
        ps = p.coord(store, partition_by="zone")
        ps.sync()
        for n in p.nodes(2, zones=2):
            store.create("nodes", n)
        store.create("nodes", p.node("drift-node"))
        ps.pump_events()
        old = ps.router.partition_of_node_name("drift-node")
        for zone in ("zone-0", "zone-1"):
            if ps.router.observe_node(p.node("drift-node", {ZONE: zone})) != old:
                break
        relabeled = copy.deepcopy(store.get("nodes", "drift-node"))
        relabeled.metadata.labels[ZONE] = zone
        store.update("nodes", relabeled)
        ps.pump_events()
        new = ps.router.partition_of_node_name("drift-node")
        held = [int(pipe.cache.update_snapshot().get("drift-node") is not None)
                for pipe in ps.pipelines]
        return old, new, held

    got = both(run)
    assert got["jax"] == got["port"]
    old, new, held = got["port"]
    assert new != old and held[new] == 1 and held[old] == 0


def test_required_anti_affinity_not_violated_across_shards():
    def run(p):
        store = p.store()
        probe = p.part.PartitionRouter(2)
        nodes = [p.node(f"node-{i}", {ZONE: "zone-b"}) for i in range(12)]
        shard_of = {n.metadata.name: probe.observe_node(n) for n in nodes}
        a0 = next(n for n in nodes if shard_of[n.metadata.name] == 0)
        a1 = next(n for n in nodes if shard_of[n.metadata.name] == 1)
        for n in (a0, a1):
            n.metadata.labels[ZONE] = "zone-a"
        for n in nodes:
            store.create("nodes", n)
        ps = p.coord(store)
        ps.sync()
        witness = p.t.MakePod("web").labels({"app": "web"}).req({"cpu": "100m"}).obj()
        witness.spec.node_name = a1.metadata.name
        store.create("pods", witness)
        store.create("pods", p.affinity("anti", ZONE, "web", anti=True))
        drain(ps)
        return (store.get("pods", "default/anti").spec.node_name,
                [a0.metadata.name, a1.metadata.name], ps.residual_passes)

    got = both(run)
    assert got["jax"] == got["port"]
    node, zone_a, passes = got["port"]
    assert node and node not in zone_a and passes >= 1


def test_gang_quorum_counts_foreign_bound_members_residual_disabled():
    def run(p):
        store = p.store()
        nodes = p.nodes(10)
        probe = p.part.PartitionRouter(2)
        shard1 = [n for n in nodes if probe.observe_node(n) == 1]
        for n in nodes:
            store.create("nodes", n)
        store.create("podgroups", p.t.make_pod_group("g1", min_member=4))
        for i in range(2):
            m = p.t.MakePod(f"g1-bound-{i}").labels(
                {"pod-group.scheduling/name": "g1"}).req({"cpu": "100m"}).obj()
            m.spec.node_name = shard1[i % len(shard1)].metadata.name
            store.create("pods", m)
        ps = p.coord(store, residual=False)
        ps.sync()
        pinned = ps.router.designated()
        placed = ps.pipelines[pinned].gangs.placed_count("default/g1")
        store.create_many("pods", [
            p.t.MakePod(f"g1-new-{i}").labels({"pod-group.scheduling/name": "g1"})
            .req({"cpu": "100m"}).obj() for i in range(2)], consume=True)
        drain(ps)
        return placed, placements(store)

    got = both(run)
    assert got["jax"] == got["port"]
    placed, pl = got["port"]
    assert placed == 2
    assert sum(1 for k, n in pl if k.startswith("default/g1-new-") and n) == 2


def test_stop_releases_bind_worker_thread():
    p = P["port"]
    store = p.store()
    for n in p.nodes(4):
        store.create("nodes", n)
    ps = p.coord(store)
    ps.sync()
    store.create_many("pods", p.pods(20, "bw"), consume=True)
    drain(ps)
    workers = [pipe._bind_worker for pipe in ps.pipelines if pipe._bind_worker is not None]
    assert workers and all(w.is_alive() for w in workers)
    ps.stop()
    for w in workers:
        w.join(timeout=5)
    assert not any(w.is_alive() for w in workers)
    assert all(pipe._bind_worker is None for pipe in ps.pipelines)


# ---------------------------------------------------------------------------
# the port's own surfaces
# ---------------------------------------------------------------------------


def test_zone_residual_spread_matches_jax():
    """Zone shards, plain pods and zone-spread pods (maxSkew 1): the shards
    place the plain pods, the residual pass the spread ones, equal maps and
    rows, skew <= 1."""
    def run(p):
        store = p.store()
        for n in p.nodes(20, zones=5):
            store.create("nodes", n)
        ps = p.coord(store, partition_by="zone", batch_size=512, concurrent=False)
        ps.sync()
        spread = [p.t.MakePod(f"sp-{i}").labels({"app": "s"}).req({"cpu": "200m"})
                  .topology_spread(1, ZONE, "DoNotSchedule", {"app": "s"}).obj()
                  for i in range(25)]
        store.create_many("pods", p.pods(300, "zp") + spread, consume=True)
        drain(ps)
        repair = dict(ps._residual.repair_totals)
        return placements(store), summary(ps), repair

    got = both(run)
    assert got["jax"] == got["port"]
    pl, summ, repair = got["port"]
    assert summ["residual"]["passes"] >= 1 and summ["residual"]["scheduled"] == 25
    zones = {}
    for key, node in pl:
        if key.startswith("default/sp-"):
            z = int(node.split("-")[1]) % 5
            zones[z] = zones.get(z, 0) + 1
    assert len(zones) == 5 and max(zones.values()) - min(zones.values()) <= 1
    assert repair["batches"] >= 1


def test_conservation_catches_a_pod_accounted_by_two_pipelines():
    """The coordinator branch of pod_conservation_report: a pod the store
    binds once but two DISJOINT pipelines' caches both account is
    double_bound, as the JAX checker says; the residual's mirror cache
    holding every bound pod is not."""
    def run(p):
        store = p.store()
        for n in p.nodes(8):
            store.create("nodes", n)
        ps = p.coord(store)
        ps.sync()
        store.create_many("pods", p.pods(20, "dc"), consume=True)
        store.create("pods", p.affinity("aff", HOST, "none"))  # a residual pass
        drain(ps)
        keys = [f"default/dc-{i}" for i in range(20)]
        clean = p.t.pod_conservation_report(store, ps, keys)["counts"]
        # account one bound pod of pipeline 0 in pipeline 1's cache as well
        pod = next(x for x in store.list("pods")[0]
                   if x.key in keys and ps.router.partition_of_node_name(x.spec.node_name) == 0)
        other = ps.pipelines[1]
        other.cache.add_node(store.get("nodes", pod.spec.node_name))
        other.cache.add_pod(pod)
        dirty = p.t.pod_conservation_report(store, ps, keys)
        return clean, dirty["double_bound"], pod.key

    got = both(run)
    assert got["jax"] == got["port"]
    clean, double, key = got["port"]
    assert clean["double_bound"] == 0 and clean["lost"] == 0 and clean["bound"] == 20
    assert double == [key]


def test_partition_series_and_start():
    p = P["port"]
    for name in ("partition_conflicts_total", "partition_reroutes_total",
                 "partition_deaths_total"):
        assert getattr(p.metrics, name).name == getattr(P["jax"].metrics, name).name
    ps = p.coord(p.store())
    with pytest.raises(NotImplementedError, match="queue 1 item 7g"):
        ps.start()
    ps.stop()
