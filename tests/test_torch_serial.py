"""The port's serial scheduler (scheduler/serial.py: the per-pod cycle
schedule_pod / _score_and_select / schedule_one / _commit_cycle, profiles,
PreEnqueue, QueueSort) against the JAX package's, tolerance 0.

The scenarios of tests/test_scheduler.py's end-to-end class, the parity
workloads of tests/test_batch_parity.py and numpy-seeded clusters run in
both packages over identical stores under fake clocks: the {pod: node} map,
the PodScheduled=False conditions, the events, the queue tiers and the
counters must be equal. Also: numFeasibleNodesToFind, the node-order cut
above 100 nodes, the nominated-node fast path and a custom QueueSort.
"""

import pytest
from test_torch_framework import np_cluster
from test_torch_workloads import HOST, MIXED_WORKLOADS, PARITY_WORKLOADS, ZONE, unpack

import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.scheduler import Framework as JFramework
from kubernetes_tpu.scheduler.batch import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.plugins import default_plugins as jdefault
from kubernetes_tpu.scheduler.serial import Scheduler as JScheduler
from kubernetes_tpu.scheduler.serial import num_feasible_nodes_to_find as j_nfn
from kubernetes_tpu.store import APIStore as JStore
from kubernetes_tpu.utils import FakeClock as JFakeClock
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.plugins import default_plugins as tdefault
from kubernetes_tpu_torch.scheduler.runtime import Framework as TFramework
from kubernetes_tpu_torch.scheduler.serial import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler.serial import num_feasible_nodes_to_find as t_nfn
from kubernetes_tpu_torch.store import APIStore as TStore
from kubernetes_tpu_torch.utils import FakeClock as TFakeClock


class Env:
    """One package's store, fake clock and scheduler, with the calls whose
    signatures differ between the packages wrapped."""

    def __init__(self, port: bool):
        self.port = port
        self.m = tt if port else jt
        self.store = TStore() if port else JStore()
        self.clock = TFakeClock(1000.0) if port else JFakeClock(1000.0)
        self.sched = None

    def framework(self, plugins=None):
        if self.port:
            return TFramework(plugins if plugins is not None else tdefault())
        return JFramework(plugins if plugins is not None else jdefault())

    def serial(self, **kw):
        kw.setdefault("pod_initial_backoff", 1.0)
        kw.setdefault("pod_max_backoff", 10.0)
        cls = TScheduler if self.port else JScheduler
        if "profiles" not in kw:
            kw["framework"] = self.framework()
        self.sched = cls(self.store, clock=self.clock, **kw)
        self.sched.sync()
        return self.sched

    def batch(self, solver="exact", **kw):
        if self.port:
            # the JAX side's configuration: synchronous binds (the worker's
            # pace would interleave its RVs with the per-pod route's writes)
            self.sched = TBatch(self.store, self.framework(), device="cpu", solver=solver,
                                pipeline_binds=False, clock=self.clock, **kw)
        else:
            self.sched = JBatch(self.store, self.framework(), solver=solver,
                                pipeline_binds=False, clock=self.clock, **kw)
        self.sched.sync()
        return self.sched

    def preemption(self):
        """The default profile's DefaultPreemption (both packages)."""
        for p in self.sched.framework.post_filter_plugins:
            if p.name == "DefaultPreemption":
                return p
        return None

    def sync_preemption(self):
        self.preemption().async_preparation = False

    def create(self, objs, kind="pods"):
        for o in objs:
            self.store.create(kind, o)

    def drive(self):
        self.sched.run_until_idle()

    def retry(self, rounds=3, step=11.0):
        """Advance the fake clock past every backoff and the unschedulable
        flush window, then drive (what the background loop would do)."""
        for _ in range(rounds):
            self.drive()
            w = self.preemption()
            if w is not None:
                w.wait_for_preparation()
            self.sched.pump_events()
            self.clock.step(step)
            self.sched.queue.flush_backoff_completed()
            self.drive()


def end_state(env):
    """What both packages must agree on: the placement map, the pods left with
    a PodScheduled=False condition and its message, the nominations, the
    events (reason, object, message), the queue tiers and the counters."""
    pods = env.store.list("pods")[0]
    placement = {p.metadata.name: p.spec.node_name for p in pods}
    failed = {p.metadata.name: c.message for p in pods if not p.spec.node_name
              for c in p.status.conditions if c.type == "PodScheduled" and c.status == "False"}
    nominated = {p.metadata.name: p.status.nominated_node_name for p in pods
                 if p.status.nominated_node_name}
    events = sorted((e.reason, e.involved_name, e.message) for e in env.store.list("events")[0])
    s = env.sched
    return {"placement": placement, "failed": failed, "nominated": nominated, "events": events,
            "queue": tuple(s.queue.lengths()),
            "counts": (s.scheduled_count, s.failed_count, s.preemption_count),
            "unsched_plugins": sorted((qp.pod.metadata.name, tuple(qp.unschedulable_plugins))
                                      for qp in s.queue._unschedulable.values())}


def run_both(scenario):
    out = []
    for port in (False, True):
        env = Env(port)
        extra = scenario(env)
        out.append((end_state(env), extra, env))
    return out


def assert_same(scenario):
    (want, want_x, jenv), (got, got_x, tenv) = run_both(scenario)
    for k in want:
        assert got[k] == want[k], (k, want[k], got[k])
    assert got_x == want_x
    return got, tenv


# -- the end-to-end scenarios of tests/test_scheduler.py -----------------------


def sc_pending_spread(env):
    env.create([env.m.MakeNode(f"n{i}").capacity({"cpu": "4", "memory": "8Gi"}).obj()
                for i in range(4)], "nodes")
    env.create([env.m.MakePod(f"p{i}").req({"cpu": "1", "memory": "1Gi"}).obj() for i in range(8)])
    env.serial()
    return env.sched.run_until_idle()


def sc_unschedulable_then_node_add(env):
    env.create([env.m.MakeNode("n0").capacity({"cpu": "1"}).obj()], "nodes")
    env.create([env.m.MakePod("big").req({"cpu": "4"}).obj(),
                env.m.MakePod("p").req({"cpu": "1"}).obj()])
    env.serial()
    env.drive()
    env.create([env.m.MakeNode("n1").capacity({"cpu": "8"}).obj()], "nodes")
    env.retry(1)


def sc_gates_and_priority(env):
    env.create([env.m.MakeNode("n0").capacity({"cpu": "1", "pods": "10"}).obj()], "nodes")
    env.create([env.m.MakePod("gated").req({"cpu": "1"}).scheduling_gate("wait").obj(),
                env.m.MakePod("low").priority(1).req({"cpu": "1"}).obj(),
                env.m.MakePod("high").priority(100).req({"cpu": "1"}).obj()])
    env.serial()
    env.drive()
    env.create([env.m.MakeNode("n1").capacity({"cpu": "4"}).obj()], "nodes")
    env.retry(1)


def sc_spread_and_anti(env):
    for i in range(4):
        env.create([env.m.MakeNode(f"n{i}").labels({ZONE: "a" if i < 2 else "b"})
                    .capacity({"cpu": "8"}).obj()], "nodes")
    env.create([env.m.MakePod(f"w{i}").labels({"app": "web"}).req({"cpu": "100m"})
                .topology_spread(1, ZONE, "DoNotSchedule", {"app": "web"}).obj() for i in range(6)])
    env.create([env.m.MakePod(f"a{i}").labels({"app": "db"}).req({"cpu": "100m"})
                .pod_anti_affinity(HOST, {"app": "db"}).obj() for i in range(5)])
    env.serial()
    env.drive()


def sc_terminal_and_label_update(env):
    env.create([env.m.MakePod("doomed").req({"cpu": "1"}).obj()])
    env.serial()

    def fail_it(st):
        st.phase = "Failed"

    env.store.update_pod_status("default", "doomed", fail_it)
    env.create([env.m.MakeNode("n0").capacity({"cpu": "4"}).obj()], "nodes")
    env.create([env.m.MakePod("p").labels({"app": "old"}).req({"cpu": "1"}).obj()])
    env.drive()
    pod = env.store.get("pods", "default/p")
    pod.metadata.labels["app"] = "new"
    env.store.update("pods", pod)
    env.sched.pump_events()
    snap = env.sched.cache.update_snapshot()
    return [pi.pod.metadata.labels["app"] for pi in snap.get("n0").pods]


SCENARIOS = [sc_pending_spread, sc_unschedulable_then_node_add, sc_gates_and_priority,
             sc_spread_and_anti, sc_terminal_and_label_update]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_serial_scenarios_match_jax(scenario):
    assert_same(scenario)


def workload_scenario(workload, batch=False):
    def sc(env):
        nodes, pods, bound = unpack(workload(env.m))
        env.create(nodes, "nodes")
        env.create(bound)
        if batch:
            env.batch()
        else:
            env.serial()
        env.sync_preemption()
        env.create(pods)
        env.drive()
    return sc


WORKLOADS = PARITY_WORKLOADS + MIXED_WORKLOADS + [np_cluster(s, n_nodes=12, n_pods=30)
                                                  for s in range(4)]


@pytest.mark.parametrize("workload", WORKLOADS, ids=lambda w: w.__name__)
def test_serial_workloads_match_jax(workload):
    """The per-pod cycle over the parity workloads: maps, conditions,
    preemptions and events equal to the JAX serial scheduler's."""
    assert_same(workload_scenario(workload))


def test_num_feasible_nodes_to_find_matches_jax():
    for n in (0, 1, 50, 99, 100, 101, 250, 1000, 5000, 6000, 20000):
        for pct in (0, 1, 5, 30, 50, 99, 100):
            assert t_nfn(n, pct) == j_nfn(n, pct), (n, pct)
    assert (t_nfn(1000), t_nfn(5000), t_nfn(6000)) == (420, 500, 300)


def sc_adaptive_cut(env):
    """250 nodes with the adaptive percentage: the cycle walks the cache's
    node order from its start and stops at 120 feasible nodes, so the
    scores see only those (the cut changes the map above 100 nodes)."""
    env.create([env.m.MakeNode(f"n{i:03d}").capacity({"cpu": str(2 + i % 7), "memory": "8Gi"})
                .obj() for i in range(250)], "nodes")
    env.create([env.m.MakePod(f"p{i}").req({"cpu": "1"}).obj() for i in range(40)])
    env.serial(percentage_of_nodes_to_score=0)
    env.drive()
    return sorted({p.spec.node_name for p in env.store.list("pods")[0]})


def test_adaptive_node_cut_matches_jax():
    got, _ = assert_same(sc_adaptive_cut)
    # every pod lands within the first num_feasible_nodes_to_find(250) = 120
    # nodes of the cache's order
    assert t_nfn(250) == 120
    assert all(int(n[1:]) < 120 for n in got["placement"].values())


def sc_nominated_fast_path(env):
    env.create([env.m.MakeNode(f"n{i}").capacity({"cpu": "4"}).obj() for i in range(3)], "nodes")
    pod = env.m.MakePod("nom").req({"cpu": "1"}).obj()
    pod.status.nominated_node_name = "n2"  # the least attractive after n0/n1 ties
    env.create([env.m.MakePod("f0").req({"cpu": "1"}).obj(), pod])
    env.serial()
    env.drive()
    res = env.sched.schedule_pod(env.m.MakePod("probe").req({"cpu": "1"}).obj())
    return res.suggested_host, res.evaluated_nodes


def test_nominated_node_fast_path_matches_jax():
    got, _ = assert_same(sc_nominated_fast_path)
    assert got["placement"]["nom"] == "n2"


class _ReverseSort:
    """A QueueSort plugin: lowest priority first."""

    name = "ReverseSort"

    def less(self, a, b):
        return a.pod.spec.priority < b.pod.spec.priority


def sc_custom_queue_sort(env):
    env.create([env.m.MakeNode("n0").capacity({"cpu": "1", "pods": "10"}).obj()], "nodes")
    env.create([env.m.MakePod(f"p{i}").priority(i * 10).req({"cpu": "1"}).obj() for i in range(4)])
    plugins = (tdefault if env.port else jdefault)()
    plugins = [_ReverseSort()] + [p for p in plugins if p.name != "PrioritySort"]
    env.sched = (TScheduler if env.port else JScheduler)(
        env.store, env.framework(plugins), clock=env.clock)
    env.sched.sync()
    env.drive()


def test_custom_queue_sort_matches_jax():
    got, _ = assert_same(sc_custom_queue_sort)
    assert got["placement"]["p0"] == "n0"


def sc_profiles(env):
    env.create([env.m.MakeNode("n1").capacity({"cpu": "4", "memory": "8Gi", "pods": "10"}).obj(),
                env.m.MakeNode("n2").capacity({"cpu": "8", "memory": "8Gi", "pods": "10"}).obj()],
               "nodes")
    quiet = env.framework([p for p in (tdefault if env.port else jdefault)()
                           if p.name not in ("NodeResourcesFit",)])
    env.serial(profiles={"default-scheduler": env.framework(), "quiet": quiet})
    a = env.m.MakePod("a").req({"cpu": "3"}).obj()
    b = env.m.MakePod("b").req({"cpu": "7"}).obj()
    b.spec.scheduler_name = "quiet"
    c = env.m.MakePod("c").req({"cpu": "1"}).obj()
    c.spec.scheduler_name = "not-ours"
    env.create([a, b, c])
    env.drive()


def test_profiles_route_by_scheduler_name_like_jax():
    got, _ = assert_same(sc_profiles)
    assert got["placement"]["c"] == ""


def test_framework_and_profiles_arguments():
    store = TStore()
    with pytest.raises(ValueError, match="need framework or profiles"):
        TScheduler(store)
    fw = TFramework(tdefault())
    with pytest.raises(ValueError, match="not both"):
        TScheduler(store, fw, profiles={"x": fw})
    with pytest.raises(TypeError, match="Framework"):
        TScheduler(store, profiles={"x": object()})
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        TScheduler(store, fw, extenders=[object()])
    sched = TBatch(store, device="cpu")
    assert [p.name for p in sched.framework.plugins] == [p.name for p in tdefault()]
    assert sched.preemption is sched._preemption_plugin(sched.framework)


@pytest.mark.parametrize("workload", [PARITY_WORKLOADS[4], PARITY_WORKLOADS[11],
                                      MIXED_WORKLOADS[0], np_cluster(9, n_nodes=12, n_pods=30)],
                         ids=lambda w: w.__name__)
def test_batch_scheduler_with_explicit_framework_matches_jax(workload):
    """BatchScheduler given a port Framework places as the JAX
    BatchScheduler given the JAX default profile."""
    assert_same(workload_scenario(workload, batch=True))
