"""Per-pod preemption in the port (plugins/default_preemption.py post_filter,
scheduler/serial.py _maybe_preempt, scheduler/batch.py
_handle_device_rejects and _batch_preempt) against the JAX package,
tolerance 0.

The scenarios of tests/test_preemption.py run in both packages, through the
serial scheduler and through the batch scheduler in every solver mode that
routes device rejects (exact, fast, auto), under fake clocks: the placement
map, the victims (deleted pods), the nominations, the Preempted and
FailedScheduling events, the queue tiers and the counters must be equal,
with synchronous and with asynchronous victim preparation. The whole-slice
case is scheduler_perf's PreemptionBasic at 64 nodes (the chip smoke's
main_path_preempt shape): every high pod bound, and the port's map, victims
and events equal to the JAX package's.
"""

import pytest
from test_torch_serial import Env, end_state

from kubernetes_tpu.api.labels import Selector as JSelector
from kubernetes_tpu.api.policy import PodDisruptionBudget as JPDB
from kubernetes_tpu.api.types import ObjectMeta as JMeta
from kubernetes_tpu_torch.api.labels import Selector as TSelector
from kubernetes_tpu_torch.api.policy import PodDisruptionBudget as TPDB
from kubernetes_tpu_torch.api.types import ObjectMeta as TMeta
from kubernetes_tpu_torch.scheduler.framework import Code, CycleState
from kubernetes_tpu_torch.scheduler.plugins.default_preemption import Candidate, DefaultPreemption

ZONE = "topology.kubernetes.io/zone"


def pdb(env, name, labels, allowed, **kw):
    cls, meta, sel = (TPDB, TMeta, TSelector) if env.port else (JPDB, JMeta, JSelector)
    env.store.create("poddisruptionbudgets", cls(
        metadata=meta(name=name, namespace="default"),
        selector=sel.from_match_labels(labels), disruptions_allowed=allowed, **kw))


def bound(env, name, node, prio, cpu, labels=None):
    b = env.m.MakePod(name).priority(prio).req({"cpu": cpu})
    if labels:
        b = b.labels(labels)
    p = b.obj()
    p.spec.node_name = node
    env.store.create("pods", p)


def nodes(env, n, cpu="2", prefix="n", zones=0):
    for i in range(n):
        b = env.m.MakeNode(f"{prefix}{i}").capacity({"cpu": cpu, "pods": "10"})
        if zones:
            b = b.labels({ZONE: f"z{i % zones}"})
        env.store.create("nodes", b.obj())


# -- the scenarios of tests/test_preemption.py ----------------------------------


def sc_basic(env):
    nodes(env, 1)
    env.create([env.m.MakePod("low").priority(1).req({"cpu": "2"}).obj()])
    env.make()
    env.drive()
    env.create([env.m.MakePod("high").priority(100).req({"cpu": "2"}).obj()])
    env.retry()


def sc_fewest_victims(env):
    nodes(env, 2)
    for i in range(2):
        bound(env, f"small{i}", "n0", 1, "1")
    bound(env, "bigv", "n1", 1, "2")
    env.make()
    env.create([env.m.MakePod("high").priority(100).req({"cpu": "2"}).obj()])
    env.retry()


def sc_equal_priority(env):
    nodes(env, 1)
    env.create([env.m.MakePod("a").priority(50).req({"cpu": "2"}).obj()])
    env.make()
    env.drive()
    env.create([env.m.MakePod("b").priority(50).req({"cpu": "2"}).obj()])
    env.retry(2)


def sc_policy_never(env):
    nodes(env, 1)
    env.create([env.m.MakePod("low").priority(1).req({"cpu": "2"}).obj()])
    env.make()
    env.drive()
    humble = env.m.MakePod("humble").priority(100).req({"cpu": "2"}).obj()
    humble.spec.preemption_policy = "Never"
    env.create([humble])
    env.retry(2)


def sc_reprieve(env):
    env.store.create("nodes", env.m.MakeNode("n0").capacity({"cpu": "3", "pods": "10"}).obj())
    for name, prio in (("v1", 1), ("v2", 2), ("v3", 3)):
        bound(env, name, "n0", prio, "1")
    env.make()
    env.create([env.m.MakePod("high").priority(100).req({"cpu": "2"}).obj()])
    env.retry()


def sc_pdb_avoided(env):
    nodes(env, 2)
    bound(env, "protected", "n0", 1, "2", {"app": "critical"})
    bound(env, "plain", "n1", 1, "2")
    pdb(env, "crit-pdb", {"app": "critical"}, 0, min_available=1)
    env.make()
    env.create([env.m.MakePod("high").priority(100).req({"cpu": "2"}).obj()])
    env.retry()


def sc_pdb_spendable(env):
    nodes(env, 1)
    bound(env, "victim", "n0", 1, "2", {"app": "web"})
    pdb(env, "web-pdb", {"app": "web"}, 1, max_unavailable=1)
    env.make()
    env.create([env.m.MakePod("high").priority(100).req({"cpu": "2"}).obj()])
    env.retry()


def sc_pdb_violation_counted(env):
    """Every candidate violates a budget: the node with the fewest
    violations wins, and reprieve failures among the violating victims
    count (filterPodsWithPDBViolation)."""
    nodes(env, 3, cpu="4")
    for i in range(4):
        bound(env, f"a{i}", "n0", 1, "1", {"app": "guarded"})
    for i in range(2):
        bound(env, f"b{i}", "n1", 1, "2", {"app": "guarded"})
    bound(env, "c0", "n2", 2, "3", {"app": "other"})
    bound(env, "c1", "n2", 1, "1", {"app": "guarded"})
    pdb(env, "g", {"app": "guarded"}, 1)
    env.make()
    env.create([env.m.MakePod("high").priority(100).req({"cpu": "3"}).obj()])
    env.retry()


def sc_many_preemptors(env):
    """Several preemptors in one batch: later pods see the capacity the
    earlier ones freed and their nominations (the tier tensors update in
    place), and mixed priorities pick different tiers."""
    nodes(env, 6, cpu="4")
    for i in range(6):
        bound(env, f"low{i}", f"n{i}", 1 + i % 3, "3")
    bound(env, "mid", "n0", 50, "1")
    env.make()
    env.create([env.m.MakePod(f"hi{i}").priority(100 - 30 * (i % 3)).req({"cpu": "2"}).obj()
                for i in range(9)])
    env.retry(4)


SCENARIOS = [sc_basic, sc_fewest_victims, sc_equal_priority, sc_policy_never, sc_reprieve,
             sc_pdb_avoided, sc_pdb_spendable, sc_pdb_violation_counted, sc_many_preemptors]


class PEnv(Env):
    """Env with a fixed scheduler kind: "serial" or a batch solver mode."""

    kind = "serial"
    async_prep = False

    def make(self):
        if self.kind == "serial":
            self.serial()
        else:
            self.batch(self.kind)
        self.preemption().async_preparation = self.async_prep


def run_both(scenario, kind, async_prep=False):
    out = []
    for port in (False, True):
        env = PEnv(port)
        env.kind, env.async_prep = kind, async_prep
        scenario(env)
        st = end_state(env)
        st["victims_total"] = getattr(env.sched, "preempt_victims_total", None)
        out.append((st, env))
    return out


def assert_same(scenario, kind, async_prep=False):
    (want, jenv), (got, tenv) = run_both(scenario, kind, async_prep)
    for k in want:
        assert got[k] == want[k], (k, want[k], got[k])
    return got, tenv


@pytest.mark.parametrize("kind", ["serial", "exact", "fast", "auto"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_preemption_scenarios_match_jax(scenario, kind):
    assert_same(scenario, kind)


@pytest.mark.parametrize("scenario,kind", [
    (sc_basic, "serial"), (sc_reprieve, "serial"), (sc_basic, "auto"), (sc_reprieve, "auto"),
    (sc_many_preemptors, "auto"), (sc_many_preemptors, "exact")],
    ids=lambda x: getattr(x, "__name__", x))
def test_async_preparation_matches_jax(scenario, kind):
    """SchedulerAsyncPreemption: the victims go on the preparation worker;
    after wait_for_preparation the outcome equals the JAX package's. (With
    several preemptors on the serial path, whether the next cycle sees the
    previous one's victims gone is a race in both packages, so the serial
    cases have one preemptor; a batch decides all of its preemptors in one
    pass.)"""
    got, _ = assert_same(scenario, kind, async_prep=True)
    assert got["counts"][2] >= 1


def test_outcomes_of_the_scenarios():
    """What tests/test_preemption.py asserts, on the port's side."""
    got, _ = assert_same(sc_basic, "auto")
    assert "low" not in got["placement"] and got["placement"]["high"] == "n0"
    assert ("Preempted", "low", "Preempted by pod high on node n0") in got["events"]
    got, _ = assert_same(sc_fewest_victims, "serial")
    assert got["placement"]["high"] == "n1" and "bigv" not in got["placement"]
    got, _ = assert_same(sc_equal_priority, "exact")
    assert got["placement"] == {"a": "n0", "b": ""} and got["counts"][2] == 0
    got, _ = assert_same(sc_policy_never, "fast")
    assert got["placement"] == {"low": "n0", "humble": ""}
    got, _ = assert_same(sc_reprieve, "exact")
    assert set(got["placement"]) == {"v3", "high"}
    got, _ = assert_same(sc_pdb_avoided, "auto")
    assert got["placement"]["high"] == "n1" and "protected" in got["placement"]
    got, _ = assert_same(sc_pdb_spendable, "serial")
    assert got["placement"] == {"high": "n0"}


def sc_constrained(env):
    """Device rejects of a constrained batch (a zone spread): the per-node
    failure map and the serial PostFilter."""
    nodes(env, 8, cpu="4", zones=4)
    for i in range(8):
        bound(env, f"low{i}", f"n{i}", 1, "3")
    env.make()
    env.create([env.m.MakePod(f"hi{i}").labels({"app": "s"}).priority(100).req({"cpu": "2"})
                .topology_spread(1, ZONE, "DoNotSchedule", {"app": "s"}).obj()
                for i in range(6)])
    env.retry(4)


@pytest.mark.parametrize("kind", ["exact", "fast", "serial"])
def test_constrained_preemption_matches_jax(kind):
    got, _ = assert_same(sc_constrained, kind)
    assert sum(1 for k, v in got["placement"].items() if k.startswith("hi") and v) == 6


def preemption_basic(env, n):
    """scheduler_perf PreemptionBasic (bench.py PreemptionBasic rung): n nodes
    of 4 cpu / 32Gi / 110 pods, n bound priority-1 pods of 3 cpu (one a
    node), then n pending priority-100 pods of 2 cpu."""
    for i in range(n):
        env.store.create("nodes", env.m.MakeNode(f"node-{i}").capacity(
            {"cpu": "4", "memory": "32Gi", "pods": "110"}).obj())
    for i in range(n):
        bound(env, f"low-{i}", f"node-{i}", 1, "3")
    env.make()
    env.store.create_many("pods", [env.m.MakePod(f"high-{i}").priority(100).req({"cpu": "2"})
                                   .obj() for i in range(n)])
    env.retry(4)


@pytest.mark.parametrize("kind", ["exact", "auto"])
def test_preemption_basic_64_matches_jax(kind):
    got, tenv = assert_same(lambda env: preemption_basic(env, 64), kind)
    high = {k: v for k, v in got["placement"].items() if k.startswith("high-")}
    assert len(high) == 64 and all(high.values())
    assert not any(k.startswith("low-") for k in got["placement"])
    assert got["victims_total"] == 64 and got["counts"][2] == 64
    assert sum(1 for e in got["events"] if e[0] == "Preempted") == 64
    # no node over-committed: one high pod a node
    assert len(set(high.values())) == 64


def test_failed_rejects_carry_fit_attribution():
    """A device reject with no victim anywhere fails attributed to
    NodeResourcesFit (the QueueingHints read it)."""
    env = PEnv(True)
    env.kind = "auto"
    nodes(env, 1)
    env.make()
    env.create([env.m.MakePod("a").req({"cpu": "2"}).obj(),
                env.m.MakePod("b").req({"cpu": "2"}).obj()])
    env.drive()
    (qp,) = env.sched.queue.unschedulable_pods()
    assert qp.unschedulable_plugins == ("NodeResourcesFit",)
    assert env.sched.preemption_count == 0


def test_select_candidate_order():
    """pick_one_node_for_preemption: fewest violations, then the lowest
    highest-victim priority, the smallest priority sum, the fewest victims,
    the node name."""
    def victim(prio):
        from kubernetes_tpu_torch.testing import MakePod

        return MakePod(f"v{prio}").priority(prio).obj()

    cands = [Candidate("b", [victim(5)], 0), Candidate("a", [victim(5)], 0),
             Candidate("c", [victim(3), victim(1)], 0), Candidate("d", [victim(1)], 1)]
    assert DefaultPreemption()._select_candidate(cands).node_name == "c"
    assert DefaultPreemption()._select_candidate(cands[:2]).node_name == "a"


def test_post_filter_policy_never_and_no_snapshot():
    from kubernetes_tpu_torch.testing import MakePod

    dp = DefaultPreemption()
    pod = MakePod("p").obj()
    pod.spec.preemption_policy = "Never"
    _, st = dp.post_filter(CycleState(), pod, {})
    assert st.code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE
    _, st = dp.post_filter(CycleState(), MakePod("q").obj(), {})
    assert st.code == Code.ERROR
