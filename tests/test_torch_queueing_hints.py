"""QueueingHints in the port (scheduler/serial.py _hint_map / _move_for_event,
scheduler/queue.py move_pods_for_event, each plugin's events_to_register)
against the JAX package, tolerance 0.

Pods rejected by different plugins wait unschedulable; a sequence of cluster
events (node adds and updates, pending and bound pod adds, a bound-pod
delete) follows, and after each event the set of pods still unschedulable,
the queue tiers and each pod's rejecting plugins must equal the JAX
package's, for the serial and the batch scheduler. The scenarios of
tests/test_queueing_hints.py run in both packages too, and the
SchedulerQueueingHints gate off restores the move-everything behaviour in
both.
"""

import pytest
from test_torch_serial import Env

from kubernetes_tpu.utils.featuregate import feature_gates as jgates
from kubernetes_tpu_torch.utils.featuregate import feature_gates as tgates

ZONE = "topology.kubernetes.io/zone"


def snapshot(env):
    q = env.sched.queue
    return (tuple(q.lengths()),
            sorted((qp.pod.metadata.name, tuple(qp.unschedulable_plugins))
                   for qp in q._unschedulable.values()))


def sc_matrix(env, kind):
    """Pods that fail on Fit, node affinity, inter-pod affinity and
    anti-affinity, host ports and a hostname selector; then one event at a
    time."""
    m = env.m
    env.store.create("nodes", m.MakeNode("n0").labels({ZONE: "a", "disk": "hdd"})
                     .capacity({"cpu": "2", "pods": "10"}).obj())
    env.store.create("nodes", m.MakeNode("tainted").labels({ZONE: "a"})
                     .taints([{"key": "gpu", "value": "1", "effect": "NoSchedule"}])
                     .capacity({"cpu": "2", "pods": "10"}).obj())
    holder = m.MakePod("holder").labels({"app": "web"}).req({"cpu": "100m"}, host_port=80).obj()
    holder.spec.node_name = "n0"
    env.store.create("pods", holder)
    if kind == "serial":
        env.serial()
    else:
        env.batch(kind)
    env.sync_preemption()
    pods = [m.MakePod("fit").req({"cpu": "8"}).obj(),
            m.MakePod("ssd").node_selector({"disk": "ssd"}).req({"cpu": "100m"}).obj(),
            m.MakePod("anti").labels({"app": "x"}).pod_anti_affinity(ZONE, {"app": "web"})
            .req({"cpu": "100m"}).obj(),
            m.MakePod("aff").pod_affinity(ZONE, {"app": "db"}).req({"cpu": "100m"}).obj(),
            m.MakePod("port").req({"cpu": "100m"}, host_port=80).toleration("gpu", "1")
            .node_selector({"disk": "hdd"}).obj(),
            m.MakePod("named").req({"cpu": "100m"}).obj()]
    pods[-1].spec.node_name = ""
    pods[-1].spec.node_selector = {"kubernetes.io/hostname": "later"}
    env.create(pods)
    env.drive()
    steps = [("start", snapshot(env))]

    def step(name, fn):
        fn()
        env.sched.pump_events()
        steps.append((name, snapshot(env)))

    step("pod add, unrelated", lambda: env.store.create(
        "pods", m.MakePod("tiny").req({"cpu": "100m"}).obj()))
    env.drive()
    step("small node add", lambda: env.store.create(
        "nodes", m.MakeNode("small").labels({ZONE: "a"}).capacity({"cpu": "1"}).obj()))
    step("ssd node add", lambda: env.store.create(
        "nodes", m.MakeNode("ssd0").labels({ZONE: "b", "disk": "ssd"})
        .capacity({"cpu": "1", "pods": "10"}).obj()))
    db = m.MakePod("db").labels({"app": "db"}).req({"cpu": "100m"}).obj()
    db.spec.node_name = "small"
    step("bound matching pod add", lambda: env.store.create("pods", db))

    def relabel():
        node = env.store.get("nodes", "small")
        node.metadata.labels = dict(node.metadata.labels, disk="hdd")
        env.store.update("nodes", node)

    step("node update", relabel)
    step("port holder delete", lambda: env.store.delete("pods", "default/holder"))
    step("big node add", lambda: env.store.create(
        "nodes", m.MakeNode("later").labels({ZONE: "c"}).capacity({"cpu": "16"}).obj()))
    env.clock.step(11.0)
    env.sched.queue.flush_backoff_completed()
    env.drive()
    steps.append(("after retry", snapshot(env)))
    return steps


@pytest.mark.parametrize("kind", ["serial", "exact", "auto"])
def test_which_pods_move_on_which_event_matches_jax(kind):
    want = sc_matrix(Env(False), kind)
    got = sc_matrix(Env(True), kind)
    for (name, w), (_, g) in zip(want, got):
        assert g == w, name
    # the unrelated pod add moved nothing (the Fit rejection has no pod-add
    # hint): the same pods wait unschedulable, the new pod is active
    assert got[1][1][1] == got[0][1][1] and got[1][1][0][0] == 1


def sc_gate_off(env, kind):
    m = env.m
    env.store.create("nodes", m.MakeNode("small").capacity(
        {"cpu": "1", "memory": "1Gi", "pods": "10"}).obj())
    if kind == "serial":
        env.serial()
    else:
        env.batch(kind)
    env.create([m.MakePod("big").req({"cpu": "4"}).obj()])
    env.drive()
    out = [snapshot(env)]
    gates = tgates if env.port else jgates
    gates.set("SchedulerQueueingHints", False)
    try:
        env.store.create("nodes", m.MakeNode("small2").capacity(
            {"cpu": "1", "memory": "1Gi", "pods": "10"}).obj())
        env.sched.pump_events()
        out.append(snapshot(env))
    finally:
        gates.set("SchedulerQueueingHints", True)
    env.store.create("nodes", m.MakeNode("small3").capacity(
        {"cpu": "1", "memory": "1Gi", "pods": "10"}).obj())
    env.sched.pump_events()
    out.append(snapshot(env))
    return out


@pytest.mark.parametrize("kind", ["serial", "auto"])
def test_gate_off_restores_move_all_like_jax(kind):
    want = sc_gate_off(Env(False), kind)
    got = sc_gate_off(Env(True), kind)
    assert got == want
    # parked, then moved by the gate-off event although no hint queues it
    assert got[0][0][2] == 1 and got[1][0][2] == 0


def sc_reference_cases(env, kind):
    """tests/test_queueing_hints.py: an irrelevant pod event does not
    requeue, a too-small node is skipped by Fit's hint, a big node and an
    assigned-pod delete requeue, and a batch reject carries Fit."""
    m = env.m
    env.store.create("nodes", m.MakeNode("small").capacity(
        {"cpu": "1", "memory": "1Gi", "pods": "10"}).obj())
    blocker = m.MakePod("blocker").req({"cpu": "1"}).obj()
    blocker.spec.node_name = "small"
    env.store.create("pods", blocker)
    if kind == "serial":
        env.serial(pod_initial_backoff=0.01)
    else:
        env.batch(kind, pod_initial_backoff=0.01)
    env.create([m.MakePod("big").req({"cpu": "4"}).obj(),
                m.MakePod("waiter").req({"cpu": "1"}).obj()])
    env.drive()
    out = [snapshot(env)]
    for ev in ("tiny", "small2", "blocker-delete", "huge"):
        if ev == "tiny":
            env.store.create("pods", m.MakePod("tiny").req({"cpu": "100m"}).obj())
        elif ev == "small2":
            env.store.create("nodes", m.MakeNode("small2").capacity(
                {"cpu": "1", "memory": "1Gi", "pods": "10"}).obj())
        elif ev == "blocker-delete":
            env.store.delete("pods", "default/blocker")
        else:
            env.store.create("nodes", m.MakeNode("huge").capacity(
                {"cpu": "8", "memory": "16Gi", "pods": "10"}).obj())
        env.sched.pump_events()
        env.clock.step(0.05)
        env.sched.queue.flush_backoff_completed()
        env.drive()
        out.append(snapshot(env))
    out.append(sorted((p.metadata.name, p.spec.node_name) for p in env.store.list("pods")[0]))
    out.append(env.sched.failed_count)
    return out


@pytest.mark.parametrize("kind", ["serial", "exact", "auto"])
def test_reference_hint_cases_match_jax(kind):
    want = sc_reference_cases(Env(False), kind)
    got = sc_reference_cases(Env(True), kind)
    assert got == want
    placed = dict(got[-2])
    assert placed["big"] == "huge" and placed["waiter"]


def test_hint_map_matches_jax():
    """The (resource, action) -> plugins map and the registered set."""
    jenv, tenv = Env(False), Env(True)
    for env in (jenv, tenv):
        env.serial()
    jmap, jreg = jenv.sched._hint_map(jenv.sched.framework)
    tmap, treg = tenv.sched._hint_map(tenv.sched.framework)
    assert treg == jreg and "VolumeBinding" in treg
    assert {k: sorted((p, len(h)) for p, h in v.items()) for k, v in tmap.items()} == \
        {k: sorted((p, len(h)) for p, h in v.items()) for k, v in jmap.items()}
