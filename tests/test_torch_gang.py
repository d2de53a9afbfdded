"""Gang scheduling in the port (api/podgroup.py, scheduler/gang.py, the gang
tiers of scheduler/queue.py, the tensorizer's gang rows and the batch
scheduler's all-or-nothing flow) against the JAX package.

Unit parity: GangDirectory, gang_veto_mask, node_slice_ids /
node_slice_positions and gang_slice_bonus on the same seeded inputs, exact
equality. Queue: staging until quorum, reconsider, park/release and the
shared gang backoff. Scheduler parity: the scenarios of tests/test_gang.py
run in both packages over identical stores (both schedulers driven to
idle); the bound {pod: node} map, the pods left failed, the queue tiers and
the events by reason are equal. The port's queue moves every unschedulable
pod on any event (no QueueingHints yet), so end states are compared, not
per-cycle states.
"""

import collections
import random

import numpy as np
import pytest

import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.scheduler import Framework
from kubernetes_tpu.scheduler import gang as jgang
from kubernetes_tpu.scheduler.batch import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.plugins import default_plugins
from kubernetes_tpu.scheduler.queue import SchedulingQueue as JQueue
from kubernetes_tpu.snapshot import tensorizer as jtz
from kubernetes_tpu.store import APIStore as JStore
from kubernetes_tpu.utils import FakeClock as JFakeClock
from kubernetes_tpu_torch.api.podgroup import POD_GROUP_LABEL, PodGroup, pod_group_key
from kubernetes_tpu_torch.scheduler import gang as tgang
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.queue import QueuedPodInfo, SchedulingQueue
from kubernetes_tpu_torch.snapshot import tensorizer as ttz
from kubernetes_tpu_torch.store import APIStore as TStore
from kubernetes_tpu_torch.utils import FakeClock


# -- the two-package scenario harness (shared with test_torch_gangpreempt.py) --


class Env:
    """One package's store, optional fake clock and batch scheduler, with the
    calls whose signatures differ between the packages wrapped."""

    def __init__(self, port: bool, solver: str = "fast", clock: bool = False):
        self.port = port
        self.m = tt if port else jt
        self.solver = solver
        self.store = TStore() if port else JStore()
        self.clock = (FakeClock() if port else JFakeClock()) if clock else None
        self.sched = None

    def make_sched(self, batch_size=1024, **kw):
        if self.port:
            self.sched = TBatch(self.store, device="cpu", batch_size=batch_size,
                                solver=self.solver, clock=self.clock, **kw)
        else:
            self.sched = JBatch(self.store, Framework(default_plugins()), batch_size=batch_size,
                                solver=self.solver, pipeline_binds=False, clock=self.clock, **kw)
        self.sched.sync()
        return self.sched

    def sync_preemption(self):
        """Synchronous victim preparation (deterministic deletes)."""
        if self.port:
            self.sched.preemption.async_preparation = False
            return
        from kubernetes_tpu.scheduler.plugins.default_preemption import DefaultPreemption

        for fw in self.sched.profiles.values():
            for p in fw.post_filter_plugins:
                if isinstance(p, DefaultPreemption):
                    p.async_preparation = False

    def batch(self):
        return self.sched.schedule_batch() if self.port else self.sched.schedule_batch(timeout=0.0)

    def drive(self):
        self.sched.run_until_idle()
        self.sched.pump_events()

    def pg(self, name, min_member):
        self.store.create("podgroups", self.m.make_pod_group(name, min_member))

    def nodes(self, n, cpu="8", mem="32Gi", slices=0, prefix="node"):
        for i in range(n):
            mk = self.m.MakeNode(f"{prefix}-{i}").capacity({"cpu": cpu, "memory": mem,
                                                            "pods": "110"})
            if slices:
                mk = mk.tpu_slice(i % slices)
            self.store.create("nodes", mk.obj())

    def gang_pods(self, n, group, cpu="2", mem="2Gi", prefix="g"):
        return [self.m.MakePod(f"{prefix}-{i}").gang(group).req({"cpu": cpu, "memory": mem})
                .obj() for i in range(n)]

    def bound(self, prefix=""):
        return sorted(p.metadata.name for p in self.store.list("pods")[0]
                      if p.metadata.name.startswith(prefix) and p.spec.node_name)


def end_state(env):
    """What both packages must agree on after a scenario: the placement map,
    the pods left with a PodScheduled=False condition (and its message), the
    queue tiers, the veto count and the events by (reason, object)."""
    pods = env.store.list("pods")[0]
    placement = {p.metadata.name: p.spec.node_name for p in pods}
    failed = {p.metadata.name: c.message for p in pods if not p.spec.node_name
              for c in p.status.conditions if c.type == "PodScheduled" and c.status == "False"}
    events = sorted({(e.reason, e.involved_name) for e in env.store.list("events")[0]})
    return {"placement": placement, "failed": failed, "events": events,
            "queue": tuple(env.sched.queue.lengths()),
            "staged": env.sched.queue.gang_staged_count(),
            "gang_vetoes": env.sched.gang_vetoes}


def run_both(scenario, solver="fast", clock=False):
    """Run `scenario(env)` for the JAX package and the port; returns both end
    states and the two envs. A scenario may return extra observations,
    which must be equal too."""
    out = []
    for port in (False, True):
        env = Env(port, solver, clock)
        extra = scenario(env)
        out.append((end_state(env), extra, env))
    (want, want_x, jenv), (got, got_x, tenv) = out
    return want, got, want_x, got_x, jenv, tenv


def assert_same_end_state(scenario, solver="fast", clock=False):
    want, got, want_x, got_x, jenv, tenv = run_both(scenario, solver, clock)
    for key in want:
        assert got[key] == want[key], f"{key}: jax={want[key]!r}\nport={got[key]!r}"
    assert got_x == want_x
    return got, tenv


# -- API surface ---------------------------------------------------------------


def test_podgroup_is_stored_watched_and_parsed():
    store = TStore()
    w = store.watch(kind=("podgroups",))
    store.create("podgroups", tt.make_pod_group("train", 16))
    got = store.get("podgroups", "default/train")
    assert got.spec.min_member == 16 and got.key == "default/train"
    (ev,) = w.drain()
    assert ev.kind == "podgroups" and ev.obj.spec.min_member == 16
    parsed = PodGroup.from_dict({"metadata": {"name": "x", "namespace": "ml"},
                                 "spec": {"minMember": 3}})
    assert parsed.key == "ml/x" and parsed.spec.min_member == 3
    p = tt.MakePod("r0", namespace="ml").gang("train").obj()
    assert p.metadata.labels[POD_GROUP_LABEL] == "train"
    assert pod_group_key(p) == "ml/train" == jgang.pod_group_key(
        jt.MakePod("r0", namespace="ml").gang("train").obj())
    assert pod_group_key(tt.MakePod("plain").obj()) == ""


def test_store_refuses_other_kinds_and_deletes_pods_in_one_batch():
    store = TStore()
    # any kind is stored, as in the JAX store (the lean store raised here)
    store.create("deployments", tt.make_pod_group("x", 1))
    assert store.get("deployments", "default/x").spec.min_member == 1
    for i in range(3):
        store.create("pods", tt.MakePod(f"v{i}").node("n0").obj())
    w = store.watch(kind="pods", coalesce=True)
    deleted, errors = store.delete_pods(["default/v0", "default/v2", "default/nope",
                                         "default/v0"])
    assert deleted == 2
    assert [k for k, _ in errors] == ["default/nope", "default/v0"]
    (cev,) = w.drain()
    assert cev.type == "DELETED" and [e.obj.metadata.name for e in cev.events] == ["v0", "v2"]
    assert [p.metadata.name for p in store.list("pods")[0]] == ["v1"]


# -- unit parity ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_gang_directory_matches_jax(seed):
    rng = random.Random(seed)
    jd, td = jgang.GangDirectory(), tgang.GangDirectory()
    groups = ["a", "b", "c"]
    for step in range(60):
        op = rng.choice(["pg", "pod", "assume", "forget", "expire"])
        g = rng.choice(groups)
        if op == "pg":
            et = rng.choice(["ADDED", "MODIFIED", "DELETED"])
            n = rng.randint(0, 5)
            jd.observe_podgroup(et, jt.make_pod_group(g, n))
            td.observe_podgroup(et, tt.make_pod_group(g, n))
        else:
            name = f"{g}-{rng.randint(0, 6)}"
            node = rng.choice(["", "n1"])
            jp = jt.MakePod(name).gang(g).obj()
            tp = tt.MakePod(name).gang(g).obj()
            jp.spec.node_name = tp.spec.node_name = node
            if op == "pod":
                et = rng.choice(["ADDED", "MODIFIED", "DELETED"])
                jd.observe_pod(et, jp)
                td.observe_pod(et, tp)
            elif op == "assume":
                jd.note_assumed(jp)
                td.note_assumed(tp)
            elif op == "forget":
                jd.note_forgotten(jp)
                td.note_forgotten(tp)
            else:
                keys = [f"default/{g}-{rng.randint(0, 6)}" for _ in range(2)]
                assert jd.note_expired_keys(keys) == td.note_expired_keys(keys)
        assert jd.active == td.active
        for grp in ("default/a", "default/b", "default/c"):
            assert jd.min_member(grp) == td.min_member(grp)
            assert jd.placed_count(grp) == td.placed_count(grp)
            for staged in (0, 2, 5):
                assert jd.quorum_ready(grp, staged) == td.quorum_ready(grp, staged)
    pods_j = [jt.MakePod(f"p{i}").gang(rng.choice(groups + ["zz"]), rank=rng.choice([None, i]))
              .obj() for i in range(12)] + [jt.MakePod("free").obj()]
    pods_t = [tt.MakePod(p.metadata.name).labels(dict(p.metadata.labels)).obj() for p in pods_j]
    rj, kj, rkj = jd.batch_rows(pods_j)
    rt, kt, rkt = td.batch_rows(pods_t)
    assert kj == kt
    for a, b in ((rj, rt), (rkj, rkt)):
        assert (a is None and b is None) or np.array_equal(a, b)


def test_note_expired_keys_removes_only_named_members():
    gd = tgang.GangDirectory()
    gd.observe_podgroup("ADDED", tt.make_pod_group("a", 3))
    for i in range(3):
        gd.note_assumed(tt.MakePod(f"a-{i}").gang("a").obj())
    assert gd.placed_count("default/a") == 3
    assert gd.note_expired_keys(["default/a-1", "default/zzz"]) == 1
    assert gd.placed_count("default/a") == 2
    assert gd.note_expired_keys(["default/a-0", "default/a-2"]) == 2
    assert gd.placed_count("default/a") == 0
    assert gd.quorum_expired_count(lambda k: False) == 0


@pytest.mark.parametrize("seed", range(6))
def test_gang_veto_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    p, g = int(rng.integers(1, 40)), int(rng.integers(1, 6))
    assignment = rng.integers(-1, 5, size=p)
    rows = rng.integers(-1, g, size=p)
    need = rng.integers(-1, 8, size=g)
    for a, b in zip(tgang.gang_veto_mask(assignment, rows, need),
                    jgang.gang_veto_mask(assignment, rows, need)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_gang_veto_mask_example():
    veto, satisfied = tgang.gang_veto_mask(np.array([0, 1, -1, 2, 3, -1, 5]),
                                           np.array([0, 0, 0, 1, 1, -1, -1]), np.array([3, 2]))
    assert veto.tolist() == [True, True, True, False, False, False, False]
    assert satisfied.tolist() == [False, True]


def _slice_nodes(m, n, slices, index_labels=True, seed=0):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        mk = m.MakeNode(f"n{i}").capacity({"cpu": str(rng.choice([4, 8, 16])),
                                           "memory": "32Gi", "pods": "110"})
        if i % 7 != 6:  # some nodes carry no slice label
            mk = mk.tpu_slice(i % slices, index=(i // slices) if index_labels else None)
        out.append(mk.obj())
    return out


def _tensorized(m, nodes, pods, bound=()):
    if m is tt:
        cache = TCache()
        tz = ttz
    else:
        from kubernetes_tpu.scheduler.cache import Cache as JCache

        cache = JCache()
        tz = jtz
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = cache.update_snapshot()
    return snap, tz.build_cluster_tensors(snap)


@pytest.mark.parametrize("index_labels", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_slice_topology_and_bonus_match_jax(seed, index_labels):
    """node_slice_ids, node_slice_positions, ring_lengths, and the batch's
    gang rows and slice-packing bonus, built by each package's tensorizer."""
    rng = random.Random(seed)
    groups = {"a": rng.randint(2, 9), "b": rng.randint(2, 9), "c": 40}
    outs = []
    for m, gmod in ((jt, jgang), (tt, tgang)):
        nodes = _slice_nodes(m, 30, 3, index_labels, seed)
        bound = [m.MakePod(f"b{i}").req({"cpu": "3"}).node(f"n{i}").obj() for i in range(0, 30, 4)]
        snap, cl = _tensorized(m, nodes, [], bound)
        ids = gmod.node_slice_ids(cl)
        sl, pos = gmod.node_slice_positions(cl)
        d = gmod.GangDirectory()
        for g, n in groups.items():
            d.observe_podgroup("ADDED", m.make_pod_group(g, n))
        prng = random.Random(seed)
        pods = []
        for i in range(36):
            g = prng.choice(list(groups) + [None])
            b = m.MakePod(f"p{i}").req({"cpu": prng.choice(["1", "2"])})
            if g:
                b = b.gang(g, rank=i)
            pods.append(b.obj())
        tz = ttz if m is tt else jtz
        batch = tz.build_pod_batch(pods, snap, cl, gangs=d)
        outs.append((ids, sl, pos, gmod.ring_lengths(sl, pos), batch.gang_of_pod,
                     batch.gang_keys, batch.gang_rank, batch.gang_bonus))
    for a, b in zip(*outs):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b
    assert outs[1][-1] is not None and (outs[1][-1] == tgang.GANG_SLICE_BONUS).any()


def test_no_slice_labels_means_no_topology():
    snap, cl = _tensorized(tt, [tt.MakeNode("c0").capacity({"cpu": "4"}).obj()], [])
    assert tgang.node_slice_ids(cl) is None
    assert tgang.node_slice_positions(cl) == (None, None)


# -- queue ----------------------------------------------------------------------


def _hooked_queue(clock=None):
    gangs = tgang.GangDirectory()
    q = SchedulingQueue(clock=clock or FakeClock())
    q.set_gang_hooks(gangs.group_of, gangs.quorum_ready, lambda: gangs.active)
    return gangs, q


def test_gang_stages_until_quorum_then_admits_contiguously():
    gangs, q = _hooked_queue()
    gangs.observe_podgroup("ADDED", tt.make_pod_group("t", 3))
    members = [tt.MakePod(f"g-{i}").gang("t").req({"cpu": "2"}).obj() for i in range(3)]
    filler = [tt.MakePod(f"f-{i}").obj() for i in range(4)]
    q.add(members[0])
    q.add_batch(filler[:2])
    q.add(members[1])
    q.add_batch(filler[2:])
    assert q.lengths()[0] == 4 and q.gang_staged_count() == 2
    q.add(members[2])
    assert q.gang_staged_count() == 0
    order = [qp.pod.metadata.name for qp in q.pop_batch(100)]
    gi = [order.index(m.metadata.name) for m in members]
    assert max(gi) - min(gi) == 2


def test_gang_queue_order_matches_jax():
    """The same interleaved admissions pop in the same order in both queues."""
    orders = []
    for m, Q, gd, clk in ((jt, JQueue, jgang.GangDirectory, JFakeClock),
                          (tt, SchedulingQueue, tgang.GangDirectory, FakeClock)):
        gangs = gd()
        q = Q(clock=clk())
        q.set_gang_hooks(gangs.group_of, gangs.quorum_ready, lambda g=gangs: g.active)
        gangs.observe_podgroup("ADDED", m.make_pod_group("t", 3))
        gangs.observe_podgroup("ADDED", m.make_pod_group("u", 2))
        seq = []
        for i in range(12):
            b = m.MakePod(f"p{i}").priority(i % 3)
            if i % 4 == 1:
                b = b.gang("t")
            elif i % 4 == 2:
                b = b.gang("u")
            seq.append(b.obj())
        for i, p in enumerate(seq):
            if i % 2:
                q.add(p)
            else:
                q.add_batch([p])
        q.reconsider_gangs()
        popped = q.pop_batch(100) if m is tt else q.pop_batch(100, timeout=0.0)
        orders.append(([qp.pod.metadata.name for qp in popped], q.gang_staged_count(),
                       tuple(q.lengths())))
    assert orders[0] == orders[1]


def test_gang_waits_for_podgroup_object_then_reconsider_admits():
    gangs, q = _hooked_queue()
    q.add_batch([tt.MakePod(f"late-{i}").gang("late").obj() for i in range(2)])
    assert q.lengths()[0] == 2  # no PodGroup anywhere: not gang-gated
    gangs.observe_podgroup("ADDED", tt.make_pod_group("other", 2))
    q.add_batch([tt.MakePod(f"l2-{i}").gang("late").obj() for i in range(2)])
    assert q.gang_staged_count() == 2
    gangs.observe_podgroup("ADDED", tt.make_pod_group("late", 2))
    q.reconsider_gangs()
    assert q.gang_staged_count() == 0 and q.lengths()[0] == 4


def test_gang_delete_and_tracked_keys_cover_staging():
    gangs, q = _hooked_queue()
    gangs.observe_podgroup("ADDED", tt.make_pod_group("t", 5))
    members = [tt.MakePod(f"g-{i}").gang("t").obj() for i in range(3)]
    q.add_batch(members)
    assert set(q.tracked_keys()) == {m.key for m in members}
    q.delete(members[1])
    assert set(q.tracked_keys()) == {members[0].key, members[2].key}
    assert q.lengths() == (0, 0, 2)  # staged counts as unschedulable


def test_parked_tier_lifecycle():
    q = SchedulingQueue(clock=FakeClock())
    members = [QueuedPodInfo(pod=tt.MakePod(f"m-{i}").gang("t").obj(), timestamp=1.0)
               for i in range(3)]
    q.park_gang("default/t", members)
    assert q.gang_parked_count() == 3 and q.lengths() == (0, 0, 3)
    assert set(q.tracked_keys()) == {m.key for m in members}
    q.delete_key("default/m-1")
    assert q.gang_parked_count() == 2
    assert q.release_parked_gang("default/t") == 2
    assert q.gang_parked_count() == 0 and q.lengths() == (2, 0, 0)
    assert q.release_parked_gang("default/t") == 0
    q.park_gang("default/t", members)
    q.clear()
    assert q.gang_parked_count() == 0 and q.tracked_keys() == []


def test_add_gang_backoff_shares_one_expiry():
    clock = FakeClock()
    gangs, q = _hooked_queue(clock)
    gangs.observe_podgroup("ADDED", tt.make_pod_group("t", 3))
    members = [QueuedPodInfo(pod=tt.MakePod(f"g-{i}").gang("t").obj(), attempts=a)
               for i, a in enumerate((1, 3, 2))]
    q.add_gang_backoff(members)
    assert q.lengths() == (0, 3, 0)
    clock.step(2.0)  # past the 1 s member's own backoff, not the slowest (4 s)
    q.flush_backoff_completed()
    assert q.lengths() == (0, 3, 0)
    clock.step(2.1)
    q.flush_backoff_completed()
    # all three re-staged and admitted together
    assert q.lengths() == (3, 0, 0) and q.gang_staged_count() == 0


# -- scheduler parity: the scenarios of tests/test_gang.py --------------------------


def sc_insufficient_capacity(env):
    env.nodes(2, cpu="4", mem="8Gi")
    env.make_sched()
    env.pg("big", 6)
    env.store.create_many("pods", env.gang_pods(6, "big"))
    env.drive()
    assert env.bound("g-") == []
    assert env.sched.gang_vetoes >= 1
    assert not env.sched.cache._assumed
    return env.sched.queue.lengths()


def sc_partial_device_reject(env):
    env.nodes(2, cpu="5", mem="16Gi")
    env.make_sched()
    env.pg("big", 6)
    env.store.create_many("pods", env.gang_pods(6, "big"))
    xs = [env.m.MakePod(f"x-{i}").req({"cpu": "500m"}).obj() for i in range(2)]
    env.store.create_many("pods", xs)
    env.drive()
    assert env.bound("g-") == [] and env.bound("x-") == ["x-0", "x-1"]


def sc_satisfied_extras(env):
    env.nodes(2, cpu="4", mem="8Gi")
    env.make_sched()
    env.pg("big", 4)
    env.store.create_many("pods", env.gang_pods(6, "big"))
    env.drive()
    assert len(env.bound("g-")) == 4 and env.sched.gang_vetoes == 0


def sc_no_partial_preemption(env):
    env.nodes(4, cpu="4", mem="8Gi")
    for i in range(4):
        low = env.m.MakePod(f"low-{i}").priority(1).req({"cpu": "3"}).obj()
        low.spec.node_name = f"node-{i}"
        env.store.create("pods", low)
    env.make_sched()
    env.sync_preemption()
    env.pg("big", 8)
    pods = env.gang_pods(8, "big", cpu="3")
    for p in pods:
        p.spec.priority = 100
    env.store.create_many("pods", pods)
    env.drive()
    assert env.bound("g-") == [] and len(env.store.list("pods")[0]) == 12
    return env.sched.gangpreempt.stats()


def sc_assume_failure_releases(env):
    env.nodes(4, cpu="8", mem="16Gi")
    env.make_sched()
    env.pg("big", 4)
    members = env.gang_pods(4, "big")
    env.store.create_many("pods", members)
    ghost = env.store.get("pods", "default/g-0")
    env.sched.pump_events()
    if env.port:
        env.sched.cache.assume_pods([(ghost, "node-0")])
    else:
        env.sched.cache.assume_pod(ghost, "node-0")
    env.drive()
    assert env.bound("g-") == []
    return sorted(env.sched.cache._assumed)


def sc_requeue_as_unit(env):
    env.nodes(2, cpu="4", mem="8Gi")
    env.make_sched()
    env.pg("big", 6)
    env.store.create_many("pods", env.gang_pods(6, "big"))
    env.drive()
    first = env.sched.queue.lengths()
    env.clock.step(2.0)
    env.sched.queue.flush_backoff_completed()
    second = (env.sched.queue.lengths(), env.sched.queue.gang_staged_count())
    handled = env.batch()
    return first, second, handled


def sc_capacity_arrives(env):
    env.nodes(2, cpu="4", mem="8Gi")
    env.make_sched()
    env.pg("big", 6)
    env.store.create_many("pods", env.gang_pods(6, "big"))
    env.drive()
    assert env.bound("g-") == []
    env.nodes(2, cpu="8", mem="8Gi", prefix="new")
    env.clock.step(3.0)
    env.sched.pump_events()
    env.sched.queue.flush_backoff_completed()
    env.drive()
    assert len(env.bound("g-")) == 6


def sc_one_slice_when_room(env):
    for i in range(4):
        env.store.create("nodes", env.m.MakeNode(f"s0-{i}").tpu_slice(0)
                         .capacity({"cpu": "4", "memory": "8Gi"}).obj())
    for i in range(4):
        env.store.create("nodes", env.m.MakeNode(f"s1-{i}").tpu_slice(1)
                         .capacity({"cpu": "16", "memory": "64Gi"}).obj())
    env.make_sched()
    env.pg("train", 8)
    env.store.create_many("pods", env.gang_pods(8, "train", cpu="2", mem="2Gi"))
    env.drive()
    placed = {p.spec.node_name.split("-")[0] for p in env.store.list("pods")[0]}
    assert placed == {"s0"}


def sc_two_gangs_two_slices(env):
    for s in range(2):
        for i in range(4):
            env.store.create("nodes", env.m.MakeNode(f"s{s}-{i}").tpu_slice(s)
                             .capacity({"cpu": "8", "memory": "16Gi"}).obj())
    env.make_sched()
    env.pg("a", 8)
    env.pg("b", 8)
    env.store.create_many("pods", env.gang_pods(8, "a", prefix="a")
                          + env.gang_pods(8, "b", prefix="b"))
    env.drive()
    for prefix in ("a", "b"):
        got = {p.spec.node_name.split("-")[0] for p in env.store.list("pods")[0]
               if p.metadata.name.startswith(f"{prefix}-")}
        assert len(got) == 1


def sc_no_podgroups(env):
    env.nodes(4)
    env.make_sched()
    env.store.create_many("pods", env.gang_pods(5, "nobody"))
    env.sched.pump_events()
    assert env.sched.queue.gang_staged_count() == 0
    env.drive()
    assert len(env.bound("g-")) == 5


def sc_orphaned_staging(env):
    env.nodes(4)
    env.make_sched()
    env.pg("doomed", 3)
    env.pg("other", 2)
    env.store.create_many("pods", env.gang_pods(2, "doomed"))
    env.sched.pump_events()
    staged = [env.sched.queue.gang_staged_count()]
    env.store.delete("podgroups", "default/doomed")
    env.sched.pump_events()
    staged.append(env.sched.queue.gang_staged_count())
    env.clock.step(31.0)
    env.sched.queue.flush_unschedulable_left_over()
    staged.append(env.sched.queue.gang_staged_count())
    env.drive()
    assert len(env.bound("g-")) == 2
    env.store.create_many("pods", env.gang_pods(1, "other", prefix="o"))
    env.sched.pump_events()
    env.clock.step(31.0)
    env.sched.queue.flush_unschedulable_left_over()
    staged.append(env.sched.queue.gang_staged_count())
    assert staged == [2, 2, 0, 1]
    return staged


def sc_beyond_batch_size(env):
    env.nodes(8)
    env.make_sched(batch_size=4)
    env.pg("wide", 6)
    env.store.create_many("pods", env.gang_pods(6, "wide", cpu="500m", mem="512Mi"))
    env.drive()
    assert env.bound("g-") == []
    active, backoff, unsched = env.sched.queue.lengths()
    assert backoff == 0 and unsched == 6


def sc_bound_members_count(env):
    env.nodes(4, cpu="8", mem="16Gi")
    for i in range(3):
        p = env.m.MakePod(f"g-{i}").gang("train").req({"cpu": "2"}).obj()
        p.spec.node_name = f"node-{i}"
        env.store.create("pods", p)
    env.pg("train", 4)
    env.make_sched()
    placed = env.sched.gangs.placed_count("default/train")
    env.store.create("pods", env.m.MakePod("g-3").gang("train").req({"cpu": "2"}).obj())
    env.drive()
    assert len(env.bound("g-")) == 4
    return placed


def sc_gang_with_spread(env):
    """A constrained gang batch (zone spread on every member) beside a free
    pod: the repair path in fast/auto, the scan in exact, with the bonus."""
    for i in range(6):
        env.store.create("nodes", env.m.MakeNode(f"z-{i}").tpu_slice(i % 2, index=i // 2)
                         .labels({"topology.kubernetes.io/zone": f"zone-{i % 3}"})
                         .capacity({"cpu": "4", "memory": "8Gi"}).obj())
    env.make_sched()
    env.pg("sp", 6)
    pods = [env.m.MakePod(f"g-{i}").gang("sp", rank=i).labels({"app": "sp"})
            .req({"cpu": "1"}).topology_spread(1, "topology.kubernetes.io/zone",
                                               "DoNotSchedule", {"app": "sp"}).obj()
            for i in range(6)]
    free = env.m.MakePod("x-0").req({"cpu": "1"}).obj()
    free.spec.preemption_policy = "Never"
    env.store.create_many("pods", pods + [free])
    env.drive()
    assert len(env.bound("g-")) == 6


SCENARIOS = {
    "insufficient_capacity": (sc_insufficient_capacity, False),
    "partial_device_reject": (sc_partial_device_reject, False),
    "satisfied_extras": (sc_satisfied_extras, False),
    "no_partial_preemption": (sc_no_partial_preemption, False),
    "assume_failure_releases": (sc_assume_failure_releases, False),
    "requeue_as_unit": (sc_requeue_as_unit, True),
    "capacity_arrives": (sc_capacity_arrives, True),
    "one_slice_when_room": (sc_one_slice_when_room, False),
    "two_gangs_two_slices": (sc_two_gangs_two_slices, False),
    "no_podgroups": (sc_no_podgroups, False),
    "orphaned_staging": (sc_orphaned_staging, True),
    "beyond_batch_size": (sc_beyond_batch_size, False),
    "bound_members_count": (sc_bound_members_count, False),
}


@pytest.mark.parametrize("solver", ["exact", "fast"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gang_scenario_matches_jax(name, solver):
    scenario, clock = SCENARIOS[name]
    assert_same_end_state(scenario, solver, clock)


@pytest.mark.parametrize("solver", ["exact", "fast", "auto"])
def test_constrained_gang_matches_jax(solver):
    assert_same_end_state(sc_gang_with_spread, solver)


def test_gang_stats_and_last_gang():
    env = Env(True, "fast")
    sc_insufficient_capacity(env)
    st = env.sched.gang_stats()
    assert st["vetoes"] == env.sched.gang_vetoes >= 1
    assert st["staged"] == 0 and st["parked"] == 0 and st["quorum_expired_assumes"] == 0
    # one cover attempt found no candidate victim at all: a plain capacity wait
    pre = st["preemption"]
    assert (pre["attempts"], pre["preempted"], pre["vetoed_partial"]) == (1, 0, 0)
    assert env.sched.last_gang["vetoed"] == 1
    evs = collections.Counter(e.reason for e in env.store.list("events")[0])
    assert evs["FailedScheduling"] >= 1
    assert TBatch(TStore(), device="cpu").gang_stats() is None


def test_fallback_class_member_vetoes_the_whole_gang():
    """A member needing the serial path strips its whole gang, with one
    GangVetoed event (the JAX :393-428 rule)."""
    store = TStore()
    for i in range(4):
        store.create("nodes", tt.MakeNode(f"n{i}").capacity({"cpu": "8"}).obj())
    sched = TBatch(store, device="cpu")
    sched.sync()
    store.create("podgroups", tt.make_pod_group("v", 3))
    pods = [tt.MakePod(f"g-{i}").gang("v").req({"cpu": "1"}).obj() for i in range(2)]
    pods.append(tt.MakePod("g-2").gang("v").req({"cpu": "1"}).pvc("claim").obj())
    store.create_many("pods", pods)
    sched.run_until_idle()
    assert not any(p.spec.node_name for p in store.list("pods")[0])
    assert sched.gang_vetoes == 1
    assert sched.fallback_pods == 0 and sched.serial_scheduled == 0
    reasons = collections.Counter(e.reason for e in store.list("events")[0])
    assert reasons["GangVetoed"] == 1
