"""Gang preemption and rank-aware placement in the port
(scheduler/gangpreempt.py, the victim half of
scheduler/plugins/default_preemption.py, the parked queue tier, and the
rank-alignment pass of scheduler/batch.py) against the JAX package.

The scenarios of tests/test_gangpreempt.py run in both packages over
identical stores, driven to idle in a wall-deadline loop with synchronous
victim preparation; the bound map (deleted victims are gone from it), the
failed pods, the events by (reason, object), the queue tiers and the
preemptor's totals are equal. Unit parity covers the victim flattening, the
PDB mask, the cover selection's room_exists abort and consume_cover.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_gang import Env, assert_same_end_state, run_both

import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.scheduler import gangpreempt as jgp
from kubernetes_tpu.snapshot.tensorizer import build_cluster_tensors as j_build_cluster
from kubernetes_tpu_torch.models.gangcover import mean_neighbor_distance
from kubernetes_tpu_torch.scheduler import gangpreempt as tgp
from kubernetes_tpu_torch.scheduler.gang import node_slice_positions, ring_lengths
from kubernetes_tpu_torch.snapshot.tensorizer import build_cluster_tensors


def slice_cluster(env, n_slices=2, per_slice=4, cpu="8", mem="32Gi"):
    for s in range(n_slices):
        for i in range(per_slice):
            env.store.create("nodes", env.m.MakeNode(f"node-{s}-{i}").tpu_slice(s, index=i)
                             .capacity({"cpu": cpu, "memory": mem, "pods": "110"}).obj())


def fillers(env, n_slices=2, per_slice=4, cpu="6", prio=1, prefix="low", gang=None):
    out = []
    for s in range(n_slices):
        for i in range(per_slice):
            b = env.m.MakePod(f"{prefix}-{s}-{i}").priority(prio).req({"cpu": cpu})
            if gang:
                b = b.gang(gang)
            low = b.obj()
            low.spec.node_name = f"node-{s}-{i}"
            env.store.create("pods", low)
            out.append(low)
    return out


def gang(env, n, cpu="3", prio=100, min_member=None, name="train", ranked=True, prefix="g"):
    env.pg(name, min_member or n)
    pods = [env.m.MakePod(f"{prefix}-{i}").gang(name, rank=i if ranked else None)
            .priority(prio).req({"cpu": cpu}).obj() for i in range(n)]
    env.store.create_many("pods", pods, consume=True)
    return [f"default/{prefix}-{i}" for i in range(n)]


def gang_bound(env, prefix="g-"):
    return sorted((p.metadata.name, p.spec.node_name) for p in env.store.list("pods")[0]
                  if p.metadata.name.startswith(prefix) and p.spec.node_name)


def drive(env, want, deadline_s=15.0, prefix="g-"):
    """Until `want` gang members are bound or the wall deadline: eviction,
    parking, release and the re-solve take several cycles."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        env.sched.run_until_idle()
        env.sched.queue.flush_backoff_completed()
        env.sched.pump_events()
        if len(gang_bound(env, prefix)) >= want:
            return
        time.sleep(0.02)


def conservation(env, keys):
    return (tt if env.port else jt).assert_pod_conservation(env.store, env.sched, keys)["counts"]


# -- scenarios ---------------------------------------------------------------------


def sc_min_cost_cover(env):
    slice_cluster(env)
    fillers(env)
    env.make_sched()
    env.sync_preemption()
    keys = gang(env, 8)
    drive(env, 8)
    assert len(gang_bound(env)) == 8
    assert len({n.split("-")[1] for _, n in gang_bound(env)}) == 1
    return env.sched.gangpreempt.stats(), conservation(env, keys), \
        env.sched.queue.gang_parked_count()


def sc_partial_room_vetoes(env):
    slice_cluster(env)
    fillers(env)
    env.make_sched()
    env.sync_preemption()
    keys = gang(env, 12)
    env.drive()
    assert gang_bound(env) == [] and len(env.store.list("pods")[0]) == 20
    msgs = sorted(e.message for e in env.store.list("events")[0]
                  if e.reason == "GangPreemptionVetoed")
    assert msgs and "partial eviction refused" in msgs[0]
    return env.sched.gangpreempt.stats(), conservation(env, keys), msgs


def sc_cheaper_slice(env):
    slice_cluster(env)
    for s, prio in ((0, 5), (1, 2)):
        for i in range(4):
            low = env.m.MakePod(f"low-{s}-{i}").priority(prio).req({"cpu": "6"}).obj()
            low.spec.node_name = f"node-{s}-{i}"
            env.store.create("pods", low)
    env.make_sched()
    env.sync_preemption()
    gang(env, 8)
    drive(env, 8)
    assert {n.split("-")[1] for _, n in gang_bound(env)} == {"1"}
    return env.sched.gangpreempt.stats()


def sc_members_never_victims(env):
    slice_cluster(env, n_slices=1)
    env.pg("placed", 4)
    fillers(env, n_slices=1, gang="placed")
    env.make_sched()
    env.sync_preemption()
    keys = gang(env, 8)
    env.drive()
    assert gang_bound(env) == [] and len(env.store.list("pods")[0]) == 12
    return env.sched.gangpreempt.stats(), conservation(env, keys)


def sc_pdb_excluded(env):
    slice_cluster(env, n_slices=1)
    fl = fillers(env, n_slices=1)
    if env.port:
        from kubernetes_tpu_torch.api.policy import PodDisruptionBudget
    else:
        from kubernetes_tpu.api.policy import PodDisruptionBudget
    env.store.create("poddisruptionbudgets", PodDisruptionBudget.from_dict({
        "metadata": {"name": "protect-low", "namespace": "default"},
        "spec": {"selector": {"matchLabels": {}}, "minAvailable": len(fl)},
        "status": {"disruptionsAllowed": 0}}))
    env.make_sched()
    env.sync_preemption()
    gang(env, 8)
    env.drive()
    assert gang_bound(env) == []
    return env.sched.gangpreempt.stats()


def sc_policy_never(env):
    slice_cluster(env, n_slices=1)
    fillers(env, n_slices=1)
    env.make_sched()
    env.sync_preemption()
    env.pg("train", 4)
    pods = []
    for i in range(4):
        p = env.m.MakePod(f"g-{i}").gang("train", rank=i).priority(100).req({"cpu": "3"}).obj()
        p.spec.preemption_policy = "Never"
        pods.append(p)
    env.store.create_many("pods", pods, consume=True)
    env.drive()
    assert gang_bound(env) == [] and len(env.store.list("pods")[0]) == 8
    return env.sched.gangpreempt.stats()


def sc_two_gangs_disjoint(env):
    slice_cluster(env)
    fillers(env)
    env.make_sched()
    env.sync_preemption()
    env.pg("a", 8)
    env.pg("b", 8)
    pods = []
    for name in ("a", "b"):
        pods += [env.m.MakePod(f"g-{name}{i}").gang(name, rank=i).priority(100)
                 .req({"cpu": "3"}).obj() for i in range(8)]
    env.store.create_many("pods", pods, consume=True)
    drive(env, 16)
    by_gang = {}
    for name, node in gang_bound(env):
        by_gang.setdefault(name[2], set()).add(node.split("-")[1])
    assert all(len(s) == 1 for s in by_gang.values()) and by_gang["a"] != by_gang["b"]
    stats = env.sched.gangpreempt.stats()
    assert stats["released"] == 2 and stats["expired"] == 0
    return stats, conservation(env, [p.key for p in pods])


def rank_workload(env):
    for i in range(8):
        env.store.create("nodes", env.m.MakeNode(f"node-0-{i}").tpu_slice(0, index=i)
                         .capacity({"cpu": "8", "memory": "32Gi", "pods": "110"}).obj())


def sc_rank_aligned(env):
    rank_workload(env)
    gang(env, 16, cpu="3", ranked=True)
    env.make_sched()
    env.drive()
    return len(gang_bound(env))


def sc_rank_blind(env):
    rank_workload(env)
    gang(env, 16, cpu="3", ranked=True)
    env.make_sched(rank_align=False)
    env.drive()
    return len(gang_bound(env))


def sc_rankless(env):
    rank_workload(env)
    gang(env, 16, cpu="3", ranked=False)
    env.make_sched()
    env.drive()
    return len(gang_bound(env))


PREEMPT_SCENARIOS = {
    "min_cost_cover": sc_min_cost_cover,
    "partial_room_vetoes": sc_partial_room_vetoes,
    "cheaper_slice": sc_cheaper_slice,
    "members_never_victims": sc_members_never_victims,
    "pdb_excluded": sc_pdb_excluded,
    "policy_never": sc_policy_never,
    "two_gangs_disjoint": sc_two_gangs_disjoint,
    "rank_aligned": sc_rank_aligned,
    "rank_blind": sc_rank_blind,
    "rankless": sc_rankless,
}


@pytest.mark.parametrize("name", sorted(PREEMPT_SCENARIOS))
def test_gang_preemption_scenario_matches_jax(name):
    assert_same_end_state(PREEMPT_SCENARIOS[name], "fast")


@pytest.mark.parametrize("name", ["min_cost_cover", "partial_room_vetoes", "rank_aligned"])
def test_gang_preemption_scenario_matches_jax_exact(name):
    assert_same_end_state(PREEMPT_SCENARIOS[name], "exact")


def test_min_cost_cover_evicts_one_slice_and_narrates():
    env = Env(True)
    stats, counts, parked = sc_min_cost_cover(env)
    ripped = {n.split("-")[1] for _, n in gang_bound(env)}.pop()
    left = sorted(p.metadata.name for p in env.store.list("pods")[0]
                  if p.metadata.name.startswith("low-"))
    assert len(left) == 4 and all(not n.startswith(f"low-{ripped}-") for n in left)
    assert (stats["preempted"], stats["victims"], stats["slices_ripped"], stats["released"],
            stats["vetoed_partial"], stats["waiting_gangs"]) == (1, 4, 1, 1, 0, 0)
    assert parked == 0 and counts["lost"] == 0
    reasons = [e.reason for e in env.store.list("events")[0]]
    assert reasons.count("GangPreempting") == 1 and reasons.count("Preempted") == 4
    st = env.sched.gang_stats()
    assert st["preemption"]["victims"] == 4 and st["parked"] == 0


def test_partial_room_requeues_the_gang_in_backoff():
    env = Env(True)
    stats, _counts, _msgs = sc_partial_room_vetoes(env)
    assert stats["vetoed_partial"] >= 1 and stats["preempted"] == 0 == stats["victims"]
    assert env.sched.queue.lengths()[1] == 12


def test_rank_alignment_improves_adjacency_and_keeps_the_node_multiset():
    def adjacency(env):
        from kubernetes_tpu_torch.api.podgroup import pod_gang_rank, pod_group_key

        cl = build_cluster_tensors(env.sched.cache.update_snapshot())
        slice_ids, pos = node_slice_positions(cl)
        node_idx = {n: i for i, n in enumerate(cl.node_names)}
        rows = [(pod_group_key(p), pod_gang_rank(p), node_idx[p.spec.node_name])
                for p in env.store.list("pods")[0] if p.spec.node_name]
        return mean_neighbor_distance([0] * len(rows), [r for _, r, _ in rows],
                                      [int(slice_ids[i]) for _, _, i in rows],
                                      [int(pos[i]) for _, _, i in rows],
                                      ring_lengths(slice_ids, pos))

    blind, aligned = Env(True), Env(True)
    sc_rank_blind(blind)
    sc_rank_aligned(aligned)
    d_blind, d_aligned = adjacency(blind), adjacency(aligned)
    assert d_aligned < d_blind and d_aligned <= 1.0
    assert sorted(n for _, n in gang_bound(blind)) == sorted(n for _, n in gang_bound(aligned))
    gi = aligned.sched.last_gang
    assert gi["adjacency_post"] <= gi["adjacency_pre"] and gi["rank_aligned"] > 0
    rankless = Env(True)
    sc_rankless(rankless)
    assert "rank_aligned" not in rankless.sched.last_gang


def _stall_deletes(monkeypatch, env):
    if env.port:
        from kubernetes_tpu_torch.scheduler.plugins.default_preemption import DefaultPreemption
    else:
        from kubernetes_tpu.scheduler.plugins.default_preemption import DefaultPreemption
    monkeypatch.setattr(DefaultPreemption, "_delete_victims", lambda self, victims: None)


def test_parked_gang_released_by_deadline_when_deletions_stall(monkeypatch):
    def scenario(env):
        slice_cluster(env, n_slices=1)
        fillers(env, n_slices=1)
        env.make_sched()
        env.sync_preemption()
        _stall_deletes(monkeypatch, env)
        keys = gang(env, 8)
        env.drive()
        seen = [env.sched.queue.gang_parked_count(), env.sched.gangpreempt.stats()["preempted"]]
        env.sched.sweep_expired_assumes()
        seen.append(env.sched.queue.gang_parked_count())
        env.clock.step(env.sched.gangpreempt.PARK_TIMEOUT_S + 1.0)
        env.sched.sweep_expired_assumes()
        stats = env.sched.gangpreempt.stats()
        seen += [env.sched.queue.gang_parked_count(), stats["expired"], stats["waiting_gangs"]]
        assert seen == [8, 1, 8, 0, 1, 0]
        return seen, conservation(env, keys)

    assert_same_end_state(scenario, "fast", clock=True)


def test_resync_clears_parked_cover_state(monkeypatch):
    def scenario(env):
        slice_cluster(env, n_slices=1)
        fillers(env, n_slices=1)
        env.make_sched()
        env.sync_preemption()
        _stall_deletes(monkeypatch, env)
        keys = gang(env, 8)
        env.drive()
        parked = env.sched.queue.gang_parked_count()
        env.sched.resync_from_store()
        out = (parked, env.sched.gangpreempt.stats()["waiting_gangs"],
               env.sched.queue.gang_parked_count(), conservation(env, keys))
        assert out[:3] == (8, 0, 0)
        return out

    want, got, want_x, got_x, _j, _t = run_both(scenario, "fast")
    assert got_x == want_x and got["placement"] == want["placement"]


@pytest.mark.parametrize("trial", range(6))
def test_randomized_never_partially_evicted_sweep(trial):
    """Random topologies, filler loads and gang shapes: a gang is only ever
    fully placed or fully unplaced, a veto evicts nothing, every gang pod is
    conserved, and the port ends exactly where JAX does."""
    rng = np.random.default_rng(1234 + trial)
    shape = dict(n_slices=int(rng.integers(1, 4)), per_slice=int(rng.integers(2, 5)),
                 node_cpu=int(rng.integers(6, 13)))
    shape.update(filler_cpu=int(rng.integers(2, shape["node_cpu"])),
                 gang_cpu=int(rng.integers(1, 5)), members=int(rng.integers(2, 11)),
                 gang_prio=int(rng.integers(0, 3)) * 100)

    def scenario(env):
        slice_cluster(env, n_slices=shape["n_slices"], per_slice=shape["per_slice"],
                      cpu=str(shape["node_cpu"]))
        fl = fillers(env, n_slices=shape["n_slices"], per_slice=shape["per_slice"],
                     cpu=str(shape["filler_cpu"]), prio=50)
        env.make_sched()
        env.sync_preemption()
        keys = gang(env, shape["members"], cpu=str(shape["gang_cpu"]), prio=shape["gang_prio"])
        drive(env, shape["members"], deadline_s=6.0)
        env.drive()
        bound = gang_bound(env)
        assert len(bound) in (0, shape["members"]), shape
        evicted = len(fl) - sum(1 for p in env.store.list("pods")[0]
                                if p.metadata.name.startswith("low-"))
        stats = env.sched.gangpreempt.stats()
        if stats["preempted"] == 0:
            assert evicted == 0, shape
        else:
            assert len(bound) == shape["members"], shape
        return stats, evicted, conservation(env, keys)

    assert_same_end_state(scenario, "fast")


@pytest.mark.parametrize("coalesce_watch", [True, False])
def test_gang_free_batches_identical_with_subsystem_armed(coalesce_watch):
    """With the preemptor and rank alignment on (the defaults), a gang-free
    workload gives the same placements and store history as with both off."""
    def run(**kw):
        env = Env(True)
        for i in range(8):
            env.store.create("nodes", tt.MakeNode(f"n-{i}").tpu_slice(i % 2, index=i)
                             .capacity({"cpu": "8", "memory": "32Gi", "pods": "110"}).obj())
        env.make_sched(**kw)
        pods = [tt.MakePod(f"p-{i}").req({"cpu": "500m"}).obj() for i in range(40)]
        if coalesce_watch:
            env.store.create_many("pods", pods, consume=True)
        else:
            for p in pods:
                env.store.create("pods", p)
        env.drive()
        placements = sorted((p.metadata.name, p.spec.node_name)
                            for p in env.store.list("pods")[0])
        history = [(e.kind, e.type, e.obj.metadata.name) for e in env.store.history_events()]
        return placements, history

    assert run() == run(rank_align=False, gang_preemption=False)


# -- unit parity ---------------------------------------------------------------------


def test_select_cover_aborts_when_any_slice_has_free_room():
    outs = []
    for m, gp_mod in ((jt, jgp), (tt, tgp)):
        victims = [m.MakePod(f"v-{i}").priority(1).req({"cpu": "6"}).obj() for i in range(2)]
        ctx = {
            "cluster": SimpleNamespace(n=4),
            "sub": SimpleNamespace(
                gang_of_pod=np.array([0, 0, 0, 0]), class_of_pod=np.array([0, 0, 0, 0]),
                req=np.array([[3]] * 4, dtype=np.int64),
                tables=SimpleNamespace(filter_ok=np.ones((1, 4), dtype=bool))),
            "free": np.array([[10], [10], [0], [0]], dtype=np.int64),
            "headroom": np.array([10, 10, 10, 10], dtype=np.int64),
            "slice_ids": np.array([0, 0, 1, 1], dtype=np.int64),
            "victims": (np.array([2, 3]), np.array([1, 1]),
                        np.array([[6], [6]], dtype=np.int64), victims),
            "pdb_blocked": np.zeros(2, dtype=bool),
        }
        gp = gp_mod.GangPreemptor.__new__(gp_mod.GangPreemptor)
        gp.sched = SimpleNamespace(device=torch.device("cpu"))
        cover = gp._select_cover(gid=0, need=4, prio=100, ctx=ctx)
        outs.append((cover.room_exists, cover.victims, cover.considered))
    assert outs[0] == outs[1] and outs[1][:2] == (True, [])


def test_select_cover_picks_the_same_victims_as_jax():
    """A two-slice context where both slices can be covered: the same slice,
    the same victim indices, the same cost."""
    outs = []
    for m, gp_mod in ((jt, jgp), (tt, tgp)):
        rng = np.random.default_rng(3)
        victims = [m.MakePod(f"v-{i}").priority(int(p)).req({"cpu": "2"}).obj()
                   for i, p in enumerate(rng.integers(0, 4, size=12))]
        ctx = {
            "cluster": SimpleNamespace(n=6),
            "sub": SimpleNamespace(
                gang_of_pod=np.array([0, 0, 0]), class_of_pod=np.array([0, 0, 0]),
                req=np.array([[3, 1]] * 3, dtype=np.int64),
                tables=SimpleNamespace(filter_ok=np.array([[1, 1, 0, 1, 1, 1]], dtype=bool))),
            "free": np.array([[2, 9]] * 6, dtype=np.int64),
            "headroom": np.array([5, 5, 5, 5, 1, 5], dtype=np.int64),
            "slice_ids": np.array([0, 0, 0, 1, 1, 1], dtype=np.int64),
            "victims": (rng.integers(0, 6, size=12), np.array([v.spec.priority for v in victims]),
                        rng.integers(1, 5, size=(12, 2)).astype(np.int64), victims),
            "pdb_blocked": rng.random(12) < 0.2,
        }
        gp = gp_mod.GangPreemptor.__new__(gp_mod.GangPreemptor)
        gp.sched = SimpleNamespace(device=torch.device("cpu"))
        c = gp._select_cover(gid=0, need=3, prio=3, ctx=ctx)
        outs.append((c.slice_id, None if c.chosen is None else c.chosen.tolist(), c.cost,
                     c.max_prio, c.considered, c.capped, c.room_exists))
    assert outs[0] == outs[1] and outs[1][1]


def test_consume_cover_folds_room_and_shrinks_the_pool():
    victims = [tt.MakePod(f"v-{i}").priority(1).req({"cpu": "2"}).obj() for i in range(3)]
    ctx = {
        "free": np.array([[1], [1]], dtype=np.int64),
        "headroom": np.array([5, 5], dtype=np.int64),
        "victims": (np.array([0, 1, 0]), np.array([1, 2, 3]),
                    np.array([[2], [4], [6]], dtype=np.int64), victims),
        "pdb_blocked": np.array([False, True, False]),
    }
    tgp.GangPreemptor.consume_cover(ctx, tgp._Cover(chosen=np.array([0, 2]),
                                                    victims=[victims[0], victims[2]]))
    assert ctx["free"].tolist() == [[9], [1]]
    assert ctx["headroom"].tolist() == [7, 5]
    v_node, v_prio, v_req, v_pods = ctx["victims"]
    assert v_node.tolist() == [1] and v_prio.tolist() == [2] and v_pods == [victims[1]]
    assert ctx["pdb_blocked"].tolist() == [True]


def test_flatten_snapshot_victims_and_pdb_mask_match_jax():
    outs = []
    for port in (False, True):
        env = Env(port)
        slice_cluster(env, n_slices=2, per_slice=2)
        fillers(env, n_slices=2, per_slice=2)
        env.store.create("pods", env.m.MakePod("extra").labels({"app": "x"}).priority(7)
                         .req({"cpu": "1", "memory": "1Gi"}).node("node-0-0").obj())
        env.make_sched()
        snap = env.sched.cache.update_snapshot()
        cl = (build_cluster_tensors if port else j_build_cluster)(snap)
        mod = tgp if port else jgp
        v_node, v_prio, v_req, v_pods, node_victims = mod.flatten_snapshot_victims(
            snap, cl.resource_dims)
        if port:
            from kubernetes_tpu_torch.api.policy import PodDisruptionBudget
        else:
            from kubernetes_tpu.api.policy import PodDisruptionBudget
        pdbs = [PodDisruptionBudget.from_dict({
            "metadata": {"name": "p", "namespace": "default"},
            "spec": {"selector": {"matchLabels": {"app": "x"}}},
            "status": {"disruptionsAllowed": 0}})]
        outs.append((v_node.tolist(), v_prio.tolist(), v_req.tolist(),
                     [p.metadata.name for p in v_pods], node_victims,
                     mod.pdb_blocked_mask(v_pods, pdbs).tolist(),
                     mod.pdb_blocked_mask(v_pods, []).tolist()))
    assert outs[0] == outs[1]
    assert outs[1][5].count(True) == 1
