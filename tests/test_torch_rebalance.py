"""The port's background rebalancer (scheduler/rebalance.py, the idle hook
and rebalance_stats() of scheduler/batch.py) against the JAX package.

Every scenario of tests/test_rebalance.py runs in both packages over
identical stores, the JAX scheduler on its default columnar store and the
port on its lean list-based one: consolidation within the budgets, bounded
replacement names, the unlabeled no-op, the seeded never-worse sweep with
PDB-blocked, gang and above-ceiling pods, one rebalancer a store, shard
inertness, pacing, the gang admitted after defrag through run_until_idle,
the injected cycle fault, the mid-wave rollback, the mid-wave kill with
conservation, and the SLO abort. The cycle summaries, stats(), the end
{pod: node} maps, the -mgN names, the migration chains and resolve_keys
are equal, and so are the trace events the cycles leave in an armed
trace buffer. Every comparison is exact.

The reference tests run under the JAX package's mutation detector
(`mutation_detector_guard`), which belongs to its full store; the port's
lean store has none yet (ROADMAP.md queue 1 item 7), so these tests leave it
out. The columnar store's materialization counter of
test_noop_cycle_is_allocation_free is replaced here by what the port can
observe: a below-threshold cycle lists no pods, selects no candidates and
plans nothing.
"""

import time

import numpy as np
import pytest
from test_torch_gang import Env, assert_same_end_state, run_both

import kubernetes_tpu.chaos.faultinject as jfi
import kubernetes_tpu.obs.tracebuf as jtb
import kubernetes_tpu_torch.chaos.faultinject as tfi
import kubernetes_tpu_torch.obs.tracebuf as ttb
from kubernetes_tpu.api import ObjectMeta as JMeta
from kubernetes_tpu.api import Selector as JSelector
from kubernetes_tpu.api.policy import PodDisruptionBudget as JPDB
from kubernetes_tpu.scheduler import rebalance as jrb
from kubernetes_tpu_torch.api import ObjectMeta as TMeta
from kubernetes_tpu_torch.api import Selector as TSelector
from kubernetes_tpu_torch.api.policy import PodDisruptionBudget as TPDB
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.scheduler import rebalance as trb


@pytest.fixture(autouse=True)
def _always_disarm():
    for m in (jfi, tfi, jtb, ttb):
        m.disarm()
    yield
    for m in (jfi, tfi, jtb, ttb):
        m.disarm()


def fi(env):
    return tfi if env.port else jfi


def rb_module(env):
    return trb if env.port else jrb


def slice_cluster(env, n_slices=2, per_slice=4, cpu="8"):
    for s in range(n_slices):
        for i in range(per_slice):
            env.store.create("nodes", env.m.MakeNode(f"node-{s}-{i}").tpu_slice(s, index=i)
                             .capacity({"cpu": cpu, "memory": "32Gi", "pods": "110"}).obj())


def fill(env, name, node, cpu="3", prio=1, labels=None):
    p = env.m.MakePod(name).priority(prio).req({"cpu": cpu}).obj()
    if labels:
        p.metadata.labels.update(labels)
    p.spec.node_name = node
    env.store.create("pods", p)
    return p


def smear(env, n_slices=2, per_slice=4, cpu="3", prio=1):
    """One filler per node: free capacity evenly smeared across slices."""
    return [fill(env, f"low-{s}-{i}", f"node-{s}-{i}", cpu=cpu, prio=prio).key
            for s in range(n_slices) for i in range(per_slice)]


def conservation(env, keys):
    return env.m.assert_pod_conservation(env.store, env.sched, keys)["counts"]


def rb_stats(env):
    """The port's rebalance_stats() is the JAX sched_stats()["rebalance"]."""
    if env.port:
        return env.sched.rebalance_stats()
    return env.sched.sched_stats()["rebalance"]


def names(env):
    return sorted(p.metadata.name for p in env.store.list("pods")[0])


def chain(rb):
    return sorted(rb._moves.items())


# -- scenarios -------------------------------------------------------------------


def sc_consolidates(env):
    slice_cluster(env)
    keys = smear(env)
    env.make_sched()
    assert rb_stats(env) is None
    rb = env.sched.enable_rebalancer(frag_threshold=0.25, budget_per_wave=2,
                                     budget_per_cycle=8, priority_ceiling=50)
    r1 = rb.cycle()
    assert r1["ran"] and r1["migrations"] == 4 and r1["waves"] == 2
    env.sched.pump_events()
    r2 = rb.cycle()
    assert r2["migrations"] == 0 and r2["frag"] < 0.25
    assert all(p.spec.node_name.startswith("node-1-") for p in env.store.list("pods")[0])
    live = rb.resolve_keys(keys)
    st = rb.stats()
    assert st["migrations"] == 4 and st["plans"] == 1
    return r1, r2, live, conservation(env, live), st, rb_stats(env), chain(rb)


def sc_unlabeled_noop(env):
    for i in range(3):
        env.store.create("nodes", env.m.MakeNode(f"plain-{i}").capacity(
            {"cpu": "8", "memory": "32Gi", "pods": "110"}).obj())
    fill(env, "a", "plain-0", cpu="6")
    env.make_sched()
    rb = env.sched.enable_rebalancer()
    r = rb.cycle()
    assert r["ran"] and r["migrations"] == 0 and rb.stats()["noop_cycles"] == 1
    return r, rb.stats()


def sc_below_threshold_noop(env):
    slice_cluster(env)
    for i in range(4):  # consolidated: all fillers on slice 0, slice 1 free
        fill(env, f"low-{i}", f"node-0-{i}", cpu="6")
    env.make_sched()
    rb = env.sched.enable_rebalancer(frag_threshold=0.25)
    r = rb.cycle()
    assert r["ran"] and r["migrations"] == 0 and rb.stats()["noop_cycles"] == 1
    return r, rb.stats()


def sc_one_rebalancer_per_store(env):
    slice_cluster(env)
    smear(env)
    s1 = env.make_sched()
    s2 = env.make_sched()
    cls = rb_module(env).Rebalancer
    rb1 = cls(s1, frag_threshold=0.25, priority_ceiling=50)
    rb2 = cls(s2, frag_threshold=0.25, priority_ceiling=50)
    a = rb1.cycle()
    assert a["ran"]
    b = rb2.cycle()
    assert not b["ran"] and b["reason"] == "conflict"
    assert rb2.stats()["inert_conflict"] == 1
    rb1.release()  # the successor may then own the store
    s2.pump_events()
    c = rb2.cycle()
    assert c["ran"]
    rb2.release()
    return a, b, c, rb1.stats(), rb2.stats(), chain(rb1), chain(rb2)


def sc_shard_inert(env):
    slice_cluster(env)
    smear(env)
    env.make_sched()
    rb = env.sched.enable_rebalancer(frag_threshold=0.25, priority_ceiling=50)
    env.sched.partition_index = 0  # shard pipeline: partial view
    a = rb.cycle()
    assert not a["ran"] and a["reason"] == "partition"
    assert rb.stats()["inert_partition"] == 1
    env.sched.partition_index = -1  # residual full-view pipeline: owns it
    b = rb.cycle()
    assert b["ran"]
    rb.release()
    return a, b, rb.stats(), chain(rb)


def sc_paces(env):
    slice_cluster(env)
    env.make_sched()
    rb = env.sched.enable_rebalancer(min_interval_s=3600.0)
    first = rb.maybe_cycle()
    assert first is not None
    assert rb.maybe_cycle() is None  # within the interval
    rb.release()
    return first, rb.stats()


def sc_gang_after_defrag(env):
    """A gang no fragmented slice holds admits WITHOUT preemption once the
    idle-path rebalancer consolidates a slice (gang preemption off, so the
    destructive path cannot race the migration path)."""
    slice_cluster(env)
    keys = smear(env)  # 3 cpu used per node -> 5 free; the gang needs 6
    env.make_sched(gang_preemption=False)
    env.sched.enable_rebalancer(frag_threshold=0.25, budget_per_wave=4,
                                budget_per_cycle=8, priority_ceiling=50)
    env.pg("train", 4)
    gang = [env.m.MakePod(f"g-{i}").gang("train", rank=i).priority(100)
            .req({"cpu": "6"}).obj() for i in range(4)]
    env.store.create_many("pods", gang, consume=True)
    env.sched.pump_events()
    deadline = time.time() + 15.0
    bound = {}
    while time.time() < deadline:
        env.sched.run_until_idle()
        env.sched.queue.flush_backoff_completed()
        env.sched.pump_events()
        bound = {p.metadata.name: p.spec.node_name for p in env.store.list("pods")[0]
                 if p.metadata.name.startswith("g-")}
        if len(bound) == 4 and all(bound.values()):
            break
        time.sleep(0.02)
    assert len(bound) == 4 and all(bound.values()), bound
    rb = env.sched.rebalancer
    st = rb.stats()
    assert st["migrations"] > 0
    # nothing was evicted: every filler lives on, under its -mgN name
    live = rb.resolve_keys(keys)
    assert len(env.store.list("pods")[0]) == 12
    if not env.port:
        assert env.sched.preemption_count == 0
    rb.release()
    return bound, st["migrations"], st["waves"], live, conservation(env, live), chain(rb)


def sc_cycle_fault(env):
    slice_cluster(env)
    keys = smear(env)
    env.make_sched()
    rb = env.sched.enable_rebalancer(frag_threshold=0.25, priority_ceiling=50)
    m = fi(env)
    m.arm([m.FaultPlan("rebalance.cycle", "fail", count=1, match="cycle")])
    a = rb.cycle()
    assert not a["ran"] and a["reason"] == "fault"
    assert rb.stats()["fault_aborts"] == 1
    assert len(env.store.list("pods")[0]) == len(keys)  # nothing touched
    inj = m.ACTIVE.stats()
    m.disarm()
    b = rb.cycle()
    assert b["migrations"] > 0
    rb.release()
    return a, b, inj, rb.stats(), chain(rb)


def sc_midwave_rollback(env):
    slice_cluster(env)
    keys = smear(env)
    env.make_sched()
    rb = env.sched.enable_rebalancer(frag_threshold=0.25, budget_per_wave=2,
                                     priority_ceiling=50)
    m = fi(env)
    before = names(env)
    m.arm([m.FaultPlan("rebalance.cycle", "fail", count=1, match="midwave")])
    a = rb.cycle()
    assert a["ran"] and a["aborted"] and a["migrations"] == 0
    # rolled back: original pods, original nodes, no -mg duplicates
    assert names(env) == before
    env.sched.pump_events()
    env.sched.run_until_idle()
    live = rb.resolve_keys(keys)
    rb.release()
    return a, live, conservation(env, live), rb.stats(), chain(rb)


def sc_midwave_kill(env):
    """A HARD kill between replacement create and victim delete leaves a
    transient duplicate, but every submitted pod stays bound exactly once."""
    slice_cluster(env)
    keys = smear(env)
    env.make_sched()
    rb = env.sched.enable_rebalancer(frag_threshold=0.25, budget_per_wave=2,
                                     priority_ceiling=50)
    m = fi(env)
    m.arm([m.FaultPlan("rebalance.cycle", "kill", match="midwave")])
    with pytest.raises(m.FaultKill):
        rb.cycle()
    # before any retry: every original still bound, the wave's replacements
    # are the kill's only residue
    during = conservation(env, keys)
    dup = names(env)
    m.disarm()
    env.sched.pump_events()
    env.sched.run_until_idle()
    live = rb.resolve_keys(keys)
    rb.release()
    return during, dup, live, conservation(env, live), rb.stats(), chain(rb)


def sc_slo_abort(env):
    slice_cluster(env)
    smear(env)
    env.make_sched()
    rb = env.sched.enable_rebalancer(frag_threshold=0.25, priority_ceiling=50,
                                     slo_probe=lambda: False)
    r = rb.cycle()
    assert r["ran"] and r["aborted"] and r["migrations"] == 0
    assert rb.stats()["slo_aborts"] == 1
    rb.release()
    return r, rb.stats()


def sc_trace_hooks(env):
    """An armed trace buffer gets one slice per cycle and one instant per
    wave, and the injector's firings land on the chaos track."""
    slice_cluster(env)
    smear(env)
    env.make_sched()
    rb = env.sched.enable_rebalancer(frag_threshold=0.25, budget_per_wave=2,
                                     budget_per_cycle=8, priority_ceiling=50)
    tb = ttb if env.port else jtb
    buf = tb.arm()
    m = fi(env)
    m.arm([m.FaultPlan("rebalance.cycle", "fail", count=1, match="wave-1")])
    a = rb.cycle()
    m.disarm()
    env.sched.pump_events()
    b = rb.cycle()
    env.sched.pump_events()
    c = rb.cycle()
    tb.disarm()
    assert tb.current() is buf and not tb.enabled()
    tracks = {tid: name for name, tid in buf._tids.items()}
    events = list(buf._ring)
    st = buf.status()
    rb.release()
    return (a, b, c, [(tracks[e["tid"]], e["name"], e["cat"], e["ph"], e.get("args"))
                      for e in events],
            {k: st[k] for k in ("armed", "trace_events_total", "tracks")})


SCENARIOS = [sc_consolidates, sc_unlabeled_noop, sc_below_threshold_noop,
             sc_one_rebalancer_per_store, sc_shard_inert, sc_paces, sc_gang_after_defrag,
             sc_cycle_fault, sc_midwave_rollback, sc_midwave_kill, sc_slo_abort, sc_trace_hooks]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    assert_same_end_state(scenario)


def test_migration_names_stay_bounded():
    for name, seq in (("web-0", 3), ("web-0-mg3", 7), ("web-0-mg3x", 7), ("a-mg1-mg2", 9)):
        assert trb._mg_name(name, seq) == jrb._mg_name(name, seq)
    assert trb._mg_name("web-0-mg3", 7) == "web-0-mg7"
    assert trb._mg_name("web-0-mg3x", 7) == "web-0-mg3x-mg7"


def test_noop_cycle_lists_no_pods_and_plans_nothing(monkeypatch):
    """The port's stand-in for the columnar materialization counter: a
    below-threshold cycle reads the cluster tensors and the score alone."""
    env = Env(port=True)
    slice_cluster(env)
    for i in range(4):
        fill(env, f"low-{i}", f"node-0-{i}", cpu="6")
    env.make_sched()
    rb = env.sched.enable_rebalancer(frag_threshold=0.25)
    calls = []
    real_list = env.store.list

    def counting_list(kind, *a, **kw):
        calls.append(kind)
        return real_list(kind, *a, **kw)

    def forbidden(*a, **kw):
        raise AssertionError("a below-threshold cycle must not get this far")

    monkeypatch.setattr(env.store, "list", counting_list)
    monkeypatch.setattr(rb, "_candidates", forbidden)
    monkeypatch.setattr(trb, "defrag_plan", forbidden)
    launches = kernels.LAUNCHES["defrag_assign"]
    r = rb.cycle()
    assert r["ran"] and r["migrations"] == 0 and 0 < r["frag"] < 0.25
    assert "pods" not in calls
    assert kernels.LAUNCHES["defrag_assign"] == launches
    assert rb.stats()["noop_cycles"] == 1


def _sweep_specs():
    """The 6 trials of tests/test_rebalance.py's never-worse sweep, drawn from
    the same generator in the same order: (n_slices, per_slice, [(s, i,
    kind)], budget_per_cycle)."""
    rng = np.random.default_rng(170)
    specs = []
    for _ in range(6):
        n_slices = int(rng.integers(2, 4))
        per_slice = int(rng.integers(2, 5))
        pods = []
        for s in range(n_slices):
            for i in range(per_slice):
                if rng.random() < 0.3:
                    continue
                pods.append((s, i, float(rng.random())))
        specs.append((n_slices, per_slice, pods, int(rng.integers(1, 5))))
    return specs


SWEEP = _sweep_specs()


def sweep_scenario(spec):
    n_slices, per_slice, spec_pods, budget_cycle = spec

    def run(env):
        slice_cluster(env, n_slices=n_slices, per_slice=per_slice)
        keys, protected = [], {}
        gang_named = False
        for s, i, kind in spec_pods:
            name, node = f"p-{s}-{i}", f"node-{s}-{i}"
            if kind < 0.2:  # above the priority ceiling: must never move
                p = fill(env, name, node, prio=1000)
                protected[p.key] = node
            elif kind < 0.4:  # PDB-exhausted: must never move
                p = fill(env, name, node, labels={"app": "guarded"})
                protected[p.key] = node
            elif kind < 0.55:  # gang member: must never move
                if not gang_named:
                    env.pg("g", 1)
                    gang_named = True
                p = env.m.MakePod(name).gang("g", rank=i).priority(1).req({"cpu": "3"}).obj()
                p.spec.node_name = node
                env.store.create("pods", p)
                protected[p.key] = node
            else:
                p = fill(env, name, node)
            keys.append(p.key)
        meta, sel, pdb = ((TMeta, TSelector, TPDB) if env.port else (JMeta, JSelector, JPDB))
        env.store.create("poddisruptionbudgets", pdb(
            metadata=meta(name="guard", namespace="default"),
            selector=sel.from_match_labels({"app": "guarded"}),
            max_unavailable=0, disruptions_allowed=0))
        env.make_sched()
        rb = env.sched.enable_rebalancer(frag_threshold=0.05, budget_per_wave=2,
                                         budget_per_cycle=budget_cycle, priority_ceiling=100)
        r = rb.cycle()
        assert r.get("migrations", 0) <= budget_cycle
        env.sched.pump_events()
        for key, node in protected.items():  # never moved, never renamed
            assert env.store.get("pods", key).spec.node_name == node
        env.sched.run_until_idle()
        live = rb.resolve_keys(keys)
        rb.release()
        return r, rb.stats(), live, conservation(env, live), chain(rb)

    return run


@pytest.mark.parametrize("trial", range(len(SWEEP)))
def test_randomized_never_worse_sweep_matches_jax(trial):
    assert_same_end_state(sweep_scenario(SWEEP[trial]))


def test_sweep_covers_every_protected_kind_and_migrates():
    kinds = {"ceiling" if k < 0.2 else "pdb" if k < 0.4 else "gang" if k < 0.55 else "movable"
             for _n, _p, pods, _b in SWEEP for _s, _i, k in pods}
    assert kinds == {"ceiling", "pdb", "gang", "movable"}
    moved = 0
    for spec in SWEEP:
        _want, got, want_x, got_x, _j, _t = run_both(sweep_scenario(spec))
        assert got_x == want_x
        moved += got_x[1]["migrations"]
    assert moved > 0
