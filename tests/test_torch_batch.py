"""The port's BatchScheduler(device="cpu") against the JAX package's
BatchScheduler over identical stores: the same {pod: node} map on every
workload of tests/test_batch_parity.py and on seeded mixed workloads (one
batch and many small batches), in the exact, fast, auto, auction and
sinkhorn modes (the transport modes' warm duals crossing batches too; a
host-port, constrained or gang batch under them runs the scan as in JAX).
Also: an injected solver exception (waterfill, or transport_solve)
requeues the batch with backoff and trips the circuit breaker exactly as
in JAX, a fallback-class pod is refused with the reason that names its
ROADMAP item, solver="native" places as JAX's native mode, and the port's
store keeps its contract.
"""

import random

import numpy as np
import pytest
from test_torch_workloads import MIXED_WORKLOADS, PARITY_WORKLOADS, ZONE, unpack, wl_seeded_mixed

import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.scheduler import Framework
from kubernetes_tpu.scheduler.batch import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.plugins import default_plugins
from kubernetes_tpu.store import APIStore as JStore
from kubernetes_tpu.utils import FakeClock as JFakeClock
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler as TBatch
from kubernetes_tpu_torch.store import AlreadyBoundError, APIStore as TStore
from kubernetes_tpu_torch.store import ConflictError, NotFoundError
from kubernetes_tpu_torch.utils import FakeClock
from kubernetes_tpu_torch.utils import FakeClock as TFakeClock


def run_pkg(workload, port: bool, batch_size=4096, rounds=1, solver="exact"):
    """Build the workload for one package, run its scheduler to idle (the
    pending pods split over `rounds` waves of creates), return the store's
    {pod name: node name} map and the scheduler."""
    mod = tt if port else jt
    nodes, pods, bound = unpack(workload(mod))
    store = TStore() if port else JStore()
    for n in nodes:
        store.create("nodes", n)
    for p in bound:
        store.create("pods", p)
    if port:
        sched = TBatch(store, device="cpu", batch_size=batch_size, solver=solver)
    else:
        sched = JBatch(store, Framework(default_plugins()), solver=solver,
                       batch_size=batch_size)
    # victims are deleted on the scheduling thread, so both packages see the
    # deletions at the same point of the run
    sched._preemption_plugin(sched.framework).async_preparation = False
    sched.sync()
    wave = -(-len(pods) // rounds)
    for lo in range(0, len(pods), wave):
        for p in pods[lo:lo + wave]:
            store.create("pods", p)
        sched.run_until_idle()
    got, _ = store.list("pods")
    return {p.metadata.name: p.spec.node_name for p in got}, sched


def assert_same_placements(workload, **kw):
    want, jsched = run_pkg(workload, port=False, **kw)
    got, tsched = run_pkg(workload, port=True, **kw)
    assert (tsched.preempt_victims_total, tsched.preemption_count) == \
        (jsched.preempt_victims_total, jsched.preemption_count)
    assert got == want, "\n".join(f"{k}: jax={want[k]!r} port={got.get(k)!r}"
                                  for k in want if want[k] != got.get(k))
    return got, tsched


@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_batch_scheduler_matches_jax(workload):
    assert_same_placements(workload)


@pytest.mark.parametrize("seed", range(4, 10))
def test_seeded_mixed_property(seed):
    """Seeded property over mixed workloads: identical placement maps."""
    rng = random.Random(seed)
    wl = wl_seeded_mixed(seed, n_nodes=rng.randint(6, 20), n_pods=rng.randint(20, 60))
    assert_same_placements(wl)


@pytest.mark.parametrize("workload", [MIXED_WORKLOADS[1], PARITY_WORKLOADS[1]],
                         ids=lambda w: w.__name__)
def test_small_batches_and_waves_match_jax(workload):
    """Many batches and several create waves: the incremental tensor cache,
    the dirty-row mirrors and the queue ordering across batches."""
    assert_same_placements(workload, batch_size=7, rounds=3)


def test_fallback_class_pod_refused_with_reason():
    """A fallback-class pod whose claim does not exist goes through the
    per-pod cycle and fails with VolumeBinding's own status and reason, as
    in the JAX package; it is never placed by another rule."""
    nodes = [tt.MakeNode(f"n{i}").capacity({"cpu": "8"}).obj() for i in range(2)]
    store = TStore()
    for n in nodes:
        store.create("nodes", n)
    store.create("pods", tt.MakePod("vol").req({"cpu": "100m"}).pvc("claim-a").obj())
    store.create("pods", tt.MakePod("plain").req({"cpu": "100m"}).obj())
    sched = TBatch(store, device="cpu")
    sched.sync()
    sched.run_until_idle()
    vol = store.get("pods", "default/vol")
    assert not vol.spec.node_name
    cond = [c for c in vol.status.conditions if c.type == "PodScheduled"]
    assert cond and cond[0].message == 'persistentvolumeclaim not found: "claim-a"'
    assert sched.fallback_pods == 1 and sched.serial_scheduled == 0
    assert sched.stage_seconds["fallback"] > 0
    qp = sched.queue._unschedulable["default/vol"]
    assert qp.unschedulable_plugins == ("VolumeBinding",)
    assert store.get("pods", "default/plain").spec.node_name


def test_device_rejects_fail_unschedulable():
    store = TStore()
    store.create("nodes", tt.MakeNode("n0").capacity({"cpu": "1"}).obj())
    for i in range(3):
        store.create("pods", tt.MakePod(f"p{i}").req({"cpu": "600m"}).obj())
    clock = FakeClock()
    sched = TBatch(store, device="cpu", clock=clock)
    sched.sync()
    sched.run_until_idle()
    pods, _ = store.list("pods")
    assert sum(1 for p in pods if p.spec.node_name) == 1
    assert sched.failed_count == 2 and sched.scheduled_count == 1
    assert len(sched.queue.unschedulable_pods()) == 2
    # a node added later moves them to backoff; once it expires the cycle
    # places one more
    store.create("nodes", tt.MakeNode("n1").capacity({"cpu": "1"}).obj())
    sched.run_until_idle()
    assert not sched.queue.unschedulable_pods()
    clock.step(2.0)
    sched.queue.flush_backoff_completed()
    sched.run_until_idle()
    pods, _ = store.list("pods")
    assert sum(1 for p in pods if p.spec.node_name) == 2


@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_native_solver_matches_jax(workload):
    """solver="native": constraint-free, gang-free batches placed by the host
    C engine (the port's own copy of hostsched.cpp), the others by the scan,
    the same map as the JAX package's native mode."""
    got, tsched = assert_same_placements(workload, solver="native")
    assert tsched.breaker.failures_total == 0


def test_native_solver_takes_constraint_free_batches_only():
    """The native path runs for a constraint-free batch and declines a
    constrained one to the scan, as in JAX."""
    store = TStore()
    for i in range(3):
        store.create("nodes", tt.MakeNode(f"n{i}").capacity({"cpu": "4"}).obj())
    store.create("pods", tt.MakePod("free").req({"cpu": "1"}).obj())
    sched = TBatch(store, device="cpu", solver="native")
    sched.sync()
    sched.run_until_idle()
    assert sched._solve_path == "native"
    store.create("pods", tt.MakePod("spread").labels({"app": "a"}).req({"cpu": "1"})
                 .topology_spread(1, "kubernetes.io/hostname", "DoNotSchedule",
                                  {"app": "a"}).obj())
    sched.run_until_idle()
    assert sched._solve_path == "exact"
    assert all(p.spec.node_name for p in store.list("pods")[0])


@pytest.mark.parametrize("solver", ["fast", "auto"])
@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_fast_modes_match_jax(workload, solver):
    got, tsched = assert_same_placements(workload, solver=solver)
    want_path = "repair" if tsched.repair_totals["batches"] else "fast"
    assert tsched._solve_path == want_path
    assert tsched.breaker.failures_total == 0


@pytest.mark.parametrize("solver", ["fast", "auto"])
@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_fast_modes_small_batches_match_jax(workload, solver):
    """Many small batches and create waves through waterfill and repair."""
    assert_same_placements(workload, batch_size=7, rounds=3, solver=solver)


def test_fast_mode_repair_totals_match_jax():
    want, jsched = run_pkg(MIXED_WORKLOADS[0], port=False, solver="fast", batch_size=9)
    got, tsched = run_pkg(MIXED_WORKLOADS[0], port=True, solver="fast", batch_size=9)
    assert got == want
    assert tsched.repair_totals == jsched.repair_totals
    assert tsched.repair_totals["batches"] > 0
    assert tsched._last_repair.as_dict() == jsched._last_repair.as_dict()


def _breaker_run(port: bool, monkeypatch, threshold=2, solver="fast"):
    """Both packages: a scheduler whose fast-path solver (waterfill for
    fast, transport_solve for auction/sinkhorn) raises for the first three
    cycles; then the fault is removed and three more pods arrive. Returns
    the breaker/queue/placement state after each of five cycles (the clock
    steps 11 s, past the pod backoff, between cycles; the cooldown is 15 s)."""
    import kubernetes_tpu.models.transport as jtr
    import kubernetes_tpu.models.waterfill as jwf
    import kubernetes_tpu_torch.scheduler.batch as tbatch

    def boom(*_a, **_k):
        raise RuntimeError("injected solver fault")

    mod = tt if port else jt
    clock = (TFakeClock if port else JFakeClock)()
    store = TStore() if port else JStore()
    for i in range(4):
        store.create("nodes", mod.MakeNode(f"n{i}").capacity({"cpu": "8"}).obj())
    target = "waterfill_solve" if solver == "fast" else "transport_solve"
    if port:
        monkeypatch.setattr(tbatch, target, boom)
        sched = TBatch(store, device="cpu", solver=solver, clock=clock,
                       breaker_threshold=threshold, breaker_cooldown_s=15.0)
    else:
        monkeypatch.setattr(jwf if solver == "fast" else jtr, target, boom)
        sched = JBatch(store, Framework(default_plugins()), solver=solver, clock=clock,
                       breaker_threshold=threshold, breaker_cooldown_s=15.0,
                       pipeline_binds=False)
    sched.sync()
    for i in range(6):
        p = mod.MakePod(f"p{i}").req({"cpu": "500m"}).obj()
        p.spec.preemption_policy = "Never"
        store.create("pods", p)
    trail = []
    for cycle in range(5):
        if cycle == 3:
            monkeypatch.undo()
            for i in range(6, 9):
                p = mod.MakePod(f"p{i}").req({"cpu": "500m"}).obj()
                p.spec.preemption_policy = "Never"
                store.create("pods", p)
        sched.run_until_idle()
        pods, _ = store.list("pods")
        trail.append((sched.breaker.describe(), sched._solve_path,
                      sorted(sched.queue.tracked_keys()) if port else None,
                      {p.metadata.name: p.spec.node_name for p in pods}))
        clock.step(11.0)
        sched.queue.flush_backoff_completed()
    return trail


def test_injected_solver_error_requeues_and_trips_breaker_like_jax(monkeypatch):
    want = _breaker_run(False, monkeypatch)
    got = _breaker_run(True, monkeypatch)
    assert [t[0] for t in got] == [t[0] for t in want]
    assert [t[1] for t in got] == [t[1] for t in want]
    assert [t[3] for t in got] == [t[3] for t in want]
    first = got[0]
    assert first[0]["failures_total"] == 1 and first[0]["state"] == "closed"
    assert len(first[2]) == 6  # every pod requeued into the backoff tier
    assert not any(first[3].values())  # nothing bound by the failing batch
    assert got[1][0]["state"] == "open" and got[1][0]["trips"] == 1
    # the open breaker degrades the next batch to the scan, which binds all
    assert got[2][0]["state"] == "open" and got[2][1] == "exact" and all(got[2][3].values())
    # after the cooldown one half-open probe of the fast path closes it
    assert got[3][0]["state"] == "closed" and got[3][0]["recoveries"] == 1
    assert got[3][1] == "fast" and all(got[3][3].values())


@pytest.mark.parametrize("solver", ["auction", "sinkhorn"])
def test_injected_transport_error_requeues_and_trips_breaker_like_jax(monkeypatch, solver):
    """A transport fault requeues the batch with backoff and trips the
    breaker to the scan; the half-open probe of the transport solver closes
    it again, crediting the transport path."""
    want = _breaker_run(False, monkeypatch, solver=solver)
    got = _breaker_run(True, monkeypatch, solver=solver)
    assert [t[0] for t in got] == [t[0] for t in want]
    assert [t[1] for t in got] == [t[1] for t in want]
    assert [t[3] for t in got] == [t[3] for t in want]
    assert got[0][1] == solver and len(got[0][2]) == 6 and not any(got[0][3].values())
    assert got[1][0]["state"] == "open" and got[1][0]["trips"] == 1
    assert got[2][1] == "exact" and all(got[2][3].values())
    assert got[3][0]["state"] == "closed" and got[3][0]["recoveries"] == 1
    assert got[3][1] == solver and all(got[3][3].values())


TRANSPORT_WORKLOADS = [w for w in PARITY_WORKLOADS
                       if w.__name__ in ("wl_basic_fit_spread", "wl_heterogeneous",
                                         "wl_node_selector_affinity")]


@pytest.mark.parametrize("solver", ["auction", "sinkhorn"])
@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_transport_modes_match_jax(workload, solver):
    """One batch: the transport solver's map equals JAX's; constrained
    batches and host-port batches run the scan in both packages."""
    want, jsched = run_pkg(workload, port=False, solver=solver)
    got, tsched = assert_same_placements(workload, solver=solver)
    assert tsched._solve_path == jsched._solve_path
    assert tsched._solve_path in (solver, "exact")
    assert tsched.breaker.failures_total == 0
    if tsched._solve_path == solver:
        assert tsched.transport_state.iterations == jsched.transport_state.iterations
        np.testing.assert_array_equal(tsched.transport_state.price,
                                      jsched.transport_state.price)
    else:
        assert tsched.transport_state is None and jsched.transport_state is None


@pytest.mark.parametrize("solver", ["auction", "sinkhorn"])
@pytest.mark.parametrize("workload", TRANSPORT_WORKLOADS, ids=lambda w: w.__name__)
def test_transport_modes_small_batches_match_jax(workload, solver):
    """Many small batches and create waves: the warm duals cross batches
    (remapped by node name) in both packages."""
    want, jsched = run_pkg(workload, port=False, solver=solver, batch_size=7, rounds=3)
    got, tsched = run_pkg(workload, port=True, solver=solver, batch_size=7, rounds=3)
    assert got == want
    assert tsched.batches_solved == jsched.batches_solved >= 3
    assert tsched.transport_state.iterations == jsched.transport_state.iterations
    if solver == "auction":
        np.testing.assert_array_equal(tsched.transport_state.price,
                                      jsched.transport_state.price)


def test_host_port_batch_declines_transport_to_the_scan_like_jax():
    host_ports = next(w for w in PARITY_WORKLOADS if w.__name__ == "wl_host_ports")
    for solver in ("auction", "sinkhorn"):
        got, tsched = assert_same_placements(host_ports, solver=solver)
        assert tsched._solve_path == "exact" and tsched.transport_state is None
        assert tsched.breaker.failures_total == 0


@pytest.mark.parametrize("solver", ["auction", "sinkhorn"])
def test_constrained_and_gang_batches_take_the_scan_under_transport(solver):
    """A PTS-constrained batch, and a gang batch, run the scan under the
    transport modes in both packages (same end states)."""
    from test_torch_gang import assert_same_end_state

    pts = next(w for w in PARITY_WORKLOADS if w.__name__ == "wl_pts_do_not_schedule")
    got, tsched = assert_same_placements(pts, solver=solver)
    assert tsched._solve_path == "exact" and tsched.transport_state is None

    def gang(env):
        env.nodes(6, cpu="8", slices=2)
        sched = env.make_sched()
        env.pg("train", 4)
        env.store.create_many("pods", env.gang_pods(4, "train"))
        env.drive()
        return sched._solve_path, sched.transport_state is None

    got_state, tenv = assert_same_end_state(gang, solver=solver)  # paths equal too
    assert len([v for v in got_state["placement"].values() if v]) == 4
    assert tenv.sched._solve_path == "exact" and tenv.sched.transport_state is None


def test_custom_framework_raises():
    """A port Framework is accepted; an object that is not one raises."""
    with pytest.raises(TypeError, match="Framework"):
        TBatch(TStore(), object(), device="cpu")


def test_store_contract():
    store = TStore()
    n = store.create("nodes", tt.MakeNode("n0").obj())
    p = store.create("pods", tt.MakePod("p").obj())
    assert p.metadata.resource_version > n.metadata.resource_version
    w = store.watch(kind="pods", since_rv=0)
    store.bind("default", "p", "n0")
    with pytest.raises(AlreadyBoundError):
        store.bind("default", "p", "n0")
    evs = w.drain()
    assert [e.type for e in evs] == ["ADDED", "MODIFIED"]
    rvs = [e.resource_version for e in evs]
    assert rvs == sorted(rvs) and len(set(rvs)) == 2
    assert store.get("pods", "default/p").spec.node_name == "n0"
    # any kind is stored, as in the JAX store (the lean store raised here)
    store.create("services", tt.MakePod("x").obj())
    jstore = JStore()
    jstore.create("services", jt.MakePod("x").obj())
    assert "services" in store.kinds() and "services" in jstore.kinds()
    assert store.get("services", "default/x").metadata.name == "x"
    created, errors = store.create_many("pods", [tt.MakePod("p").obj(), tt.MakePod("q").obj()])
    assert created == 1 and len(errors) == 1
    q = store.get("pods", "default/q")
    q.metadata.labels["x"] = "1"
    store.update("pods", q)
    with pytest.raises(ConflictError):
        store.update("pods", q)  # stale resource version
    store.delete("pods", "default/q")
    with pytest.raises(NotFoundError):
        store.get("pods", "default/q")
    assert [e.type for e in w.drain()] == ["ADDED", "MODIFIED", "DELETED"]


def test_zone_spread_respected_across_batches():
    store = TStore()
    for i in range(12):
        store.create("nodes", tt.MakeNode(f"n{i}").labels({ZONE: f"z{i % 4}"})
                     .capacity({"cpu": "8", "memory": "16Gi", "pods": "50"}).obj())
    sched = TBatch(store, device="cpu", batch_size=5)
    sched.sync()
    store.create_many("pods", [
        tt.MakePod(f"s{i}").labels({"app": "s"}).req({"cpu": "100m"})
        .topology_spread(1, ZONE, "DoNotSchedule", {"app": "s"}).obj() for i in range(23)])
    sched.run_until_idle()
    pods, _ = store.list("pods")
    zones = {}
    for p in pods:
        assert p.spec.node_name
        z = int(p.spec.node_name[1:]) % 4
        zones[z] = zones.get(z, 0) + 1
    assert max(zones.values()) - min(zones.values()) <= 1
    assert sched.batches_solved == 5
