"""The port's transport solvers (models/transport.py, kernel J's rows in
ops/solver.py) against the JAX package's, on the CPU.

The same seeded inputs go through both packages: cluster/batch tensors are
built by the JAX tensorizer and carried across with ops/convert.py; the
random [G, N] problems are made with numpy and handed to both; a warm start
carries the reference's TransportState across as it is (the same fields and
host types: a float32 numpy price, node names, iterations).
Tolerances: exact equality for the feasibility/score rows, the group
problem, every auction output (x, price, level, rounds, the warm state),
round_plan, repair_plan, assignment_from_plan and transport_solve; Sinkhorn's
f, g and plan within a relative error of 1e-5 (|a - b| / max(|b|, 1e-6):
XLA:CPU's and torch's exp/log and reduction order may differ by ulps), with
the rounded integer plans and the per-pod maps equal on these workloads. The
tests of tests/test_transport.py (except the sharded one, ROADMAP.md queue 1
item 6) run on the port. Kernels E, F and J themselves are held against
these plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_workloads import MIXED_WORKLOADS, PARITY_WORKLOADS, unpack

import kubernetes_tpu.scheduler  # noqa: F401  (import order: scheduler before snapshot)
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.models import transport as jtr
from kubernetes_tpu.models.waterfill import make_groups as j_make_groups
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.parallel.sharded import feasibility_cost_matrices
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.snapshot.tensorizer import build_cluster_tensors as j_build_cluster
from kubernetes_tpu.snapshot.tensorizer import build_pod_batch as j_build_batch
from kubernetes_tpu.utils import FakeClock
from kubernetes_tpu_torch.models import transport as ttr
from kubernetes_tpu_torch.models.waterfill import make_groups as t_make_groups
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.ops.convert import solver_inputs_from_numpy
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.snapshot import tensorizer as ttz
from kubernetes_tpu_torch.store import APIStore as TStore
from kubernetes_tpu_torch.testing import transport_problem

CPU = torch.device("cpu")
PROBLEM_FIELDS = ("utility", "feasible", "jcap", "supply", "slots", "req", "alloc", "used")
# workloads whose batch the transport solvers take (constraint-free, no host ports)
TRANSPORT_WORKLOADS = [w for w in PARITY_WORKLOADS
                       if w.__name__ not in ("wl_host_ports", "wl_pts_do_not_schedule",
                                             "wl_pts_schedule_anyway",
                                             "wl_mixed_constraints_stress",
                                             "wl_interpod_anti_affinity")]


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-6)).max())


# ---------------------------------------------------------------------------
# inputs built by the JAX tensorizer, carried to the port
# ---------------------------------------------------------------------------


def both_inputs(nodes, pods, bound=()):
    """(jax inputs, port inputs, jax cluster, jax batch) for one batch."""
    cache = JCache(clock=FakeClock())
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = cache.update_snapshot()
    cluster = j_build_cluster(snap)
    batch = j_build_batch(pods, snap, cluster)
    jinp, _ = jsolver.make_inputs(cluster, batch)
    fields = {k: (None if v is None else np.asarray(v)) for k, v in jinp._asdict().items()}
    return jinp, solver_inputs_from_numpy(fields, CPU), cluster, batch


def workload_inputs(workload):
    return both_inputs(*unpack(workload(jt)))


def assert_same_problem(jp, tp):
    for f in PROBLEM_FIELDS:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert len(jp.members) == len(tp.members)
    for a, b in zip(jp.members, tp.members):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# kernel J's rows and the group problem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_feasibility_rows_match_jax(workload):
    """Every pod's row, as the reference's feasibility_cost_matrices vmaps
    pod_row_feasibility_score; and single rows through the port's
    pod_row_feasibility_score."""
    jinp, tinp, _, _ = workload_inputs(workload)
    jf, jc = feasibility_cost_matrices(jinp, 1)
    tf, tc = tsolver.feasibility_rows(tinp, tinp.req, tinp.req_nz, tinp.class_of_pod,
                                      tinp.balanced_active)
    assert tf.dtype == torch.bool and tc.dtype == torch.int32
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for p in (0, tinp.req.shape[0] - 1):
        rf, rc = tsolver.pod_row_feasibility_score(tinp, tinp.req[p], tinp.req_nz[p],
                                                   tinp.class_of_pod[p],
                                                   tinp.balanced_active[p])
        np.testing.assert_array_equal(rf.numpy(), np.asarray(jf)[p])
        np.testing.assert_array_equal(rc.numpy(), np.asarray(jc)[p])


def test_feasibility_rows_clamp_class_and_take_no_rows():
    jinp, tinp, _, _ = workload_inputs(PARITY_WORKLOADS[4])
    cls = torch.full((2,), -1, dtype=torch.int32)
    tf, tc = tsolver.feasibility_rows(tinp, tinp.req[:2], tinp.req_nz[:2], cls,
                                      tinp.balanced_active[:2])
    jf, jc = jsolver.pod_row_feasibility_score(jinp, jinp.req[0], jinp.req_nz[0], jnp.int32(-1),
                                               jinp.balanced_active[0])
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
    ef, ec = tsolver.feasibility_rows(tinp, tinp.req[:0], tinp.req_nz[:0], cls[:0],
                                      tinp.balanced_active[:0])
    assert ef.shape == (0, tinp.alloc.shape[0]) and ec.shape == ef.shape


@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_group_problem_matches_jax(workload):
    jinp, tinp, _, batch = workload_inputs(workload)
    groups = j_make_groups(batch)
    # the port's make_groups on the port's batch agrees with the reference's
    nodes, pods, bound = unpack(workload(tt))
    cache = TCache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = cache.update_snapshot()
    tcluster = ttz.build_cluster_tensors(snap)
    tgroups = t_make_groups(ttz.build_pod_batch(pods, snap, tcluster))
    assert [(m.tolist(), c) for m, c in tgroups] == [(m.tolist(), c) for m, c in groups]
    jp = jtr.build_group_problem(jinp, groups)
    tp = ttr.build_group_problem(tinp, groups)
    assert (jp is None) == (tp is None)
    if jp is not None:
        assert_same_problem(jp, tp)
        assert tp.utility.dtype == torch.float32 and tp.feasible.dtype == torch.bool


def test_group_problem_declines_host_ports_and_empty_batches():
    jinp, tinp, _, batch = workload_inputs(
        next(w for w in PARITY_WORKLOADS if w.__name__ == "wl_host_ports"))
    groups = j_make_groups(batch)
    assert jtr.build_group_problem(jinp, groups) is None
    assert ttr.build_group_problem(tinp, groups) is None
    assert ttr.build_group_problem(tinp, []) is None


# ---------------------------------------------------------------------------
# seeded [G, N] problems, made with numpy and handed to both packages
# ---------------------------------------------------------------------------


def run_phase_both(p, eps, max_rounds=400, price0=None):
    g, n = p["utility"].shape
    price0 = np.zeros(n, np.float32) if price0 is None else price0
    jx, jprice, jlevel, jrounds = jtr._auction_phase(
        jnp.asarray(p["utility"]), jnp.asarray(p["jcap"]), jnp.asarray(p["supply"]),
        jnp.asarray(p["slots"]), jnp.asarray(p["req"]), jnp.asarray(p["free"]),
        jnp.zeros((g, n), jnp.int32), jnp.asarray(price0), jnp.full((g, n), jtr.NEG_INF),
        jnp.float32(eps), max_rounds)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    tx, tprice, tlevel, trounds = ttr._auction_phase(
        t["utility"], t["jcap"], t["supply"], t["slots"], t["req"], t["free"],
        torch.zeros((g, n), dtype=torch.int32), torch.from_numpy(price0.copy()),
        torch.full((g, n), ttr.NEG_INF), eps, max_rounds)
    return (np.asarray(jx), np.asarray(jprice), np.asarray(jlevel), int(jrounds)), \
        (tx.numpy(), tprice.numpy(), tlevel.numpy(), trounds)


def assert_same_phase(want, got):
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32 and got[2].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]


PHASE_CASES = {
    "g3_n24": dict(g=3, n=24),
    "g5_n24_scarce": dict(g=5, n=24, scarce=True),
    "g3_n24_ties": dict(g=3, n=24, ties=True),
    "g1_n40_large_supply": dict(g=1, n=40, supply_hi=2000),
    "g5_n24_dead_group": dict(g=5, n=24, dead_group=True),
    "g2_n10_fewer_nodes_than_k": dict(g=2, n=10),
    "g8_n24_ties_scarce": dict(g=8, n=24, ties=True, scarce=True),
}


@pytest.mark.parametrize("eps", [40.0, 3.0, 0.9])
@pytest.mark.parametrize("case", sorted(PHASE_CASES))
def test_auction_phase_matches_jax(case, eps):
    p = transport_problem(sorted(PHASE_CASES).index(case), **PHASE_CASES[case])
    want, got = run_phase_both(p, eps)
    assert_same_phase(want, got)


@pytest.mark.parametrize("seed", range(3))
def test_auction_phase_warm_price_and_round_cut_match_jax(seed):
    p = transport_problem(100 + seed, g=3, n=24, ties=seed == 1)
    rng = np.random.default_rng(seed)
    price0 = rng.integers(0, 300, size=24).astype(np.float32)
    assert_same_phase(*run_phase_both(p, 5.0, price0=price0))
    want, got = run_phase_both(p, 0.9, max_rounds=2)  # the max_rounds cut
    assert_same_phase(want, got)
    assert got[3] <= 2


def test_auction_phase_equal_levels_keep_holders_first():
    """Two groups of one unit each, equal utilities and one slot: the
    second round's bid ties the holder's level and the holder keeps it."""
    p = dict(utility=np.full((2, 1), 7.0, np.float32), feasible=np.ones((2, 1), bool),
             jcap=np.ones((2, 1), np.int32), supply=np.ones(2, np.int32),
             slots=np.ones(1, np.int32), req=np.full((2, 2), 100, np.int32),
             free=np.full((1, 2), 1000, np.int32))
    want, got = run_phase_both(p, 1.0, max_rounds=6)
    assert_same_phase(want, got)
    assert got[0].sum() == 1


# ---------------------------------------------------------------------------
# auction_solve, cold and warm
# ---------------------------------------------------------------------------


def make_cluster(m, n_nodes=12, cpu="8", mem="16Gi"):
    return [m.MakeNode(f"n{i}").capacity({"cpu": cpu, "memory": mem, "pods": "110"}).obj()
            for i in range(n_nodes)]


def assert_same_state(want, got):
    assert got.price.dtype == np.float32
    np.testing.assert_array_equal(got.price, want.price)
    assert got.node_names == tuple(want.node_names)
    assert got.iterations == want.iterations


@pytest.mark.parametrize("workload", TRANSPORT_WORKLOADS, ids=lambda w: w.__name__)
def test_auction_solve_matches_jax(workload):
    jinp, tinp, cluster, batch = workload_inputs(workload)
    groups = j_make_groups(batch)
    jp = jtr.build_group_problem(jinp, groups)
    tp = ttr.build_group_problem(tinp, groups)
    jx, js = jtr.auction_solve(jp, node_names=cluster.node_names)
    tx, ts = ttr.auction_solve(tp, node_names=cluster.node_names)
    assert tx.dtype == np.int32
    np.testing.assert_array_equal(tx, np.asarray(jx))
    assert_same_state(js, ts)


def test_auction_solve_warm_start_from_reference_state_matches_jax():
    """Both packages warm-start from the reference's cold duals after churn
    (two nodes gone, three new): the remapped prices, x and the new state
    are equal."""
    pods = [jt.MakePod(f"p{i}").req({"cpu": "1", "memory": "2Gi"}).obj() for i in range(20)]
    nodes = make_cluster(jt, 10)
    jinp, tinp, cluster, batch = both_inputs(nodes, pods)
    jp = jtr.build_group_problem(jinp, j_make_groups(batch))
    _, cold = jtr.auction_solve(jp, node_names=cluster.node_names)
    assert isinstance(cold.price, np.ndarray) and cold.price.dtype == np.float32
    carried = ttr.TransportState(*cold)
    np.testing.assert_array_equal(ttr._remap_price(carried, cluster.node_names),
                                  jtr._remap_price(cold, cluster.node_names))
    nodes2 = nodes[2:] + make_cluster(jt, 3, cpu="16")
    for i, n in enumerate(nodes2[-3:]):
        n.metadata.name = f"new{i}"
    jinp2, tinp2, cluster2, batch2 = both_inputs(nodes2, pods)
    groups2 = j_make_groups(batch2)
    jp2 = jtr.build_group_problem(jinp2, groups2)
    tp2 = ttr.build_group_problem(tinp2, groups2)
    jx, jwarm = jtr.auction_solve(jp2, state=cold, node_names=cluster2.node_names)
    tx, twarm = ttr.auction_solve(tp2, state=carried, node_names=cluster2.node_names)
    np.testing.assert_array_equal(tx, np.asarray(jx))
    assert_same_state(jwarm, twarm)


# ---------------------------------------------------------------------------
# sinkhorn
# ---------------------------------------------------------------------------


SINKHORN_CASES = {
    "ample": dict(g=3, n=24),
    "scarce": dict(g=5, n=24, scarce=True, supply_hi=200),
    "all_infeasible_row": dict(g=4, n=24, dead_group=True),
    "one_group": dict(g=1, n=40, supply_hi=500),
}


def sinkhorn_both(p, cap, f0, g0, iters):
    jout = jtr._sinkhorn_iters(jnp.asarray(p["utility"]), jnp.asarray(p["feasible"]),
                               jnp.asarray(p["supply"]), jnp.asarray(cap), jnp.asarray(f0),
                               jnp.asarray(g0), jnp.float32(2.0), iters)
    tout = ttr._sinkhorn_iters(*(torch.from_numpy(np.array(a)) for a in (
        p["utility"], p["feasible"], p["supply"], cap, f0, g0)), 2.0, iters)
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("case", sorted(SINKHORN_CASES))
def test_sinkhorn_iters_match_jax(case, warm):
    """f and g after 60 iterations within 1e-5; the plan from the same duals
    within 1e-5; the 60-iteration plan within 1e-4; the rounded integer
    plans equal. XLA:CPU's exp/log and torch's differ by an ulp on ~10% /
    ~1% of arguments, so the duals may drift by a few ulps over the
    iterations; the plan's exp turns a dual's drift d into a relative error
    of ~d / eps (on the warm scarce case, g ~ 100 drifts by ~8 ulps, 6e-5,
    and the 60-iteration plans differ by 1.5e-5 relative; PERF.md
    section 7)."""
    p = transport_problem(7 + sorted(SINKHORN_CASES).index(case), **SINKHORN_CASES[case])
    rng = np.random.default_rng(3)
    g, n = p["utility"].shape
    cap = np.maximum(p["slots"].astype(np.float32) - rng.random(n).astype(np.float32), 0)
    g0 = (rng.random(n) * 50).astype(np.float32) if warm else np.zeros(n, np.float32)
    f0 = np.zeros(g, np.float32)
    (jf, jg, jplan), (tf, tg, tplan) = sinkhorn_both(p, cap, f0, g0, 60)
    assert tf.dtype == tg.dtype == tplan.dtype == np.float32
    assert rel_err(tf, jf) <= 1e-5
    assert rel_err(tg, jg) <= 1e-5
    assert rel_err(tplan, jplan) <= 1e-4
    (_, _, jplan0), (tf0, tg0, tplan0) = sinkhorn_both(p, cap, jf, jg, 0)
    np.testing.assert_array_equal(tf0, jf)  # zero iterations hand the duals back
    np.testing.assert_array_equal(tg0, jg)
    assert rel_err(tplan0, jplan0) <= 1e-5
    jp = jtr.GroupProblem(utility=None, feasible=None, jcap=jnp.asarray(p["jcap"]),
                          supply=jnp.asarray(p["supply"]), slots=jnp.asarray(p["slots"]),
                          req=None, alloc=None, used=None, members=())
    tp = ttr.GroupProblem(utility=None, feasible=None, jcap=torch.from_numpy(p["jcap"]),
                          supply=torch.from_numpy(p["supply"]), slots=torch.from_numpy(p["slots"]),
                          req=None, alloc=None, used=None, members=())
    np.testing.assert_array_equal(ttr.round_plan(tp, tplan), jtr.round_plan(jp, jplan))


@pytest.mark.parametrize("workload", TRANSPORT_WORKLOADS, ids=lambda w: w.__name__)
def test_sinkhorn_solve_and_round_plan_match_jax(workload):
    jinp, tinp, cluster, batch = workload_inputs(workload)
    groups = j_make_groups(batch)
    jp = jtr.build_group_problem(jinp, groups)
    tp = ttr.build_group_problem(tinp, groups)
    np.testing.assert_allclose(ttr._effective_cap(tp).numpy(), np.asarray(jtr._effective_cap(jp)),
                               rtol=1e-6)
    jfrac, js = jtr.sinkhorn_solve(jp, node_names=cluster.node_names)
    tfrac, ts = ttr.sinkhorn_solve(tp, node_names=cluster.node_names)
    assert rel_err(tfrac, jfrac) <= 1e-5
    assert rel_err(ts.price, js.price) <= 1e-5
    assert ts.iterations == js.iterations == 60 and ts.node_names == tuple(js.node_names)
    # the integer plans agree: no ulp of the plan crosses a rounding line here
    np.testing.assert_array_equal(ttr.round_plan(tp, tfrac), jtr.round_plan(jp, jfrac))


# ---------------------------------------------------------------------------
# host rounding, repair and assignment on the same numpy inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_round_repair_assign_match_jax_on_same_inputs(seed):
    """round_plan, repair_plan and assignment_from_plan take the same
    fractional and integer plans in both packages (plans over-filling
    supply, slots and resources on purpose)."""
    p = transport_problem(200 + seed, g=4, n=16, scarce=seed % 2 == 1, supply_hi=80)
    rng = np.random.default_rng(seed)
    g, n = p["utility"].shape
    alloc = rng.integers(1000, 9000, size=(n, 3)).astype(np.int32)
    used = (alloc - p["free"]).astype(np.int32)
    members = []
    start = 0
    for s in p["supply"].tolist():
        members.append(np.arange(start, start + s))
        start += s
    jp = jtr.GroupProblem(utility=jnp.asarray(p["utility"]), feasible=jnp.asarray(p["feasible"]),
                          jcap=jnp.asarray(p["jcap"]), supply=jnp.asarray(p["supply"]),
                          slots=jnp.asarray(p["slots"]), req=jnp.asarray(p["req"]),
                          alloc=jnp.asarray(alloc), used=jnp.asarray(used),
                          members=tuple(members))
    tp = ttr.GroupProblem(utility=torch.from_numpy(p["utility"]),
                          feasible=torch.from_numpy(p["feasible"]),
                          jcap=torch.from_numpy(p["jcap"]), supply=torch.from_numpy(p["supply"]),
                          slots=torch.from_numpy(p["slots"]), req=torch.from_numpy(p["req"]),
                          alloc=torch.from_numpy(alloc), used=torch.from_numpy(used),
                          members=tuple(members))
    frac = (rng.random((g, n)) * 6).astype(np.float32)
    np.testing.assert_array_equal(ttr.round_plan(tp, frac.copy()), jtr.round_plan(jp, frac.copy()))
    x = rng.integers(0, 8, size=(g, n)).astype(np.int32)
    jx, tx = jtr.repair_plan(jp, x.copy()), ttr.repair_plan(tp, x.copy())
    assert tx.dtype == np.int32
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ttr.assignment_from_plan(tp, tx, start),
                                  jtr.assignment_from_plan(jp, jx, start))


@pytest.mark.parametrize("method", ["auction", "sinkhorn"])
@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_transport_solve_matches_jax(workload, method):
    jinp, tinp, cluster, batch = workload_inputs(workload)
    groups = j_make_groups(batch)
    want = jtr.transport_solve(jinp, groups, method=method, node_names=cluster.node_names)
    got = ttr.transport_solve(tinp, groups, method=method, node_names=cluster.node_names)
    assert (want is None) == (got is None)
    if want is None:
        return
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1].iterations == want[1].iterations
    if method == "auction":
        assert_same_state(want[1], got[1])


def test_transport_over_a_mesh_names_its_roadmap_item():
    _, tinp, cluster, batch = workload_inputs(PARITY_WORKLOADS[0])
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        ttr.transport_solve(tinp, j_make_groups(batch), mesh=object())


@pytest.mark.parametrize("seed", range(8))
def test_seeded_transport_property_matches_jax(seed):
    """Seeded clusters and batches of several request shapes and a node
    selector: both methods give the reference's per-pod map, never
    over-commit, and keep selector pods on labelled nodes."""
    rng = np.random.default_rng(1000 + seed)
    n_nodes = int(rng.integers(5, 30))
    nodes = [jt.MakeNode(f"n{i}").labels({"disk": "ssd" if i % 2 == 0 else "hdd"}).capacity(
        {"cpu": str(int(rng.choice([2, 4, 8, 16]))), "memory": f"{int(rng.choice([4, 8, 32]))}Gi",
         "pods": str(int(rng.choice([4, 20, 110])))}).obj() for i in range(n_nodes)]
    shapes = [("100m", "128Mi"), ("250m", "512Mi"), ("500m", "1Gi"), ("1000m", "2Gi")]
    pods = []
    for i in range(int(rng.integers(10, 120))):
        cpu, mem = shapes[int(rng.integers(0, len(shapes)))]
        b = jt.MakePod(f"p{i}").req({"cpu": cpu, "memory": mem})
        if rng.random() < 0.25:
            b = b.node_selector({"disk": "ssd"})
        pods.append(b.obj())
    jinp, tinp, cluster, batch = both_inputs(nodes, pods)
    groups = j_make_groups(batch)
    for method in ("auction", "sinkhorn"):
        want, _ = jtr.transport_solve(jinp, groups, method=method, node_names=cluster.node_names)
        got, _ = ttr.transport_solve(tinp, groups, method=method, node_names=cluster.node_names)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=method)
        check_valid(tinp, got)
        for j, p in enumerate(pods):
            if p.spec.node_selector and got[j] >= 0:
                assert got[j] % 2 == 0


# ---------------------------------------------------------------------------
# tests/test_transport.py, run on the port
# ---------------------------------------------------------------------------


def port_problem_inputs(nodes, pods):
    cache = TCache()
    for n in nodes:
        cache.add_node(n)
    snap = cache.update_snapshot()
    cluster = ttz.build_cluster_tensors(snap)
    batch = ttz.build_pod_batch(pods, snap, cluster)
    inputs, d_max = tsolver.make_inputs(cluster, batch, device="cpu")
    return inputs, d_max, cluster, batch


def check_valid(inputs, assignment):
    """No capacity/pod-count violation under exact integer arithmetic."""
    a = np.asarray(assignment)
    alloc = inputs.alloc.numpy().astype(np.int64)
    used = inputs.used.numpy().astype(np.int64).copy()
    cnt = inputs.pod_count.numpy().astype(np.int64).copy()
    maxp = inputs.max_pods.numpy().astype(np.int64)
    req = inputs.req.numpy().astype(np.int64)
    for p, n in enumerate(a):
        if n < 0:
            continue
        used[n] += req[p]
        cnt[n] += 1
    assert (used <= alloc).all(), "resource over-commit"
    assert (cnt <= maxp).all(), "pod-count over-commit"


def total_utility(inputs, assignment):
    _, c = tsolver.feasibility_rows(inputs, inputs.req, inputs.req_nz, inputs.class_of_pod,
                                    inputs.balanced_active)
    c = c.numpy()
    return sum(int(c[p, n]) for p, n in enumerate(np.asarray(assignment)) if n >= 0)


def test_port_auction_places_all_when_capacity_ample():
    pods = [tt.MakePod(f"p{i}").req({"cpu": "1", "memory": "2Gi"}).obj() for i in range(30)]
    inputs, _, cluster, batch = port_problem_inputs(make_cluster(tt), pods)
    out = ttr.transport_solve(inputs, t_make_groups(batch), method="auction",
                              node_names=cluster.node_names)
    assert out is not None
    a, state = out
    assert (a >= 0).all()
    check_valid(inputs, a)
    assert state.iterations > 0


def test_port_auction_utility_close_to_greedy():
    pods = [tt.MakePod(f"a{i}").req({"cpu": "2", "memory": "4Gi"}).obj() for i in range(8)]
    pods += [tt.MakePod(f"b{i}").req({"cpu": "1", "memory": "1Gi"}).obj() for i in range(12)]
    inputs, d_max, cluster, batch = port_problem_inputs(make_cluster(tt, 8), pods)
    scan, _, _ = tsolver.greedy_scan_solve(inputs, d_max)
    a, _ = ttr.transport_solve(inputs, t_make_groups(batch), method="auction",
                               node_names=cluster.node_names)
    check_valid(inputs, a)
    assert (a >= 0).sum() == (scan.numpy() >= 0).sum()
    assert total_utility(inputs, a) >= 0.95 * total_utility(inputs, scan.numpy())


def test_port_auction_respects_scarce_capacity():
    nodes = [tt.MakeNode(f"n{i}").capacity({"cpu": "2", "pods": "110"}).obj() for i in range(3)]
    pods = [tt.MakePod(f"p{i}").req({"cpu": "1500m"}).obj() for i in range(6)]
    inputs, _, cluster, batch = port_problem_inputs(nodes, pods)
    a, _ = ttr.transport_solve(inputs, t_make_groups(batch), method="auction",
                               node_names=cluster.node_names)
    check_valid(inputs, a)
    assert (a >= 0).sum() == 3


def test_port_sinkhorn_places_and_respects_capacity():
    pods = [tt.MakePod(f"p{i}").req({"cpu": "1", "memory": "2Gi"}).obj() for i in range(20)]
    inputs, _, cluster, batch = port_problem_inputs(make_cluster(tt, 6, cpu="4", mem="8Gi"), pods)
    a, _ = ttr.transport_solve(inputs, t_make_groups(batch), method="sinkhorn",
                               node_names=cluster.node_names)
    check_valid(inputs, a)
    assert (a >= 0).sum() == 20


def test_port_heterogeneous_node_selector_groups():
    nodes = [tt.MakeNode(f"n{i}").labels({"disk": "ssd" if i % 2 == 0 else "hdd"})
             .capacity({"cpu": "8", "memory": "16Gi", "pods": "110"}).obj() for i in range(6)]
    pods = [tt.MakePod(f"ssd{i}").node_selector({"disk": "ssd"}).req({"cpu": "1"}).obj()
            for i in range(6)]
    pods += [tt.MakePod(f"any{i}").req({"cpu": "500m", "memory": "1Gi"}).obj() for i in range(8)]
    inputs, _, cluster, batch = port_problem_inputs(nodes, pods)
    for method in ("auction", "sinkhorn"):
        a, _ = ttr.transport_solve(inputs, t_make_groups(batch), method=method,
                                   node_names=cluster.node_names)
        check_valid(inputs, a)
        for j in range(6):
            assert a[j] >= 0 and a[j] % 2 == 0, (method, j, a[j])
        assert (a >= 0).all()


def test_port_warm_start_carries_prices_across_churn():
    nodes = make_cluster(tt, 10)
    pods = [tt.MakePod(f"p{i}").req({"cpu": "1", "memory": "2Gi"}).obj() for i in range(20)]
    inputs, _, cluster, batch = port_problem_inputs(nodes, pods)
    problem = ttr.build_group_problem(inputs, t_make_groups(batch))
    _, cold = ttr.auction_solve(problem, node_names=cluster.node_names)
    nodes2 = nodes[2:] + make_cluster(tt, 3, cpu="16")[:3]
    for i, n in enumerate(nodes2[-3:]):
        n.metadata.name = f"new{i}"
    inputs2, _, cluster2, batch2 = port_problem_inputs(nodes2, pods)
    problem2 = ttr.build_group_problem(inputs2, t_make_groups(batch2))
    x_warm, warm = ttr.auction_solve(problem2, state=cold, node_names=cluster2.node_names)
    x2 = ttr.repair_plan(problem2, x_warm)
    a = ttr.assignment_from_plan(problem2, x2, len(pods))
    check_valid(inputs2, a)
    assert (a >= 0).all()
    assert warm.price.shape == (len(nodes2),)


def test_port_round_plan_respects_caps():
    pods = [tt.MakePod(f"p{i}").req({"cpu": "1"}).obj() for i in range(12)]
    inputs, _, cluster, batch = port_problem_inputs(make_cluster(tt, 4, cpu="3"), pods)
    problem = ttr.build_group_problem(inputs, t_make_groups(batch))
    frac, _ = ttr.sinkhorn_solve(problem, node_names=cluster.node_names)
    x = ttr.round_plan(problem, frac)
    assert (x.sum(axis=0) <= problem.slots.numpy()).all()
    assert (x <= problem.jcap.numpy()).all()
    x = ttr.repair_plan(problem, x)
    check_valid(inputs, ttr.assignment_from_plan(problem, x, len(pods)))


@pytest.mark.parametrize("solver,n_nodes,cpu,mem,n_pods", [
    ("auction", 8, "8", "16Gi", 24), ("sinkhorn", 6, "4", "8Gi", 12)])
def test_port_batch_scheduler_transport_end_to_end(solver, n_nodes, cpu, mem, n_pods):
    store = TStore()
    for i in range(n_nodes):
        store.create("nodes", tt.MakeNode(f"n{i}")
                     .capacity({"cpu": cpu, "memory": mem, "pods": "110"}).obj())
    for i in range(n_pods):
        store.create("pods", tt.MakePod(f"p{i}").req({"cpu": "1", "memory": "1Gi"}).obj())
    sched = TBatch(store, device="cpu", solver=solver)
    sched.sync()
    sched.run_until_idle()
    bound = [p for p in store.list("pods")[0] if p.spec.node_name]
    assert len(bound) == n_pods
    assert sched.transport_state is not None and sched._solve_path == solver


def test_port_host_ports_fall_back_from_transport():
    pods = [tt.MakePod(f"p{i}").req({"cpu": "1"}, host_port=8080).obj() for i in range(4)]
    inputs, _, _, batch = port_problem_inputs(make_cluster(tt, 4), pods)
    assert ttr.build_group_problem(inputs, t_make_groups(batch)) is None
    store = TStore()
    for n in make_cluster(tt, 4):
        store.create("nodes", n)
    for i in range(4):
        store.create("pods", tt.MakePod(f"p{i}").req({"cpu": "1"}, host_port=8080).obj())
    sched = TBatch(store, device="cpu", solver="auction")
    sched.sync()
    sched.run_until_idle()
    bound = [p for p in store.list("pods")[0] if p.spec.node_name]
    assert len(bound) == 4
    assert len({p.spec.node_name for p in bound}) == 4
    assert sched._solve_path == "exact" and sched.transport_state is None


def test_port_auction_single_group_large_supply():
    nodes = [tt.MakeNode(f"n{i}").labels({"kubernetes.io/hostname": f"n{i}"}).capacity(
        {"cpu": "16", "memory": "64Gi", "pods": "110"}).obj() for i in range(50)]
    pods = [tt.MakePod(f"p{i}").req({"cpu": "1", "memory": "1Gi"}).obj() for i in range(800)]
    inputs, _, cluster, batch = port_problem_inputs(nodes, pods)
    a, _ = ttr.transport_solve(inputs, t_make_groups(batch), method="auction",
                               node_names=cluster.node_names)
    assert int((a >= 0).sum()) == 800
