"""The port's greedy-scan solver against the JAX package's, on the CPU.

Inputs are built once by the JAX tensorizer and carried across with
kubernetes_tpu_torch.ops.convert, so both solvers see the same tensors.
Tolerance: exact equality of every int32 output (assignment, used,
pod_count) and of every formula helper, on every workload of
tests/test_batch_parity.py (tests/test_torch_workloads.py) and on seeded
mixed workloads, under every gate combination. Kernel A itself is held
against the plain version on the card in tests/test_torch_gpu.py.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_workloads import (MIXED_WORKLOADS, PARITY_WORKLOADS, unpack,
                                  wl_mixed_constraints_stress, wl_overcommit)

import kubernetes_tpu.scheduler  # noqa: F401  (import order: scheduler before snapshot)
import kubernetes_tpu.testing as jt
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.snapshot.tensorizer import build_cluster_tensors as j_build_cluster
from kubernetes_tpu.snapshot.tensorizer import build_pod_batch as j_build_batch
from kubernetes_tpu.utils import FakeClock
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.ops.convert import solver_inputs_from_numpy

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# JAX-built inputs carried to the port
# ---------------------------------------------------------------------------


def jax_inputs(workload, gang_seed=None):
    """JAX tensorizer -> JAX SolverInputs; returns (jax inputs, d_max, gates,
    numpy fields). gang_seed adds a synthetic per-(class, node) bonus row."""
    nodes, pods, bound = unpack(workload(jt))
    cache = JCache(clock=FakeClock())
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = cache.update_snapshot()
    cluster = j_build_cluster(snap)
    batch = j_build_batch(pods, snap, cluster)
    inp, d_max = jsolver.make_inputs(cluster, batch)
    gates = dict(has_ipa=bool(batch.ipa.has_any), has_ct=bool(batch.ct_class.size),
                 has_st=bool(batch.st_class.size), has_gang=False)
    if gang_seed is not None:
        rng = np.random.default_rng(gang_seed)
        bonus = rng.integers(0, 40, size=np.asarray(inp.filter_ok).shape).astype(np.int32)
        inp = inp._replace(gang_bonus=jnp.asarray(bonus))
        gates["has_gang"] = True
    fields = {k: (None if v is None else np.asarray(v)) for k, v in inp._asdict().items()}
    return inp, d_max, gates, fields


def assert_same_solve(inp, d_max, gates, fields):
    ja, jused, jcount = jsolver.greedy_scan_solve(inp, d_max, **gates)
    tinp = solver_inputs_from_numpy(fields, CPU)
    ta, tused, tcount = tsolver.greedy_scan_solve_plain(tinp, d_max, **gates)
    assert ta.dtype == torch.int32 and tused.dtype == torch.int32 and tcount.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tused.numpy(), np.asarray(jused))
    np.testing.assert_array_equal(tcount.numpy(), np.asarray(jcount))
    return ta


@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_plain_scan_matches_jax(workload):
    inp, d_max, gates, fields = jax_inputs(workload)
    assert_same_solve(inp, d_max, gates, fields)


@pytest.mark.parametrize("gates", list(itertools.product([False, True], repeat=4)),
                         ids=lambda g: "ipa{}-ct{}-st{}-gang{}".format(*map(int, g)))
def test_every_gate_combination_matches_jax(gates):
    """Both solvers agree under every static gate setting, on a workload
    whose tables populate all four families."""
    inp, d_max, _, fields = jax_inputs(MIXED_WORKLOADS[0], gang_seed=3)
    has = dict(zip(("has_ipa", "has_ct", "has_st", "has_gang"), gates))
    if not has["has_gang"]:
        inp = inp._replace(gang_bonus=None)
        fields = dict(fields, gang_bonus=None)
    assert_same_solve(inp, d_max, has, fields)


def test_greedy_scan_solve_dispatches_cpu_tensors_to_plain():
    inp, d_max, gates, fields = jax_inputs(wl_mixed_constraints_stress)
    tinp = solver_inputs_from_numpy(fields, CPU)
    a = tsolver.greedy_scan_solve(tinp, d_max, **gates)
    b = tsolver.greedy_scan_solve_plain(tinp, d_max, **gates)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_unplaceable_pod_is_minus_one():
    inp, d_max, gates, fields = jax_inputs(wl_overcommit)
    a = assert_same_solve(inp, d_max, gates, fields)
    assert sorted(a.tolist()) == [-1, -1, -1, 0, 1, 2]


def test_make_inputs_defaults_to_cuda():
    """The entry point defaults to the card and raises without one (decided
    here, at run time)."""
    from kubernetes_tpu_torch.ops.solver import make_inputs

    if torch.cuda.is_available():
        assert tsolver.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make_inputs(None, None)


# ---------------------------------------------------------------------------
# formula helpers, one by one
# ---------------------------------------------------------------------------


def _rng_i32(rng, lo, hi, shape):
    return rng.integers(lo, hi, size=shape).astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_fit_feasible(seed):
    rng = np.random.default_rng(seed)
    alloc = _rng_i32(rng, 0, 9000, (64, 4))
    used = _rng_i32(rng, 0, 9000, (64, 4))
    count = _rng_i32(rng, 0, 12, 64)
    maxp = _rng_i32(rng, 0, 12, 64)
    req = _rng_i32(rng, 0, 3000, 4)
    req[1] = 0  # a zero request always fits
    want = jsolver.fit_feasible(*map(jnp.asarray, (alloc, used, count, maxp, req)))
    got = tsolver.fit_feasible(*map(torch.from_numpy, (alloc, used, count, maxp, req)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_least_allocated_score(seed):
    rng = np.random.default_rng(seed)
    alloc = _rng_i32(rng, 0, 40000, (64, 2))
    alloc[:4] = 0  # zero-capacity columns are excluded from the mean
    used = _rng_i32(rng, 0, 40000, (64, 2))
    req = _rng_i32(rng, 0, 4000, 2)
    want = jsolver.least_allocated_score(*map(jnp.asarray, (alloc, used, req)))
    got = tsolver.least_allocated_score(*map(torch.from_numpy, (alloc, used, req)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,active", [(0, True), (1, True), (2, False)])
def test_balanced_score(seed, active):
    rng = np.random.default_rng(seed)
    alloc = _rng_i32(rng, 0, 40000, (128, 2))
    alloc[:8, 1] = 0  # one resource missing: std is 0
    used = _rng_i32(rng, 0, 40000, (128, 2))
    req = _rng_i32(rng, 0, 4000, 2)
    want = jsolver.balanced_score(*map(jnp.asarray, (alloc, used, req)), jnp.asarray(active))
    got = tsolver.balanced_score(*map(torch.from_numpy, (alloc, used, req)),
                                 torch.tensor(active))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", ["random", "all_zero", "negative", "wraps"])
def test_default_normalize(case, reverse):
    """Includes negative raw values (floor division) and raw values where
    MAX_NODE_SCORE * raw wraps around int32, as it does under XLA."""
    rng = np.random.default_rng(7)
    raw = {"random": _rng_i32(rng, 0, 300, 50), "all_zero": np.zeros(50, np.int32),
           "negative": _rng_i32(rng, -300, 300, 50),
           "wraps": _rng_i32(rng, 20_000_000, 40_000_000, 50)}[case]
    feas = rng.random(50) < 0.7
    want = jsolver.default_normalize(jnp.asarray(raw), jnp.asarray(feas), reverse)
    got = tsolver.default_normalize(torch.from_numpy(raw), torch.from_numpy(feas), reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(2))
def test_pts_counts_and_domain_valid(seed):
    rng = np.random.default_rng(seed)
    n, d_max = 40, 6
    topo = _rng_i32(rng, -1, d_max - 1, n)
    aff = rng.random(n) < 0.7
    dyn = _rng_i32(rng, 0, 5, (3, n))
    want_c = jsolver.pts_counts(jnp.asarray(aff), jnp.asarray(dyn), jnp.asarray(topo), 1, d_max)
    got_c = tsolver.pts_counts(torch.from_numpy(aff), torch.from_numpy(dyn),
                               torch.from_numpy(topo), 1, d_max)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    want_v = jsolver.pts_domain_valid(jnp.asarray(aff), jnp.asarray(topo), d_max)
    got_v = tsolver.pts_domain_valid(torch.from_numpy(aff), torch.from_numpy(topo), d_max)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("seed,n,p,kw", [
    (0, 1, 6, {}), (1, 7, 30, {}), (2, 40, 50, {}), (3, 60, 40, {"hostname": False}),
    (4, 30, 40, {"identical": True})], ids=["n1", "n7", "n40_hostname", "n60_zones",
                                            "identical"])
def test_plain_scan_matches_jax_on_seeded_problems(seed, n, p, kw):
    """The seeded synthetic problems kernel A's card tests use
    (testing.scan_problem: every constraint family, pods that fit nowhere,
    identical nodes) give the same solve in the plain version and the JAX
    package."""
    f, d_max = tt.scan_problem(seed, n, p, **kw)
    gates = dict(has_ipa=True, has_ct=True, has_st=True, has_gang=f["gang_bonus"] is not None)
    inp = jsolver.SolverInputs(**{k: (None if v is None else jnp.asarray(v))
                                  for k, v in f.items()})
    assert_same_solve(inp, d_max, gates, f)
