"""Kernel J's redesign, on the CPU: the feasibility rows as one thread-block
cluster a row tile.

Kernel J (csrc/feasibility_rows.cu) runs a row on one thread-block cluster,
its nodes tiled over the cluster's 16 (or 8) CTAs, one node a thread; each
CTA reduces the two normalizer maxima over its feasible nodes, the cluster
merges them, and each thread finishes its nodes' totals. It runs the
host-port test only for a row whose class sets a port column. testing.feasibility_tiles_model is that
arithmetic in numpy (8 and 16 tiles, N no multiple of the tile); these tests
hold it equal to feasibility_rows_plain and to the JAX package's
feasibility_cost_matrices on seeded problems (testing.scan_problem: host
ports, classes without napref or taints, pods that fit nowhere, class ids
-1), and check kernels.feasibility_plan's layout. Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.scheduler  # noqa: F401  (import order: scheduler before snapshot)
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.parallel.sharded import feasibility_cost_matrices
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.ops.convert import solver_inputs_from_numpy

CPU = torch.device("cpu")


def _problem(seed, n, rows, wide_ports=False, no_ports=False, negative_cls=False):
    f, d_max = tt.scan_problem(seed, n, rows)
    rng = np.random.default_rng(seed + 100)
    if wide_ports:  # 300 port columns, one class setting most of them
        c = f["class_ports"].shape[0]
        f["class_ports"] = rng.random((c, 300)) < 0.1
        f["class_ports"][1] = rng.random(300) < 0.95
        f["node_ports"] = rng.random((n, 300)) < 0.004
    if no_ports:
        f["class_ports"][:] = False
    if negative_cls:
        f["class_of_pod"][::3] = -1
    return f, d_max


def _three_ways(f, d_max):
    """(plain feas, plain total), JAX's, on the same rows."""
    tinp = solver_inputs_from_numpy(f, CPU)
    tf, tc = tsolver.feasibility_rows_plain(tinp, tinp.req, tinp.req_nz, tinp.class_of_pod,
                                            tinp.balanced_active)
    jinp = jsolver.SolverInputs(**{k: (None if v is None else jnp.asarray(v))
                                   for k, v in f.items()})
    jf, jc = feasibility_cost_matrices(jinp, d_max)
    return (tf.numpy(), tc.numpy()), (np.asarray(jf), np.asarray(jc))


CASES = {
    "n37_rw1": dict(seed=1, n=37, rows=1),
    "n37_rw8": dict(seed=2, n=37, rows=8),
    "n1000_rw13": dict(seed=3, n=1000, rows=13),
    "n5001_rw8": dict(seed=4, n=5001, rows=8),
    "n5000_rw1": dict(seed=5, n=5000, rows=1),
    "n7_rw13": dict(seed=6, n=7, rows=13),
    "wide_ports": dict(seed=7, n=300, rows=13, wide_ports=True),
    "no_ports": dict(seed=8, n=300, rows=13, no_ports=True),
    "class_minus_one": dict(seed=9, n=300, rows=13, negative_cls=True),
}


@pytest.mark.parametrize("tiles", [8, 16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_model_matches_plain_and_jax(name, tiles):
    kw = dict(CASES[name])
    f, d_max = _problem(kw.pop("seed"), kw.pop("n"), kw.pop("rows"), **kw)
    (pf, pc), (jf, jc) = _three_ways(f, d_max)
    mf, mc, tile_max, port_rows = tt.feasibility_tiles_model(
        f, f["req"], f["req_nz"], f["class_of_pod"], f["balanced_active"], tiles=tiles)
    np.testing.assert_array_equal(mf, pf)
    np.testing.assert_array_equal(mc, pc)
    np.testing.assert_array_equal(mf, jf)
    np.testing.assert_array_equal(mc, jc)
    cls = np.maximum(f["class_of_pod"], 0)
    want_ports = [i for i in range(len(cls)) if f["class_ports"][cls[i]].any()]
    assert port_rows == want_ports
    if name == "no_ports":
        assert port_rows == []


def test_tiles_model_covers_empty_and_all_infeasible_tiles():
    """Tiles beyond N (N 37 over 16 tiles of 3) and a row nothing fits keep
    their maxima at 0, as where(feas, raw, 0).max() does."""
    f, _ = _problem(11, 37, 4)
    f["req"][2, 0] = 10**6  # row 2 fits nowhere
    mf, mc, tile_max, _ = tt.feasibility_tiles_model(
        f, f["req"], f["req_nz"], f["class_of_pod"], f["balanced_active"], tiles=16)
    assert (tile_max[:, 13:] == 0).all()
    assert not mf[2].any() and (tile_max[2] == 0).all()
    tinp = solver_inputs_from_numpy(f, CPU)
    pf, pc = tsolver.feasibility_rows_plain(tinp, tinp.req, tinp.req_nz, tinp.class_of_pod,
                                            tinp.balanced_active)
    np.testing.assert_array_equal(mf, pf.numpy())
    np.testing.assert_array_equal(mc, pc.numpy())


def _covered(plan, n):
    """Each node's owner (cluster rank, thread, j), checked to be unique."""
    cs, chunk, threads, npt = (plan["cluster_size"], plan["nodes_per_cta"], plan["threads"],
                               plan["nodes_per_thread"])
    seen = np.zeros(n, np.int64)
    for c in range(cs):
        end = min((c + 1) * chunk, n)
        for t in range(threads):
            for j in range(npt):
                node = c * chunk + t + j * threads
                if node < end:
                    seen[node] += 1
    return seen


@pytest.mark.parametrize("cs", [8, 16])
@pytest.mark.parametrize("rw,n,max_clusters", [
    (1, 37, 16), (8, 5000, 16), (13, 5001, 16), (512, 5000, 16), (8, 5000, 4),
    (1, 70000, 16), (3, 1, 16)])
def test_feasibility_plan_covers_every_node_and_row_once(rw, n, max_clusters, cs):
    plan = kernels.feasibility_plan(rw, n, 3, cs, max_clusters)
    assert 32 <= plan["threads"] <= kernels.FEAS_MAX_THREADS and plan["threads"] % 32 == 0
    assert (_covered(plan, n) == 1).all()
    assert plan["clusters"] == min(rw, max_clusters)
    assert plan["ctas"] == cs * plan["clusters"]
    clusters = plan["clusters"]
    rows = sorted(i for q in range(clusters) for i in range(q, rw, clusters))
    assert rows == list(range(rw))
    assert plan["passes"] == -(-rw // clusters)


def test_feasibility_plan_one_node_a_thread_at_the_main_path():
    """Transport's 5,000 nodes: 313 a CTA at 16 CTAs, one a thread; Rw 8 is
    eight clusters, Rw 1 one."""
    p8 = kernels.feasibility_plan(8, 5000, 3, 16, 16)
    assert (p8["nodes_per_cta"], p8["threads"], p8["nodes_per_thread"]) == (313, 320, 1)
    assert (p8["clusters"], p8["ctas"]) == (8, 128)
    assert p8["passes"] == 1
    assert kernels.feasibility_plan(1, 5000, 3, 16, 16)["clusters"] == 1
    p512 = kernels.feasibility_plan(512, 5000, 3, 16, 16)
    assert (p512["clusters"], p512["passes"]) == (16, 32)
    big = kernels.feasibility_plan(1, 70000, 3, 16, 16)
    assert big["nodes_per_thread"] > 1  # the global-memory path
