"""The port's propose-and-repair solver (models/repair.py) against the JAX
package's, on the CPU.

- repair_check_plain vs the JAX repair_check on seeded random placements of
  constrained workloads, under all four gate combinations (the same numpy
  arguments handed to both);
- _RepairContext.class_mask / soft_row for every class, before and after
  seeded count bumps;
- repair_solve's assignment and RepairStats.as_dict() on the workloads of
  tests/test_repair.py (rebuilt here in both packages) and on the seeded
  mixed workloads, each package through its own tensorizer.
Tolerance: exact equality. Kernel D itself is held against the plain version
on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_workloads import (MIXED_WORKLOADS, placed_check_case, unpack,
                                  wl_interpod_anti_affinity, wl_mixed_constraints_stress,
                                  wl_pts_do_not_schedule, wl_repair_kinds)

import kubernetes_tpu.scheduler  # noqa: F401  (import order: scheduler before snapshot)
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.api.labels import Selector as JSelector
from kubernetes_tpu.api.types import Affinity as JAffinity
from kubernetes_tpu.api.types import PodAffinityTerm as JTerm
from kubernetes_tpu.models import repair as jrep
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.snapshot import tensorizer as jtz
from kubernetes_tpu.utils import FakeClock
from kubernetes_tpu_torch.api import Affinity as TAffinity
from kubernetes_tpu_torch.api import PodAffinityTerm as TTerm
from kubernetes_tpu_torch.api import Selector as TSelector
from kubernetes_tpu_torch.models import repair as trep
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.snapshot import tensorizer as ttz

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"
JAX_API = types.SimpleNamespace(m=jt, Selector=JSelector, Affinity=JAffinity, Term=JTerm)
PORT_API = types.SimpleNamespace(m=tt, Selector=TSelector, Affinity=TAffinity, Term=TTerm)

# ---------------------------------------------------------------------------
# repair_check
# ---------------------------------------------------------------------------

CHECK_WORKLOADS = [wl_repair_kinds, wl_interpod_anti_affinity, wl_pts_do_not_schedule,
                   wl_mixed_constraints_stress] + MIXED_WORKLOADS


@pytest.mark.parametrize("has_affinity,has_ct", list(itertools.product([True, False], repeat=2)))
@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("workload", CHECK_WORKLOADS, ids=lambda w: w.__name__)
def test_plain_check_matches_jax(workload, seed, has_affinity, has_ct):
    args, d_max = placed_check_case(workload, seed)
    want = jrep.repair_check(*[jnp.asarray(a) for a in args], d_max=d_max,
                             has_affinity=has_affinity, has_ct=has_ct)
    got = trep.repair_check(*[torch.from_numpy(a) for a in args], d_max=d_max,
                            has_affinity=has_affinity, has_ct=has_ct)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and g.shape == (args[0].shape[0],)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_repair_kinds_workload_violates_every_kind():
    """The seeded placements of test_plain_check_matches_jax really exercise
    every branch of the check."""
    hit = [False] * 4
    for seed in range(2):
        args, d_max = placed_check_case(wl_repair_kinds, seed)
        masks = trep.repair_check_plain(*[torch.from_numpy(a) for a in args], d_max=d_max)
        hit = [h or bool(m.any()) for h, m in zip(hit, masks)]
        assert not any(bool(m[args[0] < 0].any()) for m in masks)  # unplaced never violate
    assert all(hit), hit


def test_check_dispatcher_rejects_other_devices():
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        trep.repair_check(meta, *([None] * 18), d_max=1)


# ---------------------------------------------------------------------------
# the repair context
# ---------------------------------------------------------------------------


def _build(api, workload_fn, ns_labels=None):
    """(inputs, batch, d_max) for one package from a workload function that
    takes the API namespace."""
    nodes, pods, bound = unpack(workload_fn(api))
    if api is JAX_API:
        cache, tz = JCache(clock=FakeClock()), jtz
    else:
        cache, tz = TCache(), ttz
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = cache.update_snapshot()
    cluster = tz.build_cluster_tensors(snap)
    batch = tz.build_pod_batch(pods, snap, cluster, ns_labels=ns_labels)
    if api is JAX_API:
        inp, d_max = jsolver.make_inputs(cluster, batch)
    else:
        inp, d_max = tsolver.make_inputs(cluster, batch, "cpu")
    return inp, batch, d_max


def _module_workload(workload):
    return lambda api: workload(api.m)


@pytest.mark.parametrize("workload", CHECK_WORKLOADS, ids=lambda w: w.__name__)
def test_context_masks_and_soft_rows_match_jax(workload):
    jinp, jb, d_max = _build(JAX_API, _module_workload(workload))
    tinp, tb, t_dmax = _build(PORT_API, _module_workload(workload))
    assert t_dmax == d_max
    jctx = jrep._RepairContext(jinp, jb, d_max, False)
    tctx = trep._RepairContext(tinp, tb, d_max, False)
    rng = np.random.default_rng(3)
    n, c = tctx.n, tb.c
    for step in range(3):
        for cls in range(c):
            mask = tctx.class_mask(cls)
            np.testing.assert_array_equal(mask, jctx.class_mask(cls))
            feas = mask & tctx.filter_np[cls]
            want, got = jctx.soft_row(cls, feas), tctx.soft_row(cls, feas)
            assert (want is None) == (got is None)
            if got is not None:
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want)
            assert (trep._class_fingerprint(tctx, cls, b"r", True)
                    == jrep._class_fingerprint(jctx, cls, b"r", True))
        # fold a seeded placement into both contexts' live counts
        placed = np.bincount(rng.integers(0, n, size=6), minlength=n).astype(np.int64)
        cls = int(rng.integers(0, c))
        jctx.bump(cls, placed)
        tctx.bump(cls, placed)
        np.testing.assert_array_equal(tctx.selcls, jctx.selcls)
        np.testing.assert_array_equal(tctx.grp, jctx.grp)


# ---------------------------------------------------------------------------
# repair_solve on the workloads of tests/test_repair.py
# ---------------------------------------------------------------------------


def _nodes(m, n, cpu="8", mem="32Gi", zones=0, zone_of=None):
    out = []
    for i in range(n):
        labels = {HOST: f"node-{i}"}
        if zones:
            labels[ZONE] = f"zone-{i % zones}"
        if zone_of is not None:
            labels[ZONE] = f"zone-{zone_of(i)}"
        out.append(m.MakeNode(f"node-{i}").labels(labels)
                   .capacity({"cpu": cpu, "memory": mem, "pods": "110"}).obj())
    return out


def rp_host_anti(api):
    m = api.m
    pods = [m.MakePod(f"a-{g}-{i}").labels({"grp": f"g{g}"}).pod_anti_affinity(
        HOST, {"grp": f"g{g}"}).req({"cpu": "200m"}).obj() for g in range(3) for i in range(8)]
    return _nodes(m, 32), pods


def rp_zone_anti(size):
    def build(api):
        m = api.m
        pods = [m.MakePod(f"z-{i}").labels({"grp": "z"}).pod_anti_affinity(
            ZONE, {"grp": "z"}).req({"cpu": "100m"}).obj() for i in range(size)]
        return _nodes(m, 8, zone_of=lambda i: i // 2), pods

    build.__name__ = f"rp_zone_anti_{size}"
    return build


def rp_mixed_request_class(api):
    m = api.m
    pods = ([m.MakePod(f"ms-{i}").labels({"grp": "z"}).pod_anti_affinity(ZONE, {"grp": "z"})
             .req({"cpu": "2"}).obj() for i in range(4)]
            + [m.MakePod(f"ml-{i}").labels({"grp": "z"}).pod_anti_affinity(ZONE, {"grp": "z"})
               .req({"cpu": "3"}).obj() for i in range(2)])
    return _nodes(m, 12, cpu="4", mem="16Gi", zone_of=lambda i: i // 2), pods


def rp_required_affinity(api):
    m = api.m
    seeds = [m.MakePod(f"seed-{z}").labels({"svc": f"s{z}"}).node(f"node-{z}")
             .req({"cpu": "100m"}).obj() for z in range(4)]
    pods = [m.MakePod(f"aff-{i}").labels({"peer": "1"}).pod_affinity(
        ZONE, {"svc": f"s{i % 4}"}).req({"cpu": "200m"}).obj() for i in range(16)]
    return _nodes(m, 32, zones=8), pods, seeds


def rp_spread(api):
    m = api.m
    pods = [m.MakePod(f"sp-{i}").labels({"app": "spread"}).req({"cpu": "100m"})
            .topology_spread(1, ZONE, "DoNotSchedule", {"app": "spread"}).obj()
            for i in range(20)]
    return _nodes(m, 20, zones=5), pods


def rp_ns_selector_anti(api):
    m = api.m
    term = api.Term(topology_key=HOST, selector=api.Selector.from_match_labels({"grp": "g0"}),
                    namespace_selector=api.Selector.from_match_labels({"team": "x"}))
    pods = []
    for i in range(12):
        p = m.MakePod(f"nsa-{i}", namespace=f"team-{i % 4}").labels({"grp": "g0"}) \
            .req({"cpu": "200m"}).obj()
        p.spec.affinity = api.Affinity(pod_anti_affinity_required=[term])
        pods.append(p)
    return _nodes(m, 32), pods


NS_LABELS = {f"team-{t}": {"team": "x"} for t in range(4)}


def rp_mixed_constrained(api):
    m = api.m
    pods = [m.MakePod(f"plain-{i}").req({"cpu": "100m"}).obj() for i in range(10)]
    pods += [m.MakePod(f"anti-{i}").labels({"grp": "m"}).pod_anti_affinity(
        HOST, {"grp": "m"}).req({"cpu": "100m"}).obj() for i in range(6)]
    return _nodes(m, 32), pods


def rp_random(case):
    """tests/test_repair.py's randomized scenario shape, one seed per case."""

    def build(api):
        m = api.m
        rng = np.random.default_rng(800 + case)
        n_zones = int(rng.integers(3, 6))
        n_nodes = n_zones * int(rng.integers(2, 5))
        nodes = _nodes(m, n_nodes, zones=n_zones, cpu="4", mem="16Gi")
        pods = []
        kind_bits = 1 + int(rng.integers(0, 7))
        if kind_bits & 1:
            for g in range(int(rng.integers(1, 3))):
                for i in range(int(rng.integers(2, n_nodes + 3))):
                    pods.append(m.MakePod(f"ha-{g}-{i}").labels({"ha": f"g{g}"})
                                .pod_anti_affinity(HOST, {"ha": f"g{g}"})
                                .req({"cpu": "100m"}).obj())
        if kind_bits & 2:
            for i in range(int(rng.integers(2, n_zones + 2))):
                cpu = "2" if rng.integers(0, 2) else "500m"
                pods.append(m.MakePod(f"za-{i}").labels({"za": "1"})
                            .pod_anti_affinity(ZONE, {"za": "1"}).req({"cpu": cpu}).obj())
        if kind_bits & 4:
            skew = int(rng.integers(1, 3))
            for i in range(int(rng.integers(4, 16))):
                pods.append(m.MakePod(f"sp-{i}").labels({"sp": "1"}).req({"cpu": "100m"})
                            .topology_spread(skew, ZONE, "DoNotSchedule", {"sp": "1"}).obj())
        for i in range(int(rng.integers(0, 6))):
            pods.append(m.MakePod(f"f-{i}").req({"cpu": "100m"}).obj())
        order = rng.permutation(len(pods))
        return nodes, [pods[i] for i in order]

    build.__name__ = f"rp_random_{case}"
    return build


REPAIR_WORKLOADS = ([rp_host_anti, rp_zone_anti(4), rp_zone_anti(6), rp_mixed_request_class,
                     rp_required_affinity, rp_spread, rp_ns_selector_anti, rp_mixed_constrained]
                    + [rp_random(c) for c in range(6)]
                    + [_module_workload(w) for w in [wl_repair_kinds] + MIXED_WORKLOADS])


def _solve(api, workload, max_rounds):
    ns = NS_LABELS if workload is rp_ns_selector_anti else None
    inp, batch, d_max = _build(api, workload, ns_labels=ns)
    mod = jrep if api is JAX_API else trep
    out = mod.repair_solve(inp, batch, d_max, max_rounds=max_rounds)
    assert out is not None
    return np.asarray(out[0]), out[1].as_dict()


@pytest.mark.parametrize("max_rounds", [trep.REPAIR_MAX_ROUNDS, 0])
@pytest.mark.parametrize("idx", range(len(REPAIR_WORKLOADS)),
                         ids=lambda i: getattr(REPAIR_WORKLOADS[i], "__name__", str(i)))
def test_repair_solve_matches_jax(idx, max_rounds):
    workload = REPAIR_WORKLOADS[idx]
    want, wstats = _solve(JAX_API, workload, max_rounds)
    got, gstats = _solve(PORT_API, workload, max_rounds)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert gstats == wstats


def test_repair_paths_are_exercised():
    """The rebuilt workloads reach every branch: repair rounds, the
    residual scan and the full-scan re-solve."""
    seen = {"rounds": 0, "residual": 0, "full_scan": 0, "propose_merge": 0}
    for workload in REPAIR_WORKLOADS:
        _, st = _solve(PORT_API, workload, trep.REPAIR_MAX_ROUNDS)
        seen["rounds"] += st["rounds"] > 0
        seen["residual"] += st["residual"] > 0
        seen["full_scan"] += bool(st["full_scan"])
        seen["propose_merge"] += st["propose_calls"] < st["groups"]
    assert all(seen.values()), seen


def test_empty_batch():
    inp, batch, d_max = _build(PORT_API, rp_host_anti)
    empty = ttz.PodBatchTensors(**{**batch.__dict__, "pods": []})
    out = trep.repair_solve(inp._replace(req=inp.req[:0]), empty, d_max)
    assert out[0].shape == (0,) and out[0].dtype == np.int32
    assert out[1].as_dict() == jrep.RepairStats().as_dict()


def test_dom_view_matches_jax():
    rng = np.random.default_rng(11)
    topo = rng.integers(-1, 5, size=30).astype(np.int32)
    counts = rng.integers(-3, 9, size=30).astype(np.int64)
    np.testing.assert_array_equal(trep._dom_view(counts, topo, 5),
                                  jrep._dom_view(counts, topo, 5))
    none = np.full(30, -1, np.int32)
    np.testing.assert_array_equal(trep._dom_view(counts, none, 5), jrep._dom_view(counts, none, 5))
