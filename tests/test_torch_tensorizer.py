"""The port's host tensorizer and device mirrors against the JAX package's.

The same workloads (tests/test_torch_workloads.py generators) are built
once for each package; build_cluster_tensors, build_pod_batch and
make_inputs must give identical arrays, field by field (exact equality,
same dtype). The device mirrors (TensorCache.device_views) must equal a
fresh upload of the host arrays after churn, in the manner of
tests/test_tensor_cache.py, and the JAX package's device views; the packed
fused scatter (kernel B's plain version) must equal per-field scatters, and
kernel A's per-class precompute must equal numpy. Kernel B on the card:
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
from test_torch_workloads import (MIXED_WORKLOADS, PARITY_WORKLOADS, ZONE,
                                  check_mirrors_after_churn, unpack)

import kubernetes_tpu.scheduler  # noqa: F401  (import order: scheduler before snapshot)
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.snapshot import tensorizer as jtz
from kubernetes_tpu.utils import FakeClock as JFakeClock
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.ops.convert import cluster_from_numpy, solver_inputs_from_numpy
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.snapshot import tensorizer as ttz

CPU = torch.device("cpu")
CLUSTER_FIELDS = ("alloc", "used", "used_nz", "pod_count", "max_pods", "topo_id",
                  "num_domains", "selcls_count")
BATCH_FIELDS = ("class_of_pod", "req", "req_nz", "balanced_active", "ct_class", "ct_key",
                "ct_sel", "ct_max_skew", "ct_min_domains", "ct_self_match", "st_class",
                "st_key", "st_sel", "st_max_skew", "st_self_match", "class_matches_selcls",
                "fallback_class")
TABLE_FIELDS = ("filter_ok", "aff_ok", "napref_raw", "has_napref", "taint_cnt", "img_score",
                "class_ports", "node_ports")
IPA_FIELDS = ("ra_key", "ra_sel", "rn_key", "rn_sel", "pp_key", "pp_sel", "pp_weight",
              "grp_key", "grp_count", "class_holds_grp", "ea_grp", "sym_grp", "sym_weight",
              "class_self_ok", "class_has_ra")


def wl_fallback_and_namespaces(m):
    """Fallback classes (PVC volume, DRA claim, non-default PTS policy) and a
    namespaced affinity term beside ordinary pods."""
    from dataclasses import replace

    nodes = [m.MakeNode(f"n{i}").labels({ZONE: f"z{i % 2}"}).capacity({"cpu": "8"}).obj()
             for i in range(4)]
    pods = [m.MakePod("vol").req({"cpu": "100m"}).pvc("claim-a").obj(),
            m.MakePod("dra").req({"cpu": "100m"}).claim("gpu-claim").obj(),
            m.MakePod("plain").req({"cpu": "100m"}).obj()]
    pol = m.MakePod("policy").labels({"app": "x"}).req({"cpu": "100m"}) \
        .topology_spread(1, ZONE, "DoNotSchedule", {"app": "x"}).obj()
    pol.spec.topology_spread_constraints = [
        replace(c, node_taints_policy="Honor") for c in pol.spec.topology_spread_constraints]
    pods.append(pol)
    pods.append(m.MakePod("ns-aff", namespace="other").labels({"app": "y"})
                .req({"cpu": "100m"}).pod_affinity(ZONE, {"app": "y"}).obj())
    return nodes, pods


WORKLOADS = PARITY_WORKLOADS + MIXED_WORKLOADS + [wl_fallback_and_namespaces]


def both_batches(workload):
    """(jax cluster, jax batch, port cluster, port batch) for one workload."""
    out = []
    for mod, cache, tz in ((jt, JCache(clock=JFakeClock()), jtz), (tt, TCache(), ttz)):
        nodes, pods, bound = unpack(workload(mod))
        for n in nodes:
            cache.add_node(n)
        for p in bound:
            cache.add_pod(p)
        snap = cache.update_snapshot()
        cluster = tz.build_cluster_tensors(snap)
        batch = tz.build_pod_batch(pods, snap, cluster, ns_labels={"other": {"team": "a"}})
        out += [cluster, batch]
    return out


def assert_same_array(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{name}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("workload", WORKLOADS, ids=lambda w: w.__name__)
def test_tensorizer_matches_jax(workload):
    jc, jb, tc, tb = both_batches(workload)
    assert tc.node_names == jc.node_names
    assert tc.resource_dims == jc.resource_dims
    assert tc.topo_keys == jc.topo_keys
    for f in CLUSTER_FIELDS:
        assert_same_array(f, getattr(tc, f), getattr(jc, f))
    for f in BATCH_FIELDS:
        assert_same_array(f, getattr(tb, f), getattr(jb, f))
    for f in TABLE_FIELDS:
        assert_same_array(f, getattr(tb.tables, f), getattr(jb.tables, f))
    for f in IPA_FIELDS:
        assert_same_array(f, getattr(tb.ipa, f), getattr(jb.ipa, f))
    assert tb.has_constraints == jb.has_constraints
    assert tb.ipa.has_any == jb.ipa.has_any


@pytest.mark.parametrize("workload", WORKLOADS, ids=lambda w: w.__name__)
def test_make_inputs_matches_jax(workload):
    jc, jb, tc, tb = both_batches(workload)
    jinp, jd = jsolver.make_inputs(jc, jb)
    tinp, td = tsolver.make_inputs(tc, tb, CPU)
    assert td == jd
    for name in tsolver.SolverInputs._fields:
        j, t = getattr(jinp, name), getattr(tinp, name)
        if j is None:
            assert t is None, name
            continue
        assert t.dtype == tsolver.FIELD_DTYPES[name], name
        assert_same_array(name, t.numpy(), np.asarray(j))


def test_convert_checks_dtypes():
    jc, jb, _tc, _tb = both_batches(PARITY_WORKLOADS[0])
    jinp, _ = jsolver.make_inputs(jc, jb)
    fields = {k: (None if v is None else np.asarray(v)) for k, v in jinp._asdict().items()}
    inp = solver_inputs_from_numpy(fields, CPU)
    assert inp.alloc.dtype == torch.int32 and inp.filter_ok.dtype == torch.bool
    with pytest.raises(TypeError, match="req"):
        solver_inputs_from_numpy(dict(fields, req=fields["req"].astype(np.int64)), CPU)
    cl = cluster_from_numpy({**{f: getattr(jc, f) for f in CLUSTER_FIELDS},
                             "node_names": jc.node_names, "resource_dims": jc.resource_dims})
    for f in CLUSTER_FIELDS:
        assert_same_array(f, getattr(cl, f), getattr(jc, f))
    with pytest.raises(TypeError, match="alloc"):
        cluster_from_numpy({**{f: getattr(jc, f) for f in CLUSTER_FIELDS},
                            "alloc": jc.alloc.astype(np.int64),
                            "node_names": jc.node_names, "resource_dims": jc.resource_dims})


def test_device_mirrors_track_host_after_churn():
    check_mirrors_after_churn(CPU)


def test_tensor_cache_incremental_matches_jax_after_churn():
    """Same churn through both packages' TensorCache: identical cluster rows
    and selector-class counts at every step."""
    caches = {"jax": (JCache(clock=JFakeClock()), jtz.TensorCache(), jt, jtz),
              "port": (TCache(), ttz.TensorCache(), tt, ttz)}
    for cache, _tc, mod, _tz in caches.values():
        for i in range(20):
            cache.add_node(mod.MakeNode(f"n{i}").labels({ZONE: f"z{i % 4}"})
                           .capacity({"cpu": "8", "memory": "16Gi", "pods": "50"}).obj())
    rng = np.random.default_rng(5)
    for step in range(4):
        placements = rng.integers(0, 20, size=5).tolist()
        got = {}
        for key, (cache, tc, mod, tz) in caches.items():
            for j, nidx in enumerate(placements):
                p = mod.MakePod(f"b{step}-{j}").labels({"app": "w"}).req(
                    {"cpu": "300m", "memory": "700Mi"}).obj()
                p.spec.node_name = f"n{nidx}"
                cache.add_pod(p)
            snap = cache.update_snapshot()
            cluster, changed = tc.cluster_tensors(snap)
            pods = [mod.MakePod(f"q{step}-{j}").labels({"app": "w"}).req({"cpu": "100m"})
                    .topology_spread(1, ZONE, "DoNotSchedule", {"app": "w"}).obj()
                    for j in range(3)]
            tz.build_pod_batch(pods, snap, cluster, reuse=tc, changed_nodes=changed)
            got[key] = cluster
        for f in CLUSTER_FIELDS:
            assert_same_array(f, getattr(got["port"], f), getattr(got["jax"], f))


def test_scatter_plain_versions():
    dst = torch.zeros((5, 3), dtype=torch.int32)
    ttz.scatter_rows(dst, torch.tensor([1, 4], dtype=torch.int32),
                     torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32))
    assert dst.tolist() == [[0, 0, 0], [1, 2, 3], [0, 0, 0], [0, 0, 0], [4, 5, 6]]
    cols = torch.zeros((2, 4), dtype=torch.int32)
    ttz.scatter_cols(cols, torch.tensor([3, 0], dtype=torch.int32),
                     torch.tensor([[7, 8], [9, 10]], dtype=torch.int32))
    assert cols.tolist() == [[8, 0, 0, 7], [10, 0, 0, 9]]



@pytest.mark.parametrize("with_selcls", [False, True])
@pytest.mark.parametrize("n,ks", [(50, None), (40, [1]), (30, [30]), (200, [7, 150])],
                         ids=["seeded_k", "k1", "k_n", "mixed_k"])
def test_scatter_mirrors_plain_matches_per_field(n, ks, with_selcls):
    """pack_mirror_rows + scatter_mirrors_plain write every mirror as one
    per-field scatter each (scatter_rows_plain, scatter_cols_plain)."""
    gen = tt.mirror_churn_rounds(n + 1, n, ks=ks)
    cl, _ = next(gen)
    names = list(ttz.TensorCache.DEVICE_FIELDS) + (["selcls_count"] if with_selcls else [])
    fused = {f: torch.from_numpy(getattr(cl, f).copy()) for f in names}
    per_field = {f: t.clone() for f, t in fused.items()}
    for cl, rows in gen:
        packed, segs = ttz.pack_mirror_rows(cl, rows, with_selcls)
        assert packed.dtype == np.int32 and packed.shape == (len(rows), segs[-1].offset
                                                             + segs[-1].width)
        assert [s.name for s in segs] == names
        np.testing.assert_array_equal(packed[:, 0], rows)
        ttz.scatter_mirrors_plain([fused[s.name] for s in segs], torch.from_numpy(packed), segs)
        idx = torch.from_numpy(rows.astype(np.int32))
        for f in names:
            host = getattr(cl, f)
            if f == "selcls_count":
                ttz.scatter_cols_plain(per_field[f], idx, torch.from_numpy(host[:, rows]))
            else:
                ttz.scatter_rows_plain(per_field[f], idx, torch.from_numpy(host[rows]))
    for f in names:
        assert torch.equal(fused[f], per_field[f]), f
        np.testing.assert_array_equal(fused[f].numpy(), getattr(cl, f), err_msg=f)


def test_mirror_layout_and_packing_buffer():
    segs, w = ttz.mirror_layout(4, 3)
    assert w == 3 + 3 * 4 + 3
    assert [(s.offset, s.width, s.col_mode) for s in segs] == [
        (1, 4, False), (5, 4, False), (9, 4, False), (13, 1, False), (14, 1, False),
        (15, 3, True)]
    assert ttz.mirror_layout(3)[1] == 12
    cl, rows = next(tt.mirror_churn_rounds(2, 20, r=4, sc=3, ks=[6]))
    buf = np.full(200, -7, np.int32)
    packed, _ = ttz.pack_mirror_rows(cl, rows, True, out=buf)
    assert np.shares_memory(packed, buf) and (buf[6 * w:] == -7).all()
    np.testing.assert_array_equal(packed, ttz.pack_mirror_rows(cl, rows, True)[0])


@pytest.mark.parametrize("seed", range(3))
def test_device_views_cpu_matches_jax_after_churn(seed):
    """The port's TensorCache.device_views on the CPU (one fused plain
    scatter a batch) gives the JAX package's device views after seeded
    churn, selector-class columns included."""
    caches = {"jax": (JCache(clock=JFakeClock()), jtz.TensorCache(), jt, jtz),
              "port": (TCache(), ttz.TensorCache(), tt, ttz)}
    for cache, _tc, mod, _tz in caches.values():
        for i in range(24):
            cache.add_node(mod.MakeNode(f"n{i}").labels({ZONE: f"z{i % 4}"})
                           .capacity({"cpu": "8", "memory": "16Gi", "pods": "50"}).obj())
    rng = np.random.default_rng(seed)
    for step in range(5):
        placements = rng.integers(0, 24, size=int(rng.integers(1, 9))).tolist()
        views = {}
        for key, (cache, tc, mod, tz) in caches.items():
            for j, nidx in enumerate(placements):
                p = mod.MakePod(f"b{step}-{j}").labels({"app": "w" if j % 2 else "v"}).req(
                    {"cpu": "300m", "memory": "700Mi"}).obj()
                p.spec.node_name = f"n{nidx}"
                cache.add_pod(p)
            snap = cache.update_snapshot()
            cluster, changed = tc.cluster_tensors(snap)
            pods = [mod.MakePod(f"q{step}-{j}").labels({"app": "w"}).req({"cpu": "100m"})
                    .topology_spread(1, ZONE, "DoNotSchedule", {"app": "w"})
                    .pod_anti_affinity(ZONE, {"app": "v"}).obj()
                    for j in range(3)]
            tz.build_pod_batch(pods, snap, cluster, reuse=tc, changed_nodes=changed)
            views[key] = tc.device_views(cluster) if key == "jax" else tc.device_views(cluster,
                                                                                          CPU)
        assert set(views["port"]) == set(views["jax"])
        assert "selcls_count" in views["port"]
        for f in views["jax"]:
            assert_same_array(f, views["port"][f].numpy(), np.asarray(views["jax"][f]))


@pytest.mark.parametrize("gang", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_scan_class_rows_matches_numpy(seed, gang):
    """Kernel A's per-class precompute (ops/solver.py scan_class_rows)
    against numpy: the packed rows and the extrema / IPA-term flags."""
    f, _ = tt.scan_problem(seed, 40, 10, c=5, gang=gang)
    f["napref_raw"][2] = -3  # no positive entry: needs no max
    f["has_napref"][1] = False
    inp = solver_inputs_from_numpy(f, CPU)
    rows, flags = tsolver.scan_class_rows(inp, has_gang=gang)
    img = f["img_score"] + (f["gang_bonus"] if gang else 0)
    want = np.stack([f["filter_ok"].astype(np.int32), f["napref_raw"], f["taint_cnt"], img],
                    axis=-1).astype(np.int32)
    assert rows.dtype == torch.int32 and rows.is_contiguous()
    np.testing.assert_array_equal(rows.numpy(), want)
    want_flags = ((f["has_napref"] & (f["napref_raw"] > 0).any(axis=1)).astype(np.int32)
                  | ((f["taint_cnt"] > 0).any(axis=1).astype(np.int32) << 1)
                  | (((f["pp_key"] >= 0).any(axis=1) | (f["sym_grp"] >= 0).any(axis=1))
                     .astype(np.int32) << 2))
    assert flags.dtype == torch.int32
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    assert not flags[0] & 3 and not flags[1] & 1 and not flags[2] & 1
    topo = f["topo_id"].copy()
    topo[0] = -1  # a key no node carries
    kd = tsolver.scan_key_domains(torch.from_numpy(topo))
    assert kd.dtype == torch.int32
    np.testing.assert_array_equal(kd.numpy(), np.maximum(topo.max(axis=1) + 1, 0))
