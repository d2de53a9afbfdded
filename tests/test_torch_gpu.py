"""Card-only tests of the port's kernels (marked `gpu`; skip without a card).

Run on the card with `python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py` (tests/conftest.py configures JAX, which the card's
machine need not have; this file imports neither jax nor the JAX package).
Kernel A (greedy_scan), kernel B (row_scatter), kernel C (waterfill),
kernel D (repair_check), kernel G (cover_curve), kernel H (rank_align),
kernel J (feasibility_rows), kernel E (auction_phase, one thread-block
cluster a phase) and kernel I (defrag_assign) are held against
their plain PyTorch versions on the same card tensors, built by the port's
own tensorizer or from seeded numpy inputs: exact equality; kernel F
(sinkhorn) to a relative error of 1e-5 (|a - b| / max(|b|, 1e-6): expf/logf
and the reduction order). The gang and transport schedulers' card runs, and the
rebalancer's, are held against their CPU runs.
"""

import itertools

import numpy as np
import pytest
import torch
from test_torch_workloads import (MIXED_WORKLOADS, PARITY_WORKLOADS, check_mirrors_after_churn,
                                  placed_check_case, unpack, wl_interpod_anti_affinity,
                                  wl_pts_do_not_schedule, wl_repair_kinds)

import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.scheduler.cache import Cache
from kubernetes_tpu_torch.snapshot import tensorizer as ttz
from kubernetes_tpu_torch.testing import transport_problem


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def port_inputs(workload, device, gang_seed=None):
    nodes, pods, bound = unpack(workload(tt))
    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = cache.update_snapshot()
    cluster = ttz.build_cluster_tensors(snap)
    batch = ttz.build_pod_batch(pods, snap, cluster)
    inp, d_max = tsolver.make_inputs(cluster, batch, device)
    gates = dict(has_ipa=bool(batch.ipa.has_any), has_ct=bool(batch.ct_class.size),
                 has_st=bool(batch.st_class.size), has_gang=False)
    if gang_seed is not None:
        rng = np.random.default_rng(gang_seed)
        bonus = rng.integers(0, 40, size=tuple(inp.filter_ok.shape)).astype(np.int32)
        inp = inp._replace(gang_bonus=torch.from_numpy(bonus).to(device))
        gates["has_gang"] = True
    return inp, d_max, gates


@pytest.mark.gpu
@pytest.mark.parametrize("gang", [False, True])
@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_kernel_a_matches_plain_on_card(cuda_device, workload, gang):
    from kubernetes_tpu_torch.ops import kernels

    inp, d_max, gates = port_inputs(workload, cuda_device, gang_seed=1 if gang else None)
    before = kernels.LAUNCHES["greedy_scan"]
    got = tsolver.greedy_scan_solve(inp, d_max, **gates)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["greedy_scan"] == before + 1
    ref = tsolver.greedy_scan_solve_plain(inp, d_max, **gates)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int32 and torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_a_rejects_wrong_dtype(cuda_device):
    inp, d_max, gates = port_inputs(PARITY_WORKLOADS[0], cuda_device)
    with pytest.raises(TypeError, match="req"):
        tsolver.greedy_scan_solve(inp._replace(req=inp.req.long()), d_max, **gates)


def _scan_on_card(f, d_max, device, gates):
    """Kernel A and its plain version on the same card tensors of a seeded
    scan_problem; exact equality of all three outputs."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.convert import solver_inputs_from_numpy

    if not gates["has_gang"]:
        f = dict(f, gang_bonus=None)
    inp = solver_inputs_from_numpy(f, device)
    before = kernels.LAUNCHES["greedy_scan"]
    got = tsolver.greedy_scan_solve(inp, d_max, **gates)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["greedy_scan"] == before + 1
    ref = tsolver.greedy_scan_solve_plain(inp, d_max, **gates)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    return got[0].cpu(), dict(kernels.LAST_SCAN_PLAN)


ALL_GATES = dict(has_ipa=True, has_ct=True, has_st=True, has_gang=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,kw", [
    (1, 12, {}),  # one node: every CTA but the first owns none
    (7, 40, {}),  # fewer nodes than the cluster's CTAs
    (33, 60, {}),  # not a multiple of the cluster size
    (1000, 200, {"hostname": False}),
    (5003, 96, {}),  # the hostname key: d_max = N, the domain tables in global memory
    (70000, 24, {}),  # a CTA's share past shared memory: the global-scratch path
], ids=lambda x: str(x) if not isinstance(x, dict) else ",".join(x) or "all")
def test_kernel_a_cluster_shapes_on_card(cuda_device, n, p, kw):
    assignment, plan = _scan_on_card(*tt.scan_problem(11 + n, n, p, **kw), cuda_device,
                                     ALL_GATES)
    assert plan["cluster_size"] in (8, 16)
    assert (assignment == -1).any() and (assignment >= 0).any()
    if n >= 5003:
        assert "domain_tables" not in plan["in_smem"]
    if n == 70000:
        assert {"st_flags", "class_rows", "domain_tables"}.isdisjoint(plan["in_smem"])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 100, 5000])
def test_kernel_a_identical_nodes_tie_to_lowest_index(cuda_device, n):
    """Identical nodes: every step's best score ties across CTA boundaries
    and the lowest index must win (the first pods land on nodes 0, 1, ...)."""
    p = min(2 * n, 300)
    assignment, _ = _scan_on_card(*tt.scan_problem(3, n, p, identical=True), cuda_device,
                                  dict(ALL_GATES, has_gang=False))
    assert assignment[: min(n, p)].tolist() == list(range(min(n, p)))


@pytest.mark.gpu
@pytest.mark.parametrize("gates", list(itertools.product([False, True], repeat=4)),
                         ids=lambda g: "ipa{}-ct{}-st{}-gang{}".format(*map(int, g)))
def test_kernel_a_every_gate_combination_on_card(cuda_device, gates):
    has = dict(zip(("has_ipa", "has_ct", "has_st", "has_gang"), gates))
    _scan_on_card(*tt.scan_problem(5, 300, 150), cuda_device, has)


@pytest.mark.gpu
def test_kernel_a_pod_that_fits_nowhere_on_card(cuda_device):
    f, d_max = tt.scan_problem(8, 64, 30, huge_every=3)
    assignment, _ = _scan_on_card(f, d_max, cuda_device, ALL_GATES)
    assert (assignment[::3] == -1).all()


@pytest.mark.gpu
def test_device_mirrors_on_card_after_churn(cuda_device):
    from kubernetes_tpu_torch.ops import kernels

    before = kernels.LAUNCHES["row_scatter"]
    check_mirrors_after_churn(cuda_device)
    assert kernels.LAUNCHES["row_scatter"] > before


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
def test_kernel_b_matches_plain_on_card(cuda_device, seed):
    rng = np.random.default_rng(seed)
    n = 1000
    for shape in ((n, 3), (n,)):
        base = torch.from_numpy(rng.integers(0, 1 << 30, size=shape).astype(np.int32))
        k = int(rng.integers(1, n))
        idx = torch.from_numpy(rng.choice(n, size=k, replace=False).astype(np.int32))
        src = torch.from_numpy(rng.integers(0, 1 << 30, size=(k,) + shape[1:]).astype(np.int32))
        got = base.to(cuda_device)
        ttz.scatter_rows(got, idx.to(cuda_device), src.to(cuda_device))
        want = base.clone()
        ttz.scatter_rows_plain(want, idx, src)
        assert torch.equal(got.cpu(), want)
    mat = torch.from_numpy(rng.integers(0, 50, size=(4, n)).astype(np.int32))
    k = 77
    idx = torch.from_numpy(rng.choice(n, size=k, replace=False).astype(np.int32))
    src = torch.from_numpy(rng.integers(0, 50, size=(4, k)).astype(np.int32))
    got = mat.to(cuda_device)
    ttz.scatter_cols(got, idx.to(cuda_device), src.to(cuda_device))
    want = mat.clone()
    ttz.scatter_cols_plain(want, idx, src)
    assert torch.equal(got.cpu(), want)


def _fused_mirrors(cl, device, with_selcls):
    fields = list(ttz.TensorCache.DEVICE_FIELDS) + (["selcls_count"] if with_selcls else [])
    return {f: torch.from_numpy(getattr(cl, f).copy()).to(device) for f in fields}


@pytest.mark.gpu
@pytest.mark.parametrize("with_selcls", [False, True])
@pytest.mark.parametrize("n,ks", [(1000, None), (777, [1]), (500, [500]), (5000, [4096])],
                         ids=["seeded_k", "k1", "k_n", "main_path_shape"])
def test_kernel_b_fused_matches_plain_after_churn(cuda_device, n, ks, with_selcls):
    """One fused launch per round writes every mirror as the per-field
    plain scatters do (exact), k = 1 and k = N included."""
    from kubernetes_tpu_torch.ops import kernels

    gen = tt.mirror_churn_rounds(3, n, ks=ks)
    cl, rows = next(gen)
    got, want = _fused_mirrors(cl, cuda_device, with_selcls), _fused_mirrors(cl, "cpu",
                                                                             with_selcls)
    for cl, rows in gen:
        packed, segs = ttz.pack_mirror_rows(cl, rows, with_selcls)
        mset = kernels.MirrorSet([(got[s.name], s.offset, s.width, s.col_mode) for s in segs],
                                 packed.shape[1])
        before = kernels.LAUNCHES["row_scatter"]
        kernels.launch_mirror_scatter(mset, torch.from_numpy(packed).to(cuda_device),
                                      len(rows))
        assert kernels.LAUNCHES["row_scatter"] == before + 1
        idx = torch.from_numpy(rows.astype(np.int32))
        for s in segs:
            src = torch.from_numpy(np.ascontiguousarray(getattr(cl, s.name)[..., rows]
                                                        if s.col_mode else
                                                        getattr(cl, s.name)[rows]))
            (ttz.scatter_cols_plain if s.col_mode else ttz.scatter_rows_plain)(
                want[s.name], idx, src)
    torch.cuda.synchronize()
    for f in got:
        assert torch.equal(got[f].cpu(), want[f]), f


@pytest.mark.gpu
def test_device_views_one_launch_per_incremental_batch(cuda_device):
    """An incremental device_views is one kernel-B launch (the five fields
    and the selector-class columns together) and equals a fresh upload."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.ops import kernels

    gen = tt.mirror_churn_rounds(9, 300)
    cl, _ = next(gen)
    tc = ttz.TensorCache()
    cluster = SimpleNamespace(**vars(cl))
    tc.device_views(cluster, cuda_device)
    for cl, rows in gen:
        cluster.__dict__.update(vars(cl))
        tc._dirty_rows.update(rows.tolist())
        before = kernels.LAUNCHES["row_scatter"]
        views = tc.device_views(cluster, cuda_device)
        assert kernels.LAUNCHES["row_scatter"] == before + 1
        for f in list(ttz.TensorCache.DEVICE_FIELDS) + ["selcls_count"]:
            np.testing.assert_array_equal(views[f].cpu().numpy(), getattr(cluster, f), err_msg=f)


@pytest.mark.gpu
def test_kernel_b_rejects_wrong_input(cuda_device):
    from kubernetes_tpu_torch.ops import kernels

    cl, rows = next(tt.mirror_churn_rounds(4, 64))
    mirrors = _fused_mirrors(cl, cuda_device, True)
    packed, segs = ttz.pack_mirror_rows(cl, rows, True)
    args = [(mirrors[s.name], s.offset, s.width, s.col_mode) for s in segs]
    with pytest.raises(TypeError, match="mirror 0"):
        kernels.MirrorSet([(mirrors["alloc"].long(),) + args[0][1:]] + args[1:], packed.shape[1])
    with pytest.raises(ValueError, match="mirror 5"):  # a column mirror of the wrong height
        kernels.MirrorSet(args[:5] + [(mirrors["selcls_count"][:2].contiguous(),) + args[5][1:]],
                          packed.shape[1])
    mset = kernels.MirrorSet(args, packed.shape[1])
    dev = torch.from_numpy(packed).to(cuda_device)
    with pytest.raises(TypeError, match="packed"):
        kernels.launch_mirror_scatter(mset, dev.long(), len(rows))
    with pytest.raises(ValueError, match="width"):
        kernels.launch_mirror_scatter(mset, dev[:, 1:].contiguous(), len(rows))
    with pytest.raises(ValueError, match="rows"):
        kernels.launch_mirror_scatter(mset, dev, len(rows) + 1)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="src"):
        ttz.scatter_rows(mirrors["alloc"], idx, torch.zeros((3, 2), dtype=torch.int32,
                                                             device=cuda_device))
    with pytest.raises(TypeError, match="idx"):
        ttz.scatter_rows(mirrors["alloc"], idx.long(), torch.zeros((3, 3), dtype=torch.int32,
                                                                  device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["exact", "fast"])
@pytest.mark.parametrize("workload", MIXED_WORKLOADS[:2] + [PARITY_WORKLOADS[1]],
                         ids=lambda w: w.__name__)
def test_batch_scheduler_card_matches_cpu(cuda_device, workload, solver):
    """The scheduler on the card places exactly as its CPU (plain) run."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore

    maps = []
    for device in (cuda_device, torch.device("cpu")):
        nodes, pods, bound = unpack(workload(tt))
        store = APIStore()
        for o in nodes:
            store.create("nodes", o)
        for o in bound + pods:
            store.create("pods", o)
        sched = BatchScheduler(store, device=device, batch_size=9, solver=solver)
        sched.sync()
        kernels.reset_launch_counts()
        sched.run_until_idle()
        assert sched.breaker.failures_total == 0, sched.last_solver_error
        if device.type == "cuda" and solver == "fast":
            assert kernels.LAUNCHES["waterfill"] > 0
        got, _ = store.list("pods")
        maps.append({p.metadata.name: p.spec.node_name for p in got})
    assert maps[0] == maps[1]


# ---------------------------------------------------------------------------
# kernel C (waterfill) and kernel D (repair_check)
# ---------------------------------------------------------------------------


def _seeded_group(seed, n, j_max, group, device, ports=False, gang=False, overcommit=False,
                  tiny_req=False):
    """Seeded inputs of one waterfill_group call on `device` (tiny_req: rows
    as deep as j_max)."""
    rng = np.random.default_rng(seed)
    r = 3
    alloc = rng.integers(1000, 8000, size=(n, r)).astype(np.int32)
    used = (alloc * rng.random((n, r)) * 0.8).astype(np.int32)
    if overcommit:
        hot = rng.choice(n, size=max(n // 8, 1), replace=False)
        used[hot] = alloc[hot] + rng.integers(1, 900, size=(hot.size, r)).astype(np.int32)
    req = rng.integers(1, 3, size=r) if tiny_req else rng.integers(20, 400, size=r)
    req = req.astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = [t(alloc), t(used), t(np.maximum(used, 50).astype(np.int32)),
            t(rng.integers(0, j_max, size=n).astype(np.int32)),
            t(rng.integers(j_max // 2 + 1, 3 * j_max + 2, size=n).astype(np.int32)),
            t(rng.random(n) < 0.85), t(rng.random(n) < 0.3 if ports else np.zeros(n, bool)), ports,
            t(rng.integers(0, 60, size=n).astype(np.int32)), t(np.asarray(True)),
            t(rng.integers(0, 4, size=n).astype(np.int32)),
            t(rng.integers(0, 30, size=n).astype(np.int32)), t(req),
            t(np.maximum(req, 100).astype(np.int32)), t(np.asarray(True)), group]
    gang_row = t(rng.integers(0, 100, size=n).astype(np.int32)) if gang else None
    return args, gang_row


@pytest.mark.gpu
@pytest.mark.parametrize("n,j_max,group,opts", [
    (64, 8, 100, {}),
    (64, 1, 30, {"ports": True}),
    (500, 16, 3, {"gang": True, "overcommit": True}),  # below the 256 floor
    (2000, 16, 9000, {}),  # k_slots 16,384: the global sort path
    (300, 32, 9600, {}),  # k_slots == N * j_max
    (5000, 128, 4096, {"overcommit": True}),
])
def test_kernel_c_matches_plain_on_card(cuda_device, n, j_max, group, opts):
    from kubernetes_tpu_torch.models import waterfill as wf
    from kubernetes_tpu_torch.ops import kernels

    args, gang_row = _seeded_group(n + group, n, j_max, group, cuda_device, **opts)
    k_slots = wf.k_slots_for(group, n, j_max)
    before = kernels.LAUNCHES["waterfill"]
    got = wf.waterfill_group(*args, j_max, k_slots, gang_row, gang_row is not None)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["waterfill"] == before + 1
    want = wf.waterfill_group_plain(*args, j_max, k_slots, gang_row, gang_row is not None)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert int(got[0].sum()) == int((got[1] >= 0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n,j_max,group,opts", [
    (1, 16, 9, {}),  # one node: every CTA but the first owns none
    (37, 8, 200, {}),  # a node count no multiple of the cluster size
    (64, 8, 0, {}),  # an empty group: nothing chosen
    (2000, 1024, 1_000_000, {"tiny_req": True}),  # rows and lists beyond shared memory
])
def test_kernel_c_cluster_shapes_on_card(cuda_device, n, j_max, group, opts):
    """One cluster launch a group (kernels.CUDA_LAUNCHES), exact against the
    plain version, at shapes that leave CTAs empty or put a CTA's key rows
    and chosen list in its global slice."""
    from kubernetes_tpu_torch.models import waterfill as wf
    from kubernetes_tpu_torch.ops import kernels

    args, gang_row = _seeded_group(n * 7 + group, n, j_max, max(group, 1), cuda_device, **opts)
    args[-1] = group
    k_slots = wf.k_slots_for(max(group, 1), n, j_max)
    before = kernels.CUDA_LAUNCHES["waterfill"]
    got = wf.waterfill_group(*args, j_max, k_slots, gang_row, gang_row is not None)
    torch.cuda.synchronize()
    assert kernels.CUDA_LAUNCHES["waterfill"] == before + 1
    assert kernels.LAST_WATERFILL_PLAN["cluster_size"] in (8, 16)
    want = wf.waterfill_group_plain(*args, j_max, k_slots, gang_row, gang_row is not None)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert int(got[0].sum()) == int((got[1] >= 0).sum()) <= group


@pytest.mark.gpu
def test_waterfill_solve_reads_once_a_batch_on_card(cuda_device):
    from kubernetes_tpu_torch.models import waterfill as wf
    from kubernetes_tpu_torch.ops import kernels

    inp, _, _ = port_inputs(PARITY_WORKLOADS[0], cuda_device)
    p = inp.req.shape[0]
    groups = [(np.arange(i, min(i + 2, p)), 0) for i in range(0, min(p, 8), 2)]
    kernels.reset_launch_counts()
    got = wf.waterfill_solve(inp, groups)
    assert kernels.HOST_SYNCS["waterfill"] == 1
    assert kernels.CUDA_LAUNCHES["waterfill"] == len(groups)
    cpu, _, _ = port_inputs(PARITY_WORKLOADS[0], torch.device("cpu"))
    np.testing.assert_array_equal(got, wf.waterfill_solve(cpu, groups))


@pytest.mark.gpu
def test_kernel_c_rejects_wrong_input(cuda_device):
    from kubernetes_tpu_torch.models import waterfill as wf

    args, _ = _seeded_group(0, 64, 8, 10, cuda_device)
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(TypeError, match="alloc"):
        wf.waterfill_group(*bad, 8, 256)
    bad = list(args)
    bad[5] = args[5][:10]
    with pytest.raises(ValueError, match="filter_ok_row"):
        wf.waterfill_group(*bad, 8, 256)
    with pytest.raises(ValueError, match="k_slots"):
        wf.waterfill_group(*args, 8, 64 * 8 + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("has_affinity,has_ct", [(True, True), (True, False), (False, True),
                                                 (False, False)])
@pytest.mark.parametrize("workload", [wl_repair_kinds, wl_interpod_anti_affinity,
                                      wl_pts_do_not_schedule] + MIXED_WORKLOADS[:2],
                         ids=lambda w: w.__name__)
def test_kernel_d_matches_plain_on_card(cuda_device, workload, has_affinity, has_ct):
    from kubernetes_tpu_torch.models import repair as rp
    from kubernetes_tpu_torch.ops import kernels

    for seed in range(2):
        args, d_max = placed_check_case(workload, seed)
        dev_args = [torch.from_numpy(a).to(cuda_device) for a in args]
        before = kernels.LAUNCHES["repair_check"]
        got = rp.repair_check(*dev_args, d_max=d_max, has_affinity=has_affinity, has_ct=has_ct)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["repair_check"] == before + 1
        want = rp.repair_check_plain(*dev_args, d_max=d_max, has_affinity=has_affinity,
                                     has_ct=has_ct)
        for a, b in zip(got, want):
            assert a.dtype == torch.bool and torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_d_rejects_wrong_input(cuda_device):
    from kubernetes_tpu_torch.models import repair as rp

    args, d_max = placed_check_case(wl_repair_kinds, 0)
    dev_args = [torch.from_numpy(a).to(cuda_device) for a in args]
    bad = list(dev_args)
    bad[0] = dev_args[0].long()
    with pytest.raises(TypeError, match="node_of"):
        rp.repair_check(*bad, d_max=d_max)
    bad = list(dev_args)
    bad[13] = dev_args[13][:, :3]
    with pytest.raises(ValueError, match="aff_ok"):
        rp.repair_check(*bad, d_max=d_max)


# ---------------------------------------------------------------------------
# kernel G (cover_curve) and kernel H (rank_align)
# ---------------------------------------------------------------------------


def _cover_args(seed, ns, k, r, device, pads=0, inelig=0.25, negative=False):
    rng = np.random.default_rng(seed)
    n_slots = 1 << max(0, ns - 1).bit_length()
    k_max = 1 << max(0, k + pads - 1).bit_length()
    free = np.zeros((n_slots, r), np.int32)
    free[:ns] = rng.integers(-400 if negative else 0, 4000, size=(ns, r))
    head = np.zeros(n_slots, np.int32)
    head[:ns] = rng.integers(0, 110, size=ns)
    elig = np.zeros(n_slots, bool)
    elig[:ns] = rng.random(ns) >= inelig
    vn = np.full(k_max, -1, np.int32)
    vn[:k] = rng.integers(0, ns, size=k)
    vr = np.zeros((k_max, r), np.int32)
    vr[:k] = rng.integers(0, 2000, size=(k, r))
    req = rng.integers(0, 3000, size=r).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (free, head, elig, vn, vr, req))


@pytest.mark.gpu
@pytest.mark.parametrize("ns,k,r,opts", [
    (250, 1000, 3, {}),  # the main path's slice
    (37, 0, 3, {"pads": 5}),  # k = 0 with pads
    (200, 300, 4, {"pads": 200, "inelig": 0.5}),
    (9, 40, 5, {"negative": True}),
    (4000, 1000, 3, {}),  # above the JAX wrapper's 4M-element budget
    (3, 3000, 1, {"inelig": 0.0}),  # k_max above one shared-memory tile
])
def test_kernel_g_matches_plain_on_card(cuda_device, ns, k, r, opts):
    from kubernetes_tpu_torch.models import gangcover as gcv
    from kubernetes_tpu_torch.ops import kernels

    args = _cover_args(ns + k + r, ns, k, r, cuda_device, **opts)
    before = kernels.LAUNCHES["cover_curve"]
    got = gcv.cover_curve(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cover_curve"] == before + 1
    want = gcv.cover_curve_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    host = gcv.cover_curve_host(*(a.cpu().numpy() for a in args))
    assert np.array_equal(got.cpu().numpy().astype(np.int64), host)


@pytest.mark.gpu
@pytest.mark.parametrize("n_slices,ns,k", [
    (20, 250, 1000),  # GangPreemption_5000's attempt: 20 slices of 250 nodes
    (3, 7, 0),  # no victims at all
    (2, 60000, 200),  # a slice's regions beyond shared memory: the global slices
])
def test_kernel_g_batched_one_launch_on_card(cuda_device, n_slices, ns, k):
    """Every slice of an attempt in one launch and one read back, each curve
    equal to its own plain curve."""
    from kubernetes_tpu_torch.models import gangcover as gcv
    from kubernetes_tpu_torch.ops import kernels

    rng = np.random.default_rng(n_slices + ns + k)
    r = 3
    req = np.array([3000, 512, 0])
    slices = []
    for _ in range(n_slices):
        m, kk = int(rng.integers(max(ns // 2, 1), ns + 1)), int(rng.integers(0, k + 1))
        slices.append((rng.integers(-500, 4000, size=(m, r)), rng.integers(0, 110, size=m),
                       rng.random(m) > 0.1, rng.integers(0, m, size=kk),
                       rng.integers(0, 2000, size=(kk, r))))
    kernels.reset_launch_counts()
    got = gcv.cover_curves_batched(slices, req, device=cuda_device)
    assert kernels.LAUNCHES["cover_curve"] == 1 and kernels.CUDA_LAUNCHES["cover_curve"] == 1
    assert kernels.HOST_SYNCS["cover_curve"] == 1
    want = gcv.cover_curves_batched(slices, req, device="cpu")
    for a, b, x in zip(got, want, slices):
        assert np.array_equal(a, b) and len(a) == len(x[3]) + 1


@pytest.mark.gpu
def test_kernel_g_batch_tensors_match_plain_on_card(cuda_device):
    from kubernetes_tpu_torch.models import gangcover as gcv

    cases = [_cover_args(s, 100, 300, 3, cuda_device, pads=10, negative=True) for s in range(5)]
    stacked = [torch.stack([c[i] for c in cases]) for i in range(5)]
    got = gcv.cover_curve_batch(*stacked, cases[0][5])
    torch.cuda.synchronize()
    assert torch.equal(got, gcv.cover_curve_batch_plain(*stacked, cases[0][5]))
    for s, c in enumerate(cases):
        assert torch.equal(got[s], gcv.cover_curve(*c[:5], cases[0][5]))


@pytest.mark.gpu
def test_kernel_g_rejects_wrong_input(cuda_device):
    from kubernetes_tpu_torch.models import gangcover as gcv

    args = list(_cover_args(0, 8, 4, 3, cuda_device))
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(TypeError, match="free"):
        gcv.cover_curve(*bad)
    bad = list(args)
    bad[4] = args[4][:, :2].contiguous()
    with pytest.raises(ValueError, match="v_req"):
        gcv.cover_curve(*bad)


def _align_args(seed, p, p_max, device, ties):
    rng = np.random.default_rng(seed)
    a = np.full(p_max, -1, np.int32)
    a[:p] = rng.integers(-1, 5000, size=p)
    g = np.arange(p_max, dtype=np.int32) + np.int32(2**30)
    g[:p] = rng.integers(-2, 9, size=p)
    hi = 6 if ties else 1 << 30
    rank = np.zeros(p_max, np.int32)
    rank[:p] = rng.integers(-hi, hi, size=p)
    pos = np.zeros(p_max, np.int32)
    pos[:p] = np.where(a[:p] >= 0, rng.integers(0, hi, size=p), 2**30)
    return tuple(torch.from_numpy(x).to(device) for x in (a, g, rank, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,p_max", [(1, 1), (2, 2), (50, 64), (4096, 4096), (3000, 4096),
                                     (8000, 8192), (16384, 16384), (40000, 65536)])
def test_kernel_h_matches_plain_on_card(cuda_device, p, p_max, ties):
    from kubernetes_tpu_torch.models import gangcover as gcv
    from kubernetes_tpu_torch.ops import kernels

    args = _align_args(p + int(ties), p, p_max, cuda_device, ties)
    before = kernels.LAUNCHES["rank_align"]
    got = gcv.rank_align_kernel(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rank_align"] == before + 1
    want = gcv.rank_align_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_h_rejects_wrong_input(cuda_device):
    from kubernetes_tpu_torch.models import gangcover as gcv

    args = _align_args(0, 6, 8, cuda_device, False)
    with pytest.raises(ValueError, match="power of two"):
        gcv.rank_align_kernel(*(a[:6].contiguous() for a in args))
    with pytest.raises(TypeError, match="rank"):
        gcv.rank_align_kernel(args[0], args[1], args[2].long(), args[3])


@pytest.mark.gpu
def test_gang_wrappers_card_match_cpu(cuda_device):
    from kubernetes_tpu_torch.models import gangcover as gcv

    rng = np.random.default_rng(4)
    free = rng.integers(0, 40, size=(11, 3))
    head = rng.integers(0, 9, size=11)
    elig = rng.random(11) > 0.2
    vn = rng.integers(0, 11, size=17)
    vr = rng.integers(0, 9, size=(17, 3))
    req = np.array([3, 0, 2])
    assert np.array_equal(gcv.cover_curves(free, head, elig, vn, vr, req, device=cuda_device),
                          gcv.cover_curves(free, head, elig, vn, vr, req, device="cpu"))
    a = rng.integers(-1, 9, size=37)
    g = rng.integers(0, 4, size=37).astype(np.int32)
    r = rng.integers(0, 10, size=37)
    k = np.where(a >= 0, rng.integers(0, 10, size=37), 2**30)
    assert np.array_equal(gcv.rank_align(a, g, r, k, device=cuda_device),
                          gcv.rank_align(a, g, r, k, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["exact", "fast"])
def test_gang_scheduler_card_matches_cpu(cuda_device, solver):
    """A ranked gang that fits one slice only after evictions, beside one
    that fits free room: the card run evicts and places exactly as the CPU
    run, through kernels G and H."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore

    results = []
    for device in (cuda_device, torch.device("cpu")):
        store = APIStore()
        for s in range(3):
            for i in range(4):
                store.create("nodes", tt.MakeNode(f"node-{s}-{i}").tpu_slice(s, index=i)
                             .capacity({"cpu": "8", "memory": "32Gi"}).obj())
                if s < 2:
                    store.create("pods", tt.MakePod(f"low-{s}-{i}").priority(1 + s)
                                 .req({"cpu": "6"}).node(f"node-{s}-{i}").obj())
        sched = BatchScheduler(store, device=device, solver=solver)
        sched.preemption.async_preparation = False
        sched.sync()
        kernels.reset_launch_counts()
        for name, n in (("a", 8), ("b", 12), ("c", 8)):
            store.create("podgroups", tt.make_pod_group(name, n))
            store.create_many("pods", [tt.MakePod(f"{name}-{i}").gang(name, rank=n - 1 - i)
                                       .priority(100).req({"cpu": "3"}).obj()
                                       for i in range(n)])
        for _ in range(6):
            sched.run_until_idle()
        if device.type == "cuda":
            assert kernels.LAUNCHES["cover_curve"] > 0 and kernels.LAUNCHES["rank_align"] > 0
        pods, _ = store.list("pods")
        results.append(({p.metadata.name: p.spec.node_name for p in pods},
                        sched.gangpreempt.stats()))
    assert results[0] == results[1]
    assert results[0][1]["preempted"] >= 1


# ---------------------------------------------------------------------------
# kernel J (feasibility_rows), kernel E (auction_phase), kernel F (sinkhorn)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_kernel_j_matches_plain_on_card(cuda_device, workload):
    from kubernetes_tpu_torch.ops import kernels

    inp, _, _ = port_inputs(workload, cuda_device)
    args = (inp, inp.req, inp.req_nz, inp.class_of_pod, inp.balanced_active)
    before = kernels.LAUNCHES["feasibility_rows"]
    got = tsolver.feasibility_rows(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["feasibility_rows"] == before + 1
    want = tsolver.feasibility_rows_plain(*args)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_kernel_j_rejects_wrong_input(cuda_device):
    inp, _, _ = port_inputs(PARITY_WORKLOADS[0], cuda_device)
    with pytest.raises(TypeError, match="reqs"):
        tsolver.feasibility_rows(inp, inp.req.long(), inp.req_nz, inp.class_of_pod,
                                 inp.balanced_active)
    with pytest.raises(ValueError, match="clss"):
        tsolver.feasibility_rows(inp, inp.req, inp.req_nz, inp.class_of_pod[:1],
                                 inp.balanced_active)


def _phase_args(p, device, price0=None):
    g, n = p["utility"].shape
    t = {k: torch.from_numpy(v).to(device) for k, v in p.items()}
    price0 = torch.zeros(n) if price0 is None else torch.from_numpy(price0)
    return (t["utility"], t["jcap"], t["supply"], t["slots"], t["req"], t["free"],
            torch.zeros((g, n), dtype=torch.int32, device=device), price0.to(device),
            torch.full((g, n), -1e30, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [40.0, 0.9])
@pytest.mark.parametrize("case", [
    dict(g=3, n=24), dict(g=5, n=24, scarce=True), dict(g=3, n=24, ties=True),
    dict(g=1, n=400, supply_hi=5000), dict(g=5, n=24, dead_group=True), dict(g=2, n=10),
    dict(g=8, n=300, ties=True, scarce=True), dict(g=2100, n=40, supply_hi=8)],
    ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_kernel_e_matches_plain_on_card(cuda_device, case, eps):
    """Exact x, price, level and rounds; g=2100 puts 2G past the kernel's
    shared-memory key capacity (the global-memory merge), over 4 rounds (the
    plain version walks its 4,200 rows one by one)."""
    from kubernetes_tpu_torch.models import transport as ttr
    from kubernetes_tpu_torch.ops import kernels

    p = transport_problem(case["g"] + case["n"], **case)
    args = _phase_args(p, cuda_device)
    max_rounds = 4 if case["g"] > 2048 else 400
    before = kernels.LAUNCHES["auction_phase"]
    got = ttr._auction_phase(*args, eps, max_rounds)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["auction_phase"] == before + 1
    want = ttr._auction_phase_plain(*args, eps, max_rounds)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[3] == want[3]


@pytest.mark.gpu
@pytest.mark.parametrize("max_rounds", [1, 2, 9])
def test_kernel_e_warm_price_and_round_cut_on_card(cuda_device, max_rounds):
    from kubernetes_tpu_torch.models import transport as ttr

    p = transport_problem(5, g=4, n=64, ties=True)
    price0 = np.random.default_rng(1).integers(0, 5, size=64).astype(np.float32)
    args = _phase_args(p, cuda_device, price0)
    got = ttr._auction_phase(*args, 0.9, max_rounds)
    want = ttr._auction_phase_plain(*args, 0.9, max_rounds)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3] <= max_rounds


@pytest.mark.gpu
def test_kernel_e_rejects_wrong_input(cuda_device):
    from kubernetes_tpu_torch.models import transport as ttr

    args = list(_phase_args(transport_problem(0, g=2, n=8), cuda_device))
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError, match="utility"):
        ttr._auction_phase(*bad, 1.0, 5)
    bad = list(args)
    bad[5] = args[5][:, :2].contiguous()
    with pytest.raises(ValueError, match="free"):
        ttr._auction_phase(*bad, 1.0, 5)


def rel_err(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    if a.numel() == 0:
        return 0.0
    return float(((a - b).abs() / b.abs().clamp(min=1e-6)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("case", [dict(g=3, n=24), dict(g=5, n=300, scarce=True, supply_hi=200),
                                  dict(g=4, n=24, dead_group=True),
                                  dict(g=1, n=5000, supply_hi=4096)],
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_kernel_f_matches_plain_on_card(cuda_device, case, warm):
    from kubernetes_tpu_torch.models import transport as ttr
    from kubernetes_tpu_torch.ops import kernels

    p = transport_problem(case["g"] * 7 + case["n"], **case)
    rng = np.random.default_rng(3)
    g, n = p["utility"].shape
    cap = np.maximum(p["slots"].astype(np.float32) - rng.random(n).astype(np.float32), 0)
    g0 = (rng.random(n) * 50).astype(np.float32) if warm else np.zeros(n, np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (
        p["utility"], p["feasible"], p["supply"], cap, np.zeros(g, np.float32), g0)]
    before = kernels.LAUNCHES["sinkhorn"]
    got = ttr._sinkhorn_iters(*args, 2.0, 60)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sinkhorn"] == before + 1
    want = ttr._sinkhorn_iters_plain(*args, 2.0, 60)
    assert all(a.dtype == torch.float32 for a in got)
    # the duals after 60 iterations; the 60-iteration plan to 1e-4 (the
    # plan's exp turns a dual drift d of a few ulps into a relative error
    # ~d / eps: 1.53e-5 read on the scarce warm case) and the plan from the
    # same duals to 1e-5
    assert rel_err(got[0], want[0]) <= 1e-5 and rel_err(got[1], want[1]) <= 1e-5
    assert rel_err(got[2], want[2]) <= 1e-4
    same = args[:4] + [want[0], want[1]]
    got0 = ttr._sinkhorn_iters(*same, 2.0, 0)
    want0 = ttr._sinkhorn_iters_plain(*same, 2.0, 0)
    assert torch.equal(got0[0], want[0]) and torch.equal(got0[1], want[1])
    assert rel_err(got0[2], want0[2]) <= 1e-5


@pytest.mark.gpu
def test_kernel_f_rejects_wrong_input(cuda_device):
    from kubernetes_tpu_torch.models import transport as ttr

    args = [torch.zeros((2, 4), device=cuda_device), torch.ones((2, 4), dtype=torch.bool,
                                                              device=cuda_device),
            torch.ones(2, dtype=torch.int32, device=cuda_device),
            torch.ones(4, device=cuda_device), torch.zeros(2, device=cuda_device),
            torch.zeros(4, device=cuda_device)]
    bad = list(args)
    bad[2] = args[2].long()
    with pytest.raises(TypeError, match="supply"):
        ttr._sinkhorn_iters(*bad, 2.0, 3)
    bad = list(args)
    bad[5] = args[5][:3].contiguous()
    with pytest.raises(ValueError, match="g0"):
        ttr._sinkhorn_iters(*bad, 2.0, 3)


# kernels E and F are one thread-block cluster a call: the shapes around the
# cluster (fewer nodes than CTAs, a node count no multiple of it, ties across
# CTA boundaries), the round cuts, a warm start that overfills nodes, and the
# layouts whose regions leave shared memory; one CUDA launch a call (and, for
# E, one host read)


def _counts(kernels, name):
    return (kernels.LAUNCHES[name], kernels.CUDA_LAUNCHES[name], kernels.HOST_SYNCS[name])


def _cluster_auction(args, eps, max_rounds):
    from kubernetes_tpu_torch.models import transport as ttr
    from kubernetes_tpu_torch.ops import kernels

    before = _counts(kernels, "auction_phase")
    got = ttr._auction_phase(*args, eps, max_rounds)
    torch.cuda.synchronize()
    after = _counts(kernels, "auction_phase")
    assert tuple(b - a for a, b in zip(before, after)) == (1, 1, 1)
    want = ttr._auction_phase_plain(*args, eps, max_rounds)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[3] == want[3]
    return got, dict(kernels.LAST_AUCTION_PLAN)


E_CLUSTER_CASES = {
    "n1": dict(g=2, n=1), "n7": dict(g=3, n=7), "n300_ragged": dict(g=5, n=300, scarce=True),
    "n5000_g1": dict(g=1, n=5000, supply_hi=4096), "g12_n500": dict(g=12, n=500, scarce=True),
    "identical_utilities": dict(g=4, n=600, supply_hi=200),
}


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [40.0, 0.9])
@pytest.mark.parametrize("case", sorted(E_CLUSTER_CASES))
def test_kernel_e_cluster_shapes_on_card(cuda_device, case, eps):
    p = transport_problem(len(case), **E_CLUSTER_CASES[case])
    if case == "identical_utilities":  # top-16 ties span CTAs: lowest indices win
        p["utility"][:] = 7.0
    _, plan = _cluster_auction(_phase_args(p, cuda_device), eps, 400)
    assert plan["nodes_per_cta"] == -(-p["utility"].shape[1] // plan["cluster_size"])


@pytest.mark.gpu
@pytest.mark.parametrize("max_rounds", [0, 1, 2, 3])
def test_kernel_e_round_cuts_on_card(cuda_device, max_rounds):
    p = transport_problem(21, g=6, n=300, scarce=True)
    got, _ = _cluster_auction(_phase_args(p, cuda_device), 0.9, max_rounds)
    assert got[3] <= max_rounds


@pytest.mark.gpu
@pytest.mark.parametrize("max_rounds", [1, 2, 400])
@pytest.mark.parametrize("seed", range(3))
def test_kernel_e_overfilled_warm_start_on_card(cuda_device, seed, max_rounds):
    """An x0 that overfills nodes (and a negative cell): round 1 re-walks
    every node that holds units, as the reference's knapsack does."""
    p = transport_problem(30 + seed, g=5, n=300, scarce=True)
    x0, level0 = tt.overfilled_start(p, seed)
    args = list(_phase_args(p, cuda_device))
    args[6], args[8] = (torch.from_numpy(a).to(cuda_device) for a in (x0, level0))
    _cluster_auction(tuple(args), 0.9, max_rounds)


@pytest.mark.gpu
def test_kernel_e_global_exchange_on_card(cuda_device):
    """G 2,100: the exchange and the candidates leave shared memory."""
    p = transport_problem(40, g=2100, n=40, supply_hi=8)
    _, plan = _cluster_auction(_phase_args(p, cuda_device), 0.9, 4)
    assert "exchange" in plan["in_global"] and "candidates" in plan["in_global"]


def _cluster_sinkhorn(p, device, warm, iters=60):
    from kubernetes_tpu_torch.models import transport as ttr
    from kubernetes_tpu_torch.ops import kernels

    rng = np.random.default_rng(5)
    g, n = p["utility"].shape
    cap = np.maximum(p["slots"].astype(np.float32) - rng.random(n).astype(np.float32), 0)
    g0 = (rng.random(n) * 50).astype(np.float32) if warm else np.zeros(n, np.float32)
    args = [torch.from_numpy(a).to(device) for a in (
        p["utility"], p["feasible"], p["supply"], cap, np.zeros(g, np.float32), g0)]
    before = _counts(kernels, "sinkhorn")
    got = ttr._sinkhorn_iters(*args, 2.0, iters)
    torch.cuda.synchronize()
    after = _counts(kernels, "sinkhorn")
    assert tuple(b - a for a, b in zip(before, after)) == (1, 1, 0)
    plan = dict(kernels.LAST_SINKHORN_PLAN)
    want = ttr._sinkhorn_iters_plain(*args, 2.0, iters)
    assert rel_err(got[0], want[0]) <= 1e-5 and rel_err(got[1], want[1]) <= 1e-5
    assert rel_err(got[2], want[2]) <= 1e-4
    same = args[:4] + [want[0], want[1]]
    got0 = ttr._sinkhorn_iters(*same, 2.0, 0)
    want0 = ttr._sinkhorn_iters_plain(*same, 2.0, 0)
    assert torch.equal(got0[0], want[0]) and torch.equal(got0[1], want[1])
    assert rel_err(got0[2], want0[2]) <= 1e-5
    return plan


F_CLUSTER_CASES = {
    "n1": dict(g=3, n=1), "n7": dict(g=2, n=7), "n300_ragged": dict(g=8, n=300, scarce=True),
    "g1_n10000": dict(g=1, n=10000, supply_hi=4096),
}


@pytest.mark.gpu
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("case", sorted(F_CLUSTER_CASES))
def test_kernel_f_cluster_shapes_on_card(cuda_device, case, warm):
    p = transport_problem(len(case) + 50, **F_CLUSTER_CASES[case])
    plan = _cluster_sinkhorn(p, cuda_device, warm)
    assert plan["order"]["exact"]  # torch's order, so the duals match bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("region", ["z", "exchange"])
def test_kernel_f_regions_beyond_shared_memory_on_card(cuda_device, region):
    """G 128 x N 10,000 puts z in the global slice; at N 40 the slots
    of 2,100 groups (16 CTAs) or 3,600 (8 CTAs) leave shared memory."""
    from kubernetes_tpu_torch.ops import kernels

    if region == "z":
        case = dict(g=128, n=10000, scarce=True)
    else:
        cs = kernels._cluster_size(kernels._lib("sinkhorn"), "sinkhorn")
        case = dict(g=2100 if cs == 16 else 3600, n=40)
    plan = _cluster_sinkhorn(transport_problem(60, supply_hi=200, **case), cuda_device, True)
    assert region in plan["in_global"]


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["auction", "sinkhorn"])
def test_transport_scheduler_card_matches_cpu(cuda_device, solver):
    """Several batches (warm duals across them) of a node-selector mix: the
    card run through kernels J and E or F places as the CPU run."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore

    results = []
    for device in (cuda_device, torch.device("cpu")):
        store = APIStore()
        for i in range(40):
            store.create("nodes", tt.MakeNode(f"n{i}").labels({"disk": "ssd" if i % 2 == 0
                                                                else "hdd"})
                         .capacity({"cpu": "8", "memory": "16Gi", "pods": "30"}).obj())
        sched = BatchScheduler(store, device=device, solver=solver, batch_size=64)
        sched.sync()
        kernels.reset_launch_counts()
        shapes = [("100m", "128Mi"), ("250m", "512Mi"), ("500m", "1Gi"), ("1000m", "2Gi")]
        pods = []
        for i in range(300):
            b = tt.MakePod(f"p{i}").req({"cpu": shapes[i % 4][0], "memory": shapes[i % 4][1]})
            if i % 4 == 0:
                b = b.node_selector({"disk": "ssd"})
            pods.append(b.obj())
        store.create_many("pods", pods)
        sched.run_until_idle()
        if device.type == "cuda":
            assert kernels.LAUNCHES["feasibility_rows"] > 0
            assert kernels.LAUNCHES["auction_phase" if solver == "auction" else "sinkhorn"] > 0
        got, _ = store.list("pods")
        results.append(({p.metadata.name: p.spec.node_name for p in got},
                        sched._solve_path, sched.breaker.failures_total))
    assert results[0][1] == results[1][1] == solver
    assert results[0][2] == results[1][2] == 0
    card, cpu = results[0][0], results[1][0]
    assert sum(1 for v in card.values() if v) == sum(1 for v in cpu.values() if v) == 300
    if solver == "auction":
        assert card == cpu


# ---------------------------------------------------------------------------
# kernel I (defrag_assign) and the rebalancer
# ---------------------------------------------------------------------------


def _defrag_check(args, device):
    from kubernetes_tpu_torch.models import defrag as dfg
    from kubernetes_tpu_torch.ops import kernels

    t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args)
    before = kernels.LAUNCHES["defrag_assign"]
    got = dfg.defrag_assign(*t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["defrag_assign"] == before + 1
    want = dfg.defrag_assign_plain(*t)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return got.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("ns,v,r,n_slots", [
    (5000, 250, 3, None),  # (a) the main path's shape: n_slots 8,192, v_max 256
    (5000, 1024, 3, None),  # (b) the cap, DEFRAG_MAX_VICTIMS victims
    (5000, 700, 4, None),
    (20000, 300, 4, 32768),  # (d) beyond the shared-memory path: the global copy
    (3, 9, 1, None),
], ids=["a_main_path", "b_cap", "b_r4", "d_global_state", "tiny"])
def test_kernel_i_matches_plain_on_card(cuda_device, ns, v, r, n_slots):
    args = tt.defrag_problem(ns + v + r, ns, v, r=r, n_slots=n_slots)
    got = _defrag_check(args, cuda_device)
    if v >= 250:  # some victims placed, some unplaceable
        assert (got[:v] >= 0).any() and (got[:v] < 0).any()
    from kubernetes_tpu_torch.models.defrag import defrag_assign_host

    free, head, ok, v_req, _valid = args
    assert np.array_equal(got[:v], defrag_assign_host(free, head, ok, v_req[:v]))
    assert (got[v:] == -1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(tt.defrag_edge_cases()))
def test_kernel_i_edge_cases_on_card(cuda_device, name):
    """(c): ties, headroom 0, no target, pad rows and slots, negative free,
    a wrapping waste sum."""
    _defrag_check(tt.defrag_edge_cases()[name], cuda_device)


@pytest.mark.gpu
def test_kernel_i_rejects_wrong_input(cuda_device):
    from kubernetes_tpu_torch.models import defrag as dfg

    args = [torch.from_numpy(a).to(cuda_device) for a in tt.defrag_problem(0, 8, 4)]
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(TypeError, match="free"):
        dfg.defrag_assign(*bad)
    bad = list(args)
    bad[3] = args[3][:, :2].contiguous()
    with pytest.raises(ValueError, match="v_req"):
        dfg.defrag_assign(*bad)
    bad = list(args)
    bad[2] = args[2].cpu()
    with pytest.raises(ValueError, match="target_ok"):
        dfg.defrag_assign(*bad)


@pytest.mark.gpu
def test_rebalancer_card_matches_cpu(cuda_device):
    """One fragmented cluster consolidated on the card (kernel I) and on the
    CPU (the plain version): the same cycles, stats and {pod: node} map."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore

    def run(device):
        store = APIStore()
        for s in range(4):
            for i in range(16):
                store.create("nodes", tt.MakeNode(f"node-{s}-{i}").tpu_slice(s, index=i)
                             .capacity({"cpu": "8", "memory": "32Gi", "pods": "110"}).obj())
                store.create("pods", tt.MakePod(f"low-{s}-{i}").priority(1 + i % 3)
                             .req({"cpu": f"{1 + (s + i) % 4}", "memory": "1Gi"})
                             .node(f"node-{s}-{i}").obj())
        sched = BatchScheduler(store, device=device, solver="fast")
        sched.sync()
        rb = sched.enable_rebalancer(frag_threshold=0.1, budget_per_wave=8,
                                     budget_per_cycle=24, priority_ceiling=50)
        cycles = []
        for _ in range(6):
            cycles.append(rb.cycle())
            sched.pump_events()
        rb.release()
        return (cycles, rb.stats(), sorted(rb._moves.items()),
                sorted((p.metadata.name, p.spec.node_name) for p in store.list("pods")[0]))

    before = kernels.LAUNCHES["defrag_assign"]
    card = run(cuda_device)
    assert kernels.LAUNCHES["defrag_assign"] > before
    assert card == run(torch.device("cpu"))
    assert card[1]["migrations"] > 0


# ---------------------------------------------------------------------------
# kernels J and I redesigned: one cluster a row tile; the tournament tree
# ---------------------------------------------------------------------------


def _j_problem(seed, n, rows, device, wide_ports=False):
    from kubernetes_tpu_torch.ops.convert import solver_inputs_from_numpy

    f, _ = tt.scan_problem(seed, n, rows)
    if wide_ports:  # 300 port columns, one class setting most of them
        rng = np.random.default_rng(seed)
        f["class_ports"] = rng.random((f["class_ports"].shape[0], 300)) < 0.1
        f["class_ports"][1] = rng.random(300) < 0.95
        f["node_ports"] = rng.random((n, 300)) < 0.004
    f["class_of_pod"][::5] = -1
    inp = solver_inputs_from_numpy(f, device)
    return f, (inp, inp.req, inp.req_nz, inp.class_of_pod, inp.balanced_active)


def _j_check(args, device):
    from kubernetes_tpu_torch.ops import kernels

    before = (kernels.LAUNCHES["feasibility_rows"], kernels.CUDA_LAUNCHES["feasibility_rows"])
    got = tsolver.feasibility_rows(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["feasibility_rows"] == before[0] + 1
    assert kernels.CUDA_LAUNCHES["feasibility_rows"] == before[1] + 1
    want = tsolver.feasibility_rows_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got, dict(kernels.LAST_FEASIBILITY_PLAN)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [37, 5000, 5001])
@pytest.mark.parametrize("rows", [1, 8, 13, 512])
def test_kernel_j_cluster_rows_match_plain_on_card(cuda_device, rows, n):
    f, args = _j_problem(rows * 7 + n, n, rows, cuda_device)
    got, plan = _j_check(args, cuda_device)
    assert plan["clusters"] <= rows
    assert plan["passes"] == -(-rows // plan["clusters"])
    assert plan["ctas"] == plan["cluster_size"] * plan["clusters"]
    model = tt.feasibility_tiles_model(f, f["req"], f["req_nz"], f["class_of_pod"],
                                       f["balanced_active"], tiles=plan["cluster_size"])
    np.testing.assert_array_equal(got[0].cpu().numpy(), model[0])
    np.testing.assert_array_equal(got[1].cpu().numpy(), model[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,rows", [(70000, 3), (300, 13)], ids=["beyond_registers",
                                                                 "wide_ports"])
def test_kernel_j_global_nodes_and_port_overflow_on_card(cuda_device, n, rows):
    """Nodes beyond a thread's registers (70,000 nodes: more than one a
    thread, the rest read from global memory) and 300 port columns, one
    class setting most of them."""
    _, args = _j_problem(n + rows, n, rows, cuda_device, wide_ports=n == 300)
    _, plan = _j_check(args, cuda_device)
    if n == 70000:
        from kubernetes_tpu_torch.ops import kernels

        assert plan["nodes_per_thread"] > 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(tt.DEFRAG_RUNS))
def test_kernel_i_tree_matches_plain_on_request_runs(cuda_device, name):
    from kubernetes_tpu_torch.ops import kernels

    args = tt.defrag_run_case(name)
    before = kernels.CUDA_LAUNCHES["defrag_assign"]
    got = _defrag_check(args, cuda_device)
    assert kernels.CUDA_LAUNCHES["defrag_assign"] == before + 1
    want, counts = tt.defrag_tree_model(*args)
    np.testing.assert_array_equal(got, want)
    # the kernel's own count of its schedule
    assert kernels.LAST_DEFRAG_COUNTS.tolist() == [counts["rebuilds"], counts["leaf_updates"]]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cap", "global_state", "one_request"])
def test_kernel_i_tree_on_cap_and_global_state_on_card(cuda_device, case):
    from kubernetes_tpu_torch.ops import kernels

    if case == "cap":
        args = tt.defrag_problem(21, 5000, 1024)
    elif case == "global_state":
        args = tt.defrag_request_runs(22, 30000, 256, r=4, n_slots=32768)
    else:  # Defrag_5000's cycle: every victim the 3-cpu filler
        args = tt.defrag_request_runs(23, 5000, 250, max_run=1000, pads=0.0)
        args[3][:] = np.array([3000, 0, 0], np.int32)
        args[4][:250] = True
    before = kernels.CUDA_LAUNCHES["defrag_assign"]
    got = _defrag_check(args, cuda_device)
    assert kernels.CUDA_LAUNCHES["defrag_assign"] == before + 1
    plan = kernels.LAST_DEFRAG_PLAN
    assert plan["state"] == ("global" if case == "global_state" else "shared")
    want, counts = tt.defrag_tree_model(*args)
    np.testing.assert_array_equal(got, want)
    assert kernels.LAST_DEFRAG_COUNTS.tolist() == [counts["rebuilds"], counts["leaf_updates"]]


@pytest.mark.gpu
def test_kernel_i_groups_of_many_quads_on_card(cuda_device):
    """1,048,576 slots: leaves of 8,192 slots (64 quads a lane), the state
    in the global scratch."""
    from kubernetes_tpu_torch.ops import kernels

    args = tt.defrag_request_runs(24, 1 << 20, 16, max_run=4, pads=0.0)
    got = _defrag_check(args, cuda_device)
    assert kernels.LAST_DEFRAG_PLAN["group"] == 8192
    assert kernels.LAST_DEFRAG_PLAN["state"] == "global"
    np.testing.assert_array_equal(got, tt.defrag_tree_model(*args)[0])
