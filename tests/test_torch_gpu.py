"""Card-only tests of the port's kernels (marked `gpu`; skip without a card).

Run on the card with `python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py` (tests/conftest.py configures JAX, which the card's
machine need not have; this file imports neither jax nor the JAX package).
Kernel A (greedy_scan) and kernel B (row_scatter) are held against their
plain PyTorch versions on the same card tensors, built by the port's own
tensorizer: exact equality.
"""

import numpy as np
import pytest
import torch
from test_torch_workloads import (MIXED_WORKLOADS, PARITY_WORKLOADS, check_mirrors_after_churn,
                                  unpack)

import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.scheduler.cache import Cache
from kubernetes_tpu_torch.snapshot import tensorizer as ttz


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


@pytest.mark.gpu
@pytest.mark.parametrize("workload", MIXED_WORKLOADS[:2] + [PARITY_WORKLOADS[1]],
                         ids=lambda w: w.__name__)
def test_batch_scheduler_card_matches_cpu(cuda_device, workload):
    """The scheduler on the card places exactly as its CPU (plain) run."""
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
        sched = BatchScheduler(store, device=device, batch_size=9)
        sched.sync()
        sched.run_until_idle()
        got, _ = store.list("pods")
        maps.append({p.metadata.name: p.spec.node_name for p in got})
    assert maps[0] == maps[1]
