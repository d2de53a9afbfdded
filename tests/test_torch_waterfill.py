"""The port's waterfill (models/waterfill.py) against the JAX package's, on the CPU.

waterfill_group_plain and the JAX waterfill_group take the same seeded
numpy inputs (made with numpy, handed to both); bucket_j_max and make_groups
are compared on the same host arrays; waterfill_solve runs on JAX-built
inputs carried across with ops/convert.py for every workload of
tests/test_torch_workloads.py. Tolerance: exact equality of every int32
output, chosen_nodes compared in order. Kernel C itself is held against the
plain version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_solver import jax_inputs
from test_torch_workloads import MIXED_WORKLOADS, PARITY_WORKLOADS, unpack

import kubernetes_tpu.scheduler  # noqa: F401  (import order: scheduler before snapshot)
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.models import waterfill as jwf
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.snapshot.tensorizer import build_cluster_tensors as j_build_cluster
from kubernetes_tpu.snapshot.tensorizer import build_pod_batch as j_build_batch
from kubernetes_tpu.utils import FakeClock
from kubernetes_tpu_torch.models import waterfill as twf
from kubernetes_tpu_torch.ops.convert import solver_inputs_from_numpy
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.snapshot import tensorizer as ttz

CPU = torch.device("cpu")
ROWS = ("alloc", "used", "used_nz", "pod_count", "max_pods", "filter_ok_row",
        "port_conflict_row", "has_port", "napref_row", "has_napref", "taint_row", "img_row",
        "req", "req_nz", "bal_active", "group_size")


def random_group(seed, n=40, r=3, j_max=8, k_slots=None, group=None, ports=False,
                 gang=False, overcommit=False, napref=True, zero_req=False):
    """Seeded inputs of one waterfill_group call (numpy), JAX argument order."""
    rng = np.random.default_rng(seed)
    alloc = rng.integers(1000, 8000, size=(n, r)).astype(np.int32)
    alloc[rng.random(n) < 0.1, 1] = 0  # a node without the resource
    used = (alloc * rng.random((n, r)) * 0.8).astype(np.int32)
    if overcommit:  # a foreign bind: free < 0 on a few nodes
        hot = rng.choice(n, size=max(n // 8, 1), replace=False)
        used[hot] = alloc[hot] + rng.integers(1, 900, size=(hot.size, r)).astype(np.int32)
    req = rng.integers(50, 900, size=r).astype(np.int32)
    if zero_req:
        req[rng.integers(0, r)] = 0
    max_pods = rng.integers(j_max // 2 + 1, 3 * j_max + 2, size=n).astype(np.int32)
    slots = n * j_max
    if group is None:
        group = int(rng.integers(1, slots + 1))
    if k_slots is None:
        k_slots = twf.k_slots_for(group, n, j_max)
    a = dict(
        alloc=alloc, used=used,
        used_nz=np.maximum(used, rng.integers(0, 300, size=(n, r))).astype(np.int32),
        pod_count=rng.integers(0, j_max, size=n).astype(np.int32), max_pods=max_pods,
        filter_ok_row=rng.random(n) < 0.85,
        port_conflict_row=rng.random(n) < 0.3 if ports else np.zeros(n, bool),
        has_port=ports,
        napref_row=rng.integers(0, 60, size=n).astype(np.int32),
        has_napref=np.asarray(napref),
        taint_row=rng.integers(0, 4, size=n).astype(np.int32),
        img_row=rng.integers(0, 30, size=n).astype(np.int32),
        req=req, req_nz=np.maximum(req, 100).astype(np.int32),
        bal_active=np.asarray(bool(rng.random() < 0.8)), group_size=group)
    gang_row = rng.integers(0, 100, size=n).astype(np.int32) if gang else None
    return a, j_max, k_slots, gang_row


def jax_group(a, j_max, k_slots, gang_row):
    args = [jnp.asarray(a[k]) if k not in ("has_port", "group_size") else a[k] for k in ROWS]
    args[-1] = jnp.int32(a["group_size"])
    k, c = jwf.waterfill_group(*args, j_max=j_max, k_slots=k_slots,
                               gang_row=None if gang_row is None else jnp.asarray(gang_row),
                               has_gang=gang_row is not None)
    return np.asarray(k), np.asarray(c)


def port_group(a, j_max, k_slots, gang_row, device=CPU, fn=None):
    fn = fn or twf.waterfill_group_plain
    args = [a[k] if k in ("has_port", "group_size") else torch.from_numpy(np.array(a[k])).to(device)
            for k in ROWS]
    k, c = fn(*args, j_max, k_slots,
              None if gang_row is None else torch.from_numpy(gang_row).to(device),
              gang_row is not None)
    assert k.dtype == torch.int32 and c.dtype == torch.int32
    return k.cpu().numpy(), c.cpu().numpy()


CASES = [
    dict(j_max=1),
    dict(j_max=4),
    dict(j_max=8, ports=True),
    dict(j_max=16, gang=True),
    dict(j_max=8, overcommit=True),
    dict(j_max=8, napref=False, zero_req=True),
    dict(j_max=4, group=3),  # below the 256 floor: k_slots > group
    dict(j_max=32, n=64, group=2048, k_slots=2048),  # k_slots == n * j_max
    dict(j_max=8, ports=True, gang=True, overcommit=True, group=100),
]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_group_matches_jax(case, seed):
    a, j_max, k_slots, gang_row = random_group(seed * 101 + case, **CASES[case])
    jk, jc = jax_group(a, j_max, k_slots, gang_row)
    tk, tc = port_group(a, j_max, k_slots, gang_row)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)  # in greedy order, not as a set
    assert int((tc >= 0).sum()) == int(tk.sum()) <= a["group_size"]


def test_dispatcher_routes_cpu_to_plain():
    a, j_max, k_slots, gang_row = random_group(5, j_max=8, gang=True)
    want = port_group(a, j_max, k_slots, gang_row)
    got = port_group(a, j_max, k_slots, gang_row, fn=twf.waterfill_group)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    meta = torch.empty((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        twf.waterfill_group(meta, *([None] * 17))


@pytest.mark.parametrize("max_pods,pod_count,n,max_slots,cap_hint", [
    ([110] * 5, [0] * 5, 5000, 2_600_000, None),
    ([110] * 5, [100] * 5, 30_000, 2_600_000, None),  # dynamic headroom bucket
    ([110] * 5, [30] * 5, 30_000, 2_600_000, None),  # raw headroom
    ([110] * 5, [0] * 5, 30_000, 2_600_000, None),  # None: decline to the scan
    ([110] * 5, [0] * 5, 5000, 1_900_000, 40),  # the repair path's cap hint
    ([7, 3], [1, 0], 100, 1000, 2),
    ([], [], 1, 10, None),
])
def test_bucket_j_max_matches_jax(max_pods, pod_count, n, max_slots, cap_hint):
    mp, pc = np.asarray(max_pods, np.int32), np.asarray(pod_count, np.int32)
    want = jwf.bucket_j_max(jnp.asarray(mp), jnp.asarray(pc), n, max_slots, cap_hint=cap_hint)
    got = twf.bucket_j_max(torch.from_numpy(mp), torch.from_numpy(pc), n, max_slots,
                           cap_hint=cap_hint)
    assert got == want


def _both_batches(workload):
    nodes, pods, bound = unpack(workload(jt))
    jc = JCache(clock=FakeClock())
    for o in nodes:
        jc.add_node(o)
    for o in bound:
        jc.add_pod(o)
    jsnap = jc.update_snapshot()
    jb = j_build_batch(pods, jsnap, j_build_cluster(jsnap))
    nodes, pods, bound = unpack(workload(tt))
    tc = TCache()
    for o in nodes:
        tc.add_node(o)
    for o in bound:
        tc.add_pod(o)
    tsnap = tc.update_snapshot()
    tb = ttz.build_pod_batch(pods, tsnap, ttz.build_cluster_tensors(tsnap))
    return jb, tb


@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_make_groups_and_waterfill_solve_match_jax(workload):
    jb, tb = _both_batches(workload)
    jg, tg = jwf.make_groups(jb), twf.make_groups(tb)
    assert [(m.tolist(), c) for m, c in tg] == [(m.tolist(), c) for m, c in jg]
    inp, _, _, fields = jax_inputs(workload)
    want = jwf.waterfill_solve(inp, jg)
    got = twf.waterfill_solve(solver_inputs_from_numpy(fields, CPU), jg)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_waterfill_solve_declines_past_the_key_range():
    inp, _, _, fields = jax_inputs(PARITY_WORKLOADS[0])
    fields = dict(fields, max_pods=np.full_like(fields["max_pods"], 1 << 20))
    fields["pod_count"] = np.zeros_like(fields["pod_count"])
    tinp = solver_inputs_from_numpy(fields, CPU)
    jinp = inp._replace(max_pods=jnp.asarray(fields["max_pods"]),
                        pod_count=jnp.asarray(fields["pod_count"]))
    groups = [(np.arange(3), 0)]
    assert jwf.waterfill_solve(jinp, groups) is None
    assert twf.waterfill_solve(tinp, groups) is None
