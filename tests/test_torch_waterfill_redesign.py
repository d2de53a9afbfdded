"""Kernel C's redesign, on the CPU: the selection over sorted key rows.

Kernel C (csrc/waterfill.cu, one thread-block-cluster launch a group) rests
on one property of the plain version's keys: each node's valid keys are a
prefix of its row, strictly descending. The tests assert that property on
seeded groups and hold testing.waterfill_select_model (the kernel's
selection in numpy: a threshold from radix passes over run-counted
histograms, c_n by binary search, per-CTA sorted lists merged by rank) equal
to waterfill_group_plain and to the JAX package's waterfill_group: ports,
preferred node affinity, taints, a gang row, over-committed nodes, k_slots
above 4,096, groups below the 256-slot floor, zero valid keys, and both
cluster sizes. Tolerance: exact equality, chosen_nodes in order. The kernel
itself is held against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from test_torch_waterfill import ROWS, jax_group, port_group, random_group

import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.models import waterfill as jwf
from kubernetes_tpu_torch.models import waterfill as twf

CASES = {
    "plain": dict(j_max=8),
    "ports": dict(j_max=8, ports=True),
    "napref_taints_gang": dict(j_max=16, gang=True),
    "overcommit": dict(j_max=8, overcommit=True),
    "no_napref_zero_req": dict(j_max=8, napref=False, zero_req=True),
    "below_256_floor": dict(j_max=4, group=3),
    "k_slots_above_4096": dict(n=300, j_max=32, group=5000),
    "k_slots_all_slots": dict(n=64, j_max=32, group=2048, k_slots=2048),
    "everything": dict(j_max=8, ports=True, gang=True, overcommit=True, group=100),
    "one_node": dict(n=1, j_max=16, group=9),
}


def _keys(a, j_max, gang_row):
    args = [a[k] if k in ("has_port", "group_size") else torch.from_numpy(np.array(a[k]))
            for k in ROWS if k != "group_size"]
    key = twf.waterfill_keys_plain(*args, j_max,
                                   None if gang_row is None else torch.from_numpy(gang_row),
                                   gang_row is not None)
    assert key.dtype == torch.int32 and key.shape == (a["alloc"].shape[0], j_max)
    return key.numpy()


def _assert_sorted_prefix_rows(key):
    valid = key > twf.SENTINEL
    lens = valid.sum(axis=1)
    for i, ln in enumerate(lens):
        assert valid[i, :ln].all() and not valid[i, ln:].any()  # a prefix
        assert (np.diff(key[i, :ln].astype(np.int64)) < 0).all()  # strictly descending


@pytest.mark.parametrize("cs", [16, 8])
@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", sorted(CASES))
def test_selection_model_matches_plain_and_jax(case, seed, cs):
    a, j_max, k_slots, gang_row = random_group(seed * 31 + sorted(CASES).index(case),
                                               **CASES[case])
    key = _keys(a, j_max, gang_row)
    _assert_sorted_prefix_rows(key)
    mk, mc = tt.waterfill_select_model(key, a["group_size"], k_slots, cs=cs)
    pk, pc = port_group(a, j_max, k_slots, gang_row)
    jk, jc = jax_group(a, j_max, k_slots, gang_row)
    np.testing.assert_array_equal(mk, pk)
    np.testing.assert_array_equal(mc, pc)  # in greedy order
    np.testing.assert_array_equal(mk, jk)
    np.testing.assert_array_equal(mc, jc)


def test_zero_valid_keys_choose_nothing():
    a, j_max, k_slots, gang_row = random_group(7, j_max=8, group=40)
    a["filter_ok_row"] = np.zeros_like(a["filter_ok_row"])
    key = _keys(a, j_max, gang_row)
    assert (key == twf.SENTINEL).all()
    mk, mc = tt.waterfill_select_model(key, a["group_size"], k_slots)
    pk, pc = port_group(a, j_max, k_slots, gang_row)
    jk, jc = jax_group(a, j_max, k_slots, gang_row)
    for x, y, z in ((mk, pk, jk), (mc, pc, jc)):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert not mk.any() and (mc == -1).all()


@pytest.mark.parametrize("group", [0, 1, 37])
def test_group_smaller_than_the_valid_keys(group):
    """m = min(valid, group, k_slots): the group bounds the placements."""
    a, j_max, k_slots, gang_row = random_group(11, j_max=8, group=max(group, 1))
    a["group_size"] = group
    key = _keys(a, j_max, gang_row)
    mk, mc = tt.waterfill_select_model(key, group, k_slots)
    pk, pc = port_group(a, j_max, k_slots, gang_row)
    np.testing.assert_array_equal(mk, pk)
    np.testing.assert_array_equal(mc, pc)
    assert int(mk.sum()) == min(group, int((key > twf.SENTINEL).sum()))


def test_solve_reads_the_placements_once_a_batch(monkeypatch):
    """waterfill_solve reads the groups' placements to the host once a
    batch, not once a group (counted through models/waterfill.host: its
    other reads are the slot-depth bucket's and the class ports', before the
    groups)."""
    from test_torch_solver import jax_inputs
    from test_torch_workloads import PARITY_WORKLOADS

    from kubernetes_tpu_torch.ops.convert import solver_inputs_from_numpy

    jinp, _, _, fields = jax_inputs(PARITY_WORKLOADS[0])
    inp = solver_inputs_from_numpy(fields, torch.device("cpu"))
    p = inp.req.shape[0]
    groups = [(np.arange(i, min(i + 3, p)), 0) for i in range(0, min(p, 9), 3)]
    assert len(groups) >= 2
    reads = []
    real = twf.host
    monkeypatch.setattr(twf, "host", lambda x: reads.append(x) or real(x))
    got = twf.waterfill_solve(inp, groups)
    placements = [x for x in reads if isinstance(x, torch.Tensor) and x.dtype == torch.int32
                  and x.dim() == 1 and x.shape[0] == sum(len(m) for m, _ in groups)]
    assert len(placements) == 1
    np.testing.assert_array_equal(got, np.asarray(jwf.waterfill_solve(jinp, groups)))


def test_kernel_wrapper_raises_where_keys_may_wrap():
    """Kernel C's rows are sorted only while keys do not wrap int32: the
    wrapper refuses an N*j_max beyond every caller's slot budget before it
    touches a tensor (no reroute to the plain version)."""
    from kubernetes_tpu_torch.ops import kernels

    a, _, _, _ = random_group(3, n=4, j_max=8)
    args = [a[k] if k in ("has_port", "group_size") else torch.from_numpy(np.array(a[k]))
            for k in ROWS]
    j_max = kernels.WATERFILL_MAX_SLOTS // 4 + 1
    with pytest.raises(ValueError, match="wrap"):
        kernels.launch_waterfill_group(*args, j_max=j_max, k_slots=256)
    with pytest.raises(ValueError, match="k_slots"):
        kernels.launch_waterfill_group(*args, j_max=8, k_slots=4 * 8 + 1)
