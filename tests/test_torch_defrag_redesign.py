"""Kernel I's redesign, on the CPU: the defrag best fit over a tournament tree.

Kernel I (csrc/defrag_assign.cu) keeps a tree of packed keys (ord(key) << 32
| slot) over the carried slot state: a victim whose request differs from the
tree's rebuilds it, one with the tree's request reads the root after the
last placement's target has had its path recomputed, and an unplaced or pad
victim changes nothing. testing.defrag_tree_model is that schedule in numpy;
these tests hold it equal to defrag_assign_plain, to defrag_assign_host (on
the valid victims, where the int32 waste sum does not wrap) and to the JAX
package's defrag_assign scan on seeded runs of identical requests of length
1-64 with ties, headroom 0, no target, pads in the middle of a run, negative
free and a wrapping sum, and on the existing edge cases. Tolerance: exact
equality (int32 targets).
"""

import numpy as np
import pytest
import torch

import kubernetes_tpu.models.defrag as jdefrag
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu_torch.models import defrag as tdefrag
from kubernetes_tpu_torch.ops import kernels

RUNS = tt.DEFRAG_RUNS
_case = tt.defrag_run_case


def _jax(args):
    n_slots, v_max = args[0].shape[0], args[3].shape[0]
    return np.asarray(jdefrag.defrag_assign(*args, n_slots=n_slots, v_max=v_max))


def _plain(args):
    out = tdefrag.defrag_assign_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                        for a in args))
    assert out.dtype == torch.int32
    return out.numpy()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tree_model_matches_plain_and_jax_on_request_runs(name):
    args = _case(name)
    got, counts = tt.defrag_tree_model(*args)
    np.testing.assert_array_equal(got, _plain(args))
    np.testing.assert_array_equal(got, _jax(args))
    assert counts["root_reads"] + counts["pads"] == len(args[3])


@pytest.mark.parametrize("name", sorted(set(RUNS) - {"wrapping_sum"}))
def test_tree_model_matches_host_oracle_on_valid_victims(name):
    """The int64 oracle takes the valid victims only (a pad changes
    nothing); it does not wrap, so the wrapping case is left out here."""
    free, head, ok, v_req, valid = _case(name)
    got, _ = tt.defrag_tree_model(free, head, ok, v_req, valid)
    want = tdefrag.defrag_assign_host(free, head, ok, v_req[valid])
    np.testing.assert_array_equal(got[valid], want)
    assert (got[~valid] == -1).all()


def test_wrapping_sum_differs_from_the_int64_oracle_as_jax_does():
    free, head, ok, v_req, valid = _case("wrapping_sum")
    got, _ = tt.defrag_tree_model(free, head, ok, v_req, valid)
    np.testing.assert_array_equal(got, _jax((free, head, ok, v_req, valid)))
    waste = free[:, None, :].astype(np.int64) - v_req[None, valid, :]
    assert (waste.sum(axis=2) > 2**31 - 1).any()  # the int32 sum does wrap here


@pytest.mark.parametrize("name", sorted(tt.defrag_edge_cases()))
def test_tree_model_matches_plain_on_edge_cases(name):
    args = tt.defrag_edge_cases()[name]
    got, _ = tt.defrag_tree_model(*args)
    np.testing.assert_array_equal(got, _plain(args))
    np.testing.assert_array_equal(got, _jax(args))


@pytest.mark.parametrize("seed,ns,v", [(0, 700, 512), (1, 5000, 1024)])
def test_tree_model_matches_plain_on_mixed_requests(seed, ns, v):
    """defrag_problem's mixed requests (the cap case's generator): almost
    every victim rebuilds the tree."""
    args = tt.defrag_problem(seed, ns, v)
    got, counts = tt.defrag_tree_model(*args)
    np.testing.assert_array_equal(got, _plain(args))
    assert counts["rebuilds"] > v // 2


def test_one_run_rebuilds_once_and_updates_a_path_a_placement():
    """Defrag_5000's cycle: every victim the same request. One rebuild;
    every placement but the last is followed by one leaf update."""
    free, head, ok, v_req, valid = tt.defrag_request_runs(3, 5000, 250, max_run=1000,
                                                          pads=0.0)
    v_req[:] = np.array([3000, 0, 0], np.int32)
    valid[:250] = True
    got, counts = tt.defrag_tree_model(free, head, ok, v_req, valid)
    np.testing.assert_array_equal(got, _plain((free, head, ok, v_req, valid)))
    placed = int((got >= 0).sum())
    assert counts["rebuilds"] == 1 and placed > 200
    assert counts["leaf_updates"] == placed - int(got[249] >= 0)


def test_unplaced_run_changes_nothing_and_stays_unplaced():
    """A request that fits nowhere: one rebuild, every victim of its run -1,
    and the next run sees the untouched state."""
    free, head, ok, v_req, valid = tt.defrag_request_runs(5, 64, 32, max_run=1, pads=0.0)
    v_req[:16] = np.array([9000, 0, 0], np.int32)
    v_req[16:32] = np.array([100, 100, 100], np.int32)
    got, counts = tt.defrag_tree_model(free, head, ok, v_req, valid)
    assert (got[:16] == -1).all() and (got[16:32] >= 0).any()
    assert counts["rebuilds"] == 2 and counts["leaf_updates"] == int((got[16:31] >= 0).sum())
    np.testing.assert_array_equal(got, _plain((free, head, ok, v_req, valid)))


def test_pad_in_a_run_neither_rebuilds_nor_places():
    free, head, ok, v_req, valid = tt.defrag_request_runs(6, 64, 16, max_run=1, pads=0.0)
    v_req[:16] = np.array([200, 200, 200], np.int32)
    valid[5] = False
    got, counts = tt.defrag_tree_model(free, head, ok, v_req, valid)
    assert got[5] == -1 and counts["rebuilds"] == 1 and counts["pads"] == 1
    np.testing.assert_array_equal(got, _plain((free, head, ok, v_req, valid)))


@pytest.mark.parametrize("n_slots,group,leaves", [
    (1, 128, 1), (128, 128, 1), (129, 128, 2), (5000, 128, 40), (8192, 128, 64),
    (16384, 128, 128), (16385, 256, 65), (32768, 256, 128), (1 << 20, 8192, 128)])
def test_tree_leaves(n_slots, group, leaves):
    """At most 128 leaves (warp 0 holds them in registers, 4 a lane)."""
    assert kernels.defrag_group(n_slots) == group
    assert -(-n_slots // group) == leaves <= 128


@pytest.mark.parametrize("group", [4, 128, 160, 512])
def test_tree_model_is_exact_at_any_group(group):
    args = tt.defrag_run_case("runs")
    np.testing.assert_array_equal(tt.defrag_tree_model(*args, group=group)[0], _plain(args))
