"""The port's slice defragmentation (models/defrag.py) against the JAX package.

defrag_assign_plain (kernel I's plain version) is held against the JAX
`defrag_assign` scan, called directly with JAX's padding, and against the
numpy oracle `defrag_assign_host`, on the 30 seeded cases of
tests/test_rebalance.py, seeded cases with negative free, the padding,
headroom and mask cases, and a case whose waste sum wraps int32 (where the
int64 oracle, which does not wrap, differs from both). slice_fragmentation
and defrag_plan(device="cpu") are held against the JAX package's, the latter
on and above the JAX wrapper's 4,000,000-element gate and on its host
branch. Every tolerance is exact equality. Inputs are made with numpy from
seeds.
"""

import numpy as np
import pytest
import torch

import kubernetes_tpu.models.defrag as jdefrag
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu_torch.models import defrag as tdefrag


def _pow2(n):
    return 1 << max(0, n - 1).bit_length()


def padded(free, head, ok, v_req):
    """JAX's defrag_plan padding, as numpy int32/bool arrays."""
    ns, r = free.shape
    v = len(v_req)
    n_slots, v_max = _pow2(ns), _pow2(v)
    free_p = np.zeros((n_slots, r), np.int32)
    free_p[:ns] = free
    head_p = np.zeros(n_slots, np.int32)
    head_p[:ns] = head
    ok_p = np.zeros(n_slots, bool)
    ok_p[:ns] = ok
    vr_p = np.zeros((v_max, r), np.int32)
    vr_p[:v] = v_req
    valid_p = np.zeros(v_max, bool)
    valid_p[:v] = True
    return free_p, head_p, ok_p, vr_p, valid_p


def both_padded(free, head, ok, v_req, valid=None):
    """(jax targets, plain targets) of the padded scan, as numpy int32."""
    args = padded(free, head, ok, v_req)
    if valid is not None:
        args = args[:4] + (np.asarray(valid, bool),)
    n_slots, v_max = args[0].shape[0], args[3].shape[0]
    want = np.asarray(jdefrag.defrag_assign(*args, n_slots=n_slots, v_max=v_max))
    got = tdefrag.defrag_assign_plain(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.int32
    return want, got.numpy()


def _reference_cases():
    """The 30 cases of tests/test_rebalance.py's kernel-vs-oracle test, drawn
    from the same generator in the same order, then 12 with negative free."""
    rng = np.random.default_rng(17)
    cases = []
    for _ in range(30):
        ns = int(rng.integers(1, 12))
        r = int(rng.integers(1, 4))
        v = int(rng.integers(0, 16))
        free = rng.integers(0, 20, size=(ns, r)).astype(np.int64)
        head = rng.integers(0, 6, size=ns).astype(np.int64)
        ok = rng.random(ns) > 0.3
        v_req = rng.integers(0, 12, size=(v, r)).astype(np.int64)
        cases.append((free, head, ok, v_req))
    rng = np.random.default_rng(1017)
    for _ in range(12):
        ns = int(rng.integers(1, 40))
        r = int(rng.integers(1, 5))
        v = int(rng.integers(1, 40))
        free = rng.integers(-8, 20, size=(ns, r)).astype(np.int64)
        head = rng.integers(-1, 4, size=ns).astype(np.int64)
        ok = rng.random(ns) > 0.2
        v_req = rng.integers(0, 12, size=(v, r)).astype(np.int64)
        v_req[rng.random(v) < 0.2] = 0  # zero-request victims
        cases.append((free, head, ok, v_req))
    return cases


CASES = _reference_cases()


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_matches_jax_scan_and_host_oracle(i):
    free, head, ok, v_req = CASES[i]
    v = len(v_req)
    if v:
        want, got = both_padded(free, head, ok, v_req)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:v], jdefrag.defrag_assign_host(free, head, ok, v_req))
    plan = tdefrag.defrag_plan(free, head, ok, v_req, device="cpu")
    assert plan.dtype == np.int64
    np.testing.assert_array_equal(plan, jdefrag.defrag_plan(free, head, ok, v_req))
    np.testing.assert_array_equal(tdefrag.defrag_assign_host(free, head, ok, v_req),
                                  jdefrag.defrag_assign_host(free, head, ok, v_req))


def test_padding_invariance_matches_jax():
    """Pad rows (v_valid False) and pad slots (all-zero free, target_ok
    False) never change real rows' targets."""
    free = np.array([[5, 5], [9, 9]], dtype=np.int32)
    head = np.array([2, 2], dtype=np.int32)
    ok = np.array([True, True])
    v_req = np.array([[4, 4], [6, 6]], dtype=np.int64)
    got = tdefrag.defrag_plan(free, head, ok, v_req, device="cpu")
    np.testing.assert_array_equal(got, jdefrag.defrag_plan(free, head, ok, v_req))
    np.testing.assert_array_equal(got, [0, 1])
    # pad victims in the middle of the padded axis: they place nothing
    want, got = both_padded(free, head, ok, np.array([[4, 4], [1, 1], [6, 6]]),
                            valid=[True, False, True, False])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, -1, 1, -1])


def test_headroom_and_mask_match_jax():
    free = np.array([[10], [10]], dtype=np.int64)
    head = np.array([1, 0], dtype=np.int64)  # node1 has no pod slots
    ok = np.array([True, True])
    v_req = np.array([[2], [2]], dtype=np.int64)
    got = tdefrag.defrag_plan(free, head, ok, v_req, device="cpu")
    np.testing.assert_array_equal(got, jdefrag.defrag_plan(free, head, ok, v_req))
    np.testing.assert_array_equal(got, [0, -1])  # node0 full after first
    args = (free, np.array([5, 5]), np.array([False, False]), v_req)
    got = tdefrag.defrag_plan(*args, device="cpu")
    np.testing.assert_array_equal(got, jdefrag.defrag_plan(*args))
    np.testing.assert_array_equal(got, [-1, -1])


def test_ties_unplaceable_and_zero_requests_match_jax():
    """Identical nodes tie to the lowest index; a victim that fits nowhere
    adds nothing at the argmin's index 0; zero-request victims fit wherever
    headroom > 0 and target_ok."""
    free = np.full((6, 3), 7, np.int64)
    head = np.array([0, 2, 2, 1, 2, 2])
    ok = np.array([True, True, True, True, False, True])
    v_req = np.array([[8, 0, 0], [0, 0, 0], [3, 3, 3], [0, 0, 0], [7, 7, 7], [0, 0, 0],
                      [0, 0, 0], [0, 0, 0], [0, 0, 0]])
    want, got = both_padded(free, head, ok, v_req)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:9], jdefrag.defrag_assign_host(free, head, ok, v_req))
    assert got[0] == -1 and got[1] == 1  # unplaceable, then the lowest target


def test_int32_wrap_matches_jax_not_the_int64_oracle():
    """A node whose summed free wraps int32 reads a negative waste in XLA and
    wins the argmin; the plain version wraps the same way, the int64 oracle
    does not."""
    free = np.full((8, 3), 2**30 + 5, np.int64)
    free[3] = 100
    head = np.full(8, 3, np.int64)
    ok = np.ones(8, bool)
    v_req = np.zeros((3, 3), np.int64)
    v_req[:, 0] = 1
    want, got = both_padded(free, head, ok, v_req)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:3], [0, 0, 0])
    assert jdefrag.defrag_assign_host(free, head, ok, v_req).tolist() == [3, 3, 3]
    np.testing.assert_array_equal(tdefrag.defrag_plan(free, head, ok, v_req, device="cpu"),
                                  jdefrag.defrag_plan(free, head, ok, v_req))


def test_plain_does_not_modify_its_inputs():
    args = [torch.from_numpy(a) for a in padded(*CASES[3])]
    before = [a.clone() for a in args]
    tdefrag.defrag_assign_plain(*args)
    for a, b in zip(args, before):
        assert torch.equal(a, b)


# -- defrag_plan on and above the JAX wrapper's gate ----------------------------


def _big_case(seed, ns, v, r=3):
    rng = np.random.default_rng(seed)
    free = rng.integers(0, 8000, size=(ns, r)).astype(np.int64)
    head = rng.integers(0, 110, size=ns).astype(np.int64)
    ok = rng.random(ns) > 0.05
    v_req = rng.integers(0, 4000, size=(v, r)).astype(np.int64)
    return free, head, ok, v_req


@pytest.mark.parametrize("ns,v", [(900, 200), (5000, 250)], ids=["under_gate", "above_gate"])
def test_defrag_plan_matches_jax_on_and_above_its_gate(ns, v):
    free, head, ok, v_req = _big_case(ns + v, ns, v)
    elems = _pow2(v) * _pow2(ns) * 3
    assert (elems > jdefrag._DEFRAG_KERNEL_MAX_ELEMS) == (ns == 5000)
    got = tdefrag.defrag_plan(free, head, ok, v_req, device="cpu")
    np.testing.assert_array_equal(got, jdefrag.defrag_plan(free, head, ok, v_req))
    assert (got >= 0).sum() > v // 2


def test_defrag_plan_matches_jax_host_branch(monkeypatch):
    """The JAX wrapper's numpy branch (reached as its own test does, by
    lowering the gate) gives the port's targets."""
    rng = np.random.default_rng(3)
    free = rng.integers(0, 20, size=(6, 3)).astype(np.int64)
    head = rng.integers(0, 6, size=6).astype(np.int64)
    ok = np.ones(6, dtype=bool)
    v_req = rng.integers(0, 12, size=(5, 3)).astype(np.int64)
    on_device = jdefrag.defrag_plan(free, head, ok, v_req)
    monkeypatch.setattr(jdefrag, "_DEFRAG_KERNEL_MAX_ELEMS", 0)
    host = jdefrag.defrag_plan(free, head, ok, v_req)
    np.testing.assert_array_equal(host, on_device)
    np.testing.assert_array_equal(tdefrag.defrag_plan(free, head, ok, v_req, device="cpu"),
                                  host)


def test_port_has_no_size_gate():
    assert not hasattr(tdefrag, "_DEFRAG_KERNEL_MAX_ELEMS")
    assert tdefrag.DEFRAG_MAX_VICTIMS == jdefrag.DEFRAG_MAX_VICTIMS == 1024
    assert tdefrag.defrag_plan(np.zeros((3, 2)), np.ones(3), np.ones(3, bool),
                               np.zeros((0, 2)), device="cpu").shape == (0,)


def test_entry_point_defaults_to_the_card():
    args = CASES[0]
    if torch.cuda.is_available():
        assert tdefrag.defrag_plan(*args).shape == (len(args[3]),)
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tdefrag.defrag_plan(*args)


# -- fragmentation score ---------------------------------------------------------


def _frag_both(free, sl, active=None):
    want = jdefrag.slice_fragmentation(free, sl, active)
    got = tdefrag.slice_fragmentation(free, sl, active)
    assert got[0] == want[0]
    assert got[1].dtype == want[1].dtype == np.int64
    np.testing.assert_array_equal(got[1], want[1])
    return got


def test_frag_score_units_match_jax():
    free = np.array([[4], [4]], dtype=np.int64)
    assert _frag_both(free, np.array([0, 1]))[0] == pytest.approx(0.5)  # even split
    assert _frag_both(np.array([[8], [0]], dtype=np.int64), np.array([0, 1]))[0] == 0.0
    assert _frag_both(free, np.array([0, 0]))[0] == 0.0  # single slice
    assert _frag_both(free, np.array([-1, -1]))[0] == 0.0  # unlabeled
    assert _frag_both(np.zeros((2, 1), np.int64), np.array([0, 1]))[0] == 0.0  # full


def test_frag_score_inactive_dims_match_jax():
    """A dim nothing consumes is evenly spread by construction and must not
    read as fragmentation."""
    free = np.array([[8, 100], [0, 100]], dtype=np.int64)
    sl = np.array([0, 1])
    assert _frag_both(free, sl)[0] == pytest.approx(0.5)
    assert _frag_both(free, sl, np.array([True, False]))[0] == 0.0
    assert _frag_both(free, sl, np.array([False, False]))[0] == 0.0


@pytest.mark.parametrize("seed", range(8))
def test_frag_score_seeded_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, r = int(rng.integers(2, 60)), int(rng.integers(1, 5))
    free = rng.integers(-500, 4000, size=(n, r))
    sl = rng.integers(-1, int(rng.integers(1, 9)), size=n)
    active = rng.random(r) > 0.3 if seed % 2 else None
    _frag_both(free, sl, active)


@pytest.mark.parametrize("name", sorted(tt.defrag_edge_cases()))
def test_kernel_i_edge_cases_plain_matches_jax(name):
    """The edge cases chip_smoke.py and the card tests hold kernel I to."""
    args = tt.defrag_edge_cases()[name]
    n_slots, v_max = args[0].shape[0], args[3].shape[0]
    want = np.asarray(jdefrag.defrag_assign(*args, n_slots=n_slots, v_max=v_max))
    got = tdefrag.defrag_assign_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                        for a in args))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_problem_plain_matches_jax(seed):
    args = tt.defrag_problem(seed, 300, 100, r=3 + seed % 2)
    n_slots, v_max = args[0].shape[0], args[3].shape[0]
    want = np.asarray(jdefrag.defrag_assign(*args, n_slots=n_slots, v_max=v_max))
    got = tdefrag.defrag_assign_plain(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:100] >= 0).any() and (got[:100] < 0).any()  # placed and unplaceable
