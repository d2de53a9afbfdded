"""The port's gang cover and rank alignment (models/gangcover.py, the plain
versions of kernels G and H) against the JAX package's on the same seeded
numpy inputs: exact equality (tolerance 0, every output is int32 or bool).

JAX's cover_curve runs jitted on the CPU; its cover_curves wrapper takes the
numpy oracle for k == 0 and above its 4,000,000-element budget, which the
port's wrapper never does: the curves are equal all the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models import gangcover as jg
from kubernetes_tpu_torch.models import gangcover as tg


def _cover_case(rng, ns, r, k, pads=0, zero_dims=(), same_node=False):
    free = rng.integers(0, 40, size=(ns, r)).astype(np.int64)
    head = rng.integers(0, 9, size=ns).astype(np.int64)
    elig = rng.random(ns) > 0.25
    v_node = rng.integers(0, ns, size=k).astype(np.int64)
    if same_node and k:
        v_node[: k // 2] = v_node[0]
    v_req = rng.integers(0, 9, size=(k, r)).astype(np.int64)
    req = rng.integers(1, 6, size=r).astype(np.int64)
    for d in zero_dims:
        req[d] = 0
    return free, head, elig, v_node, v_req, req, pads


def _padded(free, head, elig, v_node, v_req, req, pads):
    """The JAX wrapper's padding plus `pads` extra -1 victims inside k_max."""
    ns, r = free.shape
    k = len(v_node)
    n_slots = 1 << max(0, ns - 1).bit_length()
    k_max = 1 << max(0, k + pads - 1).bit_length()
    free_p = np.zeros((n_slots, r), np.int32)
    free_p[:ns] = free
    head_p = np.zeros(n_slots, np.int32)
    head_p[:ns] = head
    elig_p = np.zeros(n_slots, bool)
    elig_p[:ns] = elig
    vn = np.full(k_max, -1, np.int32)
    vn[:k] = v_node
    vr = np.zeros((k_max, r), np.int32)
    vr[:k] = v_req
    return free_p, head_p, elig_p, vn, vr, np.asarray(req, np.int32), n_slots, k_max


COVER_CASES = {
    "k0": dict(ns=5, r=3, k=0),
    "pads": dict(ns=7, r=3, k=5, pads=6),
    "ineligible_and_zero_dim": dict(ns=9, r=3, k=12, zero_dims=(1,)),
    "all_zero_request": dict(ns=4, r=2, k=6, zero_dims=(0, 1)),
    "same_node_victims": dict(ns=6, r=5, k=14, same_node=True),
    "r5": dict(ns=30, r=5, k=40),
}


@pytest.mark.parametrize("case", sorted(COVER_CASES))
def test_cover_curve_plain_matches_jax_kernel_and_oracle(case):
    rng = np.random.default_rng(sorted(COVER_CASES).index(case) + 3)
    free, head, elig, v_node, v_req, req, pads = _cover_case(rng, **COVER_CASES[case])
    fp, hp, ep, vn, vr, rq, n_slots, k_max = _padded(free, head, elig, v_node, v_req, req, pads)
    want = np.asarray(jg.cover_curve(jnp.asarray(fp), jnp.asarray(hp), jnp.asarray(ep),
                                     jnp.asarray(vn), jnp.asarray(vr), jnp.asarray(rq),
                                     n_slots=n_slots, k_max=k_max))
    got = tg.cover_curve_plain(*(torch.from_numpy(x) for x in (fp, hp, ep, vn, vr, rq)))
    assert got.dtype == torch.int32 and got.shape == (k_max + 1,)
    assert np.array_equal(got.numpy(), want)
    host = tg.cover_curve_host(free, head, elig, v_node, v_req, req)
    assert np.array_equal(host, jg.cover_curve_host(free, head, elig, v_node, v_req, req))
    assert np.array_equal(want[: len(v_node) + 1], host)


def test_cover_curve_negative_free_floors_like_jax():
    """Over-committed nodes (free < 0) need floor division, not truncation."""
    free = np.array([[-7, 3], [-1, -5], [4, 4]], np.int32)
    head = np.array([3, 3, 3], np.int32)
    elig = np.array([True, True, True])
    vn = np.array([0, 1, 1, -1], np.int32)
    vr = np.array([[2, 0], [1, 9], [0, 1], [0, 0]], np.int32)
    rq = np.array([3, 2], np.int32)
    want = np.asarray(jg.cover_curve(*(jnp.asarray(x) for x in (free, head, elig, vn, vr, rq)),
                                     n_slots=3, k_max=4))
    got = tg.cover_curve_plain(*(torch.from_numpy(x) for x in (free, head, elig, vn, vr, rq)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(12))
def test_cover_curves_wrapper_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ns, r, k = int(rng.integers(1, 12)), int(rng.integers(1, 5)), int(rng.integers(0, 20))
    free, head, elig, v_node, v_req, req, _ = _cover_case(rng, ns, r, k)
    got = tg.cover_curves(free, head, elig, v_node, v_req, req, device="cpu")
    want = jg.cover_curves(free, head, elig, v_node, v_req, req)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert (np.diff(got) >= 0).all()


def test_cover_curves_above_the_jax_device_budget():
    """(k_max + 1) * n_slots * R > 4,000,000: JAX hands this shape to its
    numpy oracle; the port runs the curve itself, with the same result."""
    rng = np.random.default_rng(5)
    ns, r, k = 2000, 2, 1000
    free, head, elig, v_node, v_req, req, _ = _cover_case(rng, ns, r, k)
    assert (1024 + 1) * 2048 * r > jg._COVER_KERNEL_MAX_ELEMS
    got = tg.cover_curves(free, head, elig, v_node, v_req, req, device="cpu")
    assert np.array_equal(got, jg.cover_curves(free, head, elig, v_node, v_req, req))


def _align_case(rng, p, ties=False):
    gop = rng.integers(-1, 4, size=p)
    cls = rng.integers(0, 3, size=p)
    req = rng.integers(0, 2, size=(p, 2)).astype(np.int64)
    gid = jg.alignment_groups(gop, cls, req, req)
    assign = rng.integers(-1, 8, size=p).astype(np.int64)
    rank = rng.integers(0, 3 if ties else 40, size=p)
    pos = np.where(assign >= 0, (assign * 5) % (3 if ties else 11), 2**30)
    return gop, cls, req, gid, assign, rank, pos


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_rank_align_plain_matches_jax(seed, ties):
    """Ties in rank and pos_key, unplaced members (pos 2^30), non-members
    (singleton ids) and the pow2 pads of the wrapper."""
    rng = np.random.default_rng(100 + seed)
    p = int(rng.integers(1, 80))
    gop, cls, req, gid, assign, rank, pos = _align_case(rng, p, ties)
    assert np.array_equal(tg.alignment_groups(gop, cls, req, req), gid)
    p_max = 1 << max(0, p - 1).bit_length()
    a = np.full(p_max, -1, np.int32)
    a[:p] = assign
    g = np.arange(p_max, dtype=np.int32) + np.int32(2**30)
    g[:p] = gid
    rk = np.zeros(p_max, np.int32)
    rk[:p] = rank
    pk = np.zeros(p_max, np.int32)
    pk[:p] = pos
    want = np.asarray(jg.rank_align_kernel(*(jnp.asarray(x) for x in (a, g, rk, pk)),
                                           p_max=p_max))
    got = tg.rank_align_plain(*(torch.from_numpy(x) for x in (a, g, rk, pk)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    host = tg.rank_align_host(assign, gid.astype(np.int64), rank, pos)
    assert np.array_equal(host, jg.rank_align_host(assign, gid.astype(np.int64), rank, pos))
    wrapped = tg.rank_align(assign, gid, rank, pos, device="cpu")
    assert np.array_equal(wrapped, jg.rank_align(assign, gid, rank, pos))
    for grp in np.unique(gid):
        m = gid == grp
        assert sorted(assign[m].tolist()) == sorted(wrapped[m].tolist())


def test_rank_align_plain_orders_signed_keys_like_jax():
    """Negative group ids and ranks sort in signed order, as int32 lexsort."""
    a = np.arange(8, dtype=np.int32)
    g = np.array([0, -3, 0, -3, 5, 5, -3, 0], np.int32)
    rk = np.array([-1, 4, 2, -9, 0, 0, 4, -1], np.int32)
    pk = np.array([7, -2, -2, 3, 1, -1, 0, 7], np.int32)
    want = np.asarray(jg.rank_align_kernel(*(jnp.asarray(x) for x in (a, g, rk, pk)), p_max=8))
    got = tg.rank_align_plain(*(torch.from_numpy(x) for x in (a, g, rk, pk)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_victim_order_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 50))
    prio = rng.integers(0, 4, size=n)
    freed = rng.integers(0, 6, size=n)
    assert np.array_equal(tg.victim_order(prio, freed), jg.victim_order(prio, freed))


@pytest.mark.parametrize("seed", range(4))
def test_mean_neighbor_distance_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 40))
    args = (rng.integers(-1, 3, size=n).tolist(), rng.integers(0, 20, size=n).tolist(),
            rng.integers(-1, 3, size=n).tolist(), rng.integers(0, 8, size=n).tolist(),
            {0: 8, 1: 4, 2: 6})
    assert tg.mean_neighbor_distance(*args) == jg.mean_neighbor_distance(*args)


def test_wrappers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    one = np.zeros((1, 1), np.int64)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tg.cover_curves(one, np.zeros(1), np.ones(1, bool), np.zeros(0, np.int64),
                        np.zeros((0, 1), np.int64), np.ones(1, np.int64))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tg.rank_align(np.zeros(2, np.int64), np.zeros(2, np.int32), np.zeros(2), np.zeros(2))
