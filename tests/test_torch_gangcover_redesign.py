"""Kernel G's redesign, on the CPU: the victim-parallel cover curve and the
batched cover attempt.

Kernel G (csrc/cover_curve.cu) computes each slice's curve with no thread
walking the victim list, and runs every slice of a cover attempt as one CTA
of one launch. testing.cover_curve_model is its arithmetic in numpy (a
stable counting sort of the victims by node, prefix sums of the node-sorted
requests, per-victim capacity deltas, a prefix sum into the curve); the tests
hold it equal to cover_curve_plain, the JAX package's cover_curve and
cover_curve_host (pads, ineligible nodes, nodes beyond the slice, k = 0,
negative free, zero-request resources, int32 wraparound, many victims on one
node), the batched plain entry equal to per-slice cover_curves, and the
preemptor's batched walk equal to the JAX package's slice-by-slice loop
where a slice already has room. Tolerance: exact equality (int32 curves).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.models import gangcover as jg
from kubernetes_tpu.scheduler import gangpreempt as jgp
from kubernetes_tpu_torch.models import gangcover as tg
from kubernetes_tpu_torch.scheduler import gangpreempt as tgp


def _case(seed, ns, r, k, pads=0, inelig=0.25, out_of_range=0, negative=False, zero_dims=(),
          one_node=False):
    """Padded int32 arguments of one curve (the JAX wrapper's buckets plus
    `pads` -1 victims) and the unpadded victim count."""
    rng = np.random.default_rng(seed)
    n_slots = 1 << max(0, ns - 1).bit_length()
    k_max = 1 << max(0, k + pads - 1).bit_length()
    free = np.zeros((n_slots, r), np.int32)
    free[:ns] = rng.integers(-40 if negative else 0, 400, size=(ns, r))
    head = np.zeros(n_slots, np.int32)
    head[:ns] = rng.integers(0, 12, size=ns)
    elig = np.zeros(n_slots, bool)
    elig[:ns] = rng.random(ns) >= inelig
    vn = np.full(k_max, -1, np.int32)
    vn[:k] = rng.integers(0, ns, size=k)
    if one_node and k:
        vn[:k] = int(vn[0])
    if out_of_range and k:
        vn[rng.choice(k, size=min(out_of_range, k), replace=False)] = n_slots + 3
    vr = np.zeros((k_max, r), np.int32)
    vr[:k] = rng.integers(0, 90, size=(k, r))
    req = rng.integers(1, 60, size=r).astype(np.int32)
    for d in zero_dims:
        req[d] = 0
    return (free, head, elig, vn, vr, req), k


CASES = {
    "k0_pads": dict(ns=5, r=3, k=0, pads=3),
    "pads_ineligible": dict(ns=30, r=3, k=40, pads=30, inelig=0.5),
    "out_of_range_nodes": dict(ns=12, r=2, k=50, out_of_range=9),
    "negative_free": dict(ns=9, r=4, k=33, negative=True),
    "zero_request_dims": dict(ns=17, r=3, k=60, zero_dims=(0, 2)),
    "all_zero_request": dict(ns=6, r=2, k=20, zero_dims=(0, 1)),
    "many_on_one_node": dict(ns=8, r=3, k=700, one_node=True, inelig=0.0),
    "main_path_shape": dict(ns=250, r=3, k=1000),
    "above_one_chunk": dict(ns=3, r=1, k=1500, inelig=0.0),
}


def _jax_curve(args):
    free, head, elig, vn, vr, req = args
    return np.asarray(jg.cover_curve(*(jnp.asarray(x) for x in args),
                                     n_slots=free.shape[0], k_max=vn.shape[0]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_plain_jax_and_host(case):
    args, k = _case(sorted(CASES).index(case) + 40, **CASES[case])
    model = tt.cover_curve_model(*args)
    plain = tg.cover_curve_plain(*(torch.from_numpy(x) for x in args))
    assert model.dtype == np.int32 and plain.dtype == torch.int32
    np.testing.assert_array_equal(model, plain.numpy())
    np.testing.assert_array_equal(model, _jax_curve(args))
    free, head, elig, vn, vr, req = args
    ns = free.shape[0]
    keep = (vn[:k] >= 0) & (vn[:k] < ns)
    if keep.all():  # the oracle takes real victims only
        host = tg.cover_curve_host(free, head, elig, vn[:k], vr[:k], req)
        np.testing.assert_array_equal(model[:k + 1].astype(np.int64), host)


def test_int32_wraparound():
    """Sums past 2^31 wrap as XLA's int32 do: the curve (capacities of 2^30
    on all-zero requests) and a node's free + freed."""
    free = np.array([[2**31 - 50, 7], [3, 2**31 - 2], [0, 0], [9, 9]], np.int32)
    head = np.array([2**30, 2**30, 2**30 - 1, 2**31 - 2], np.int32)
    elig = np.array([True, True, True, True])
    vn = np.array([0, 1, 0, 3, 3, -1, 2, 0], np.int32)
    vr = np.array([[60, 0], [0, 9], [2**31 - 1, 3], [1, 1], [5, 5], [0, 0], [7, 7], [1, 1]],
                  np.int32)
    for req in (np.array([0, 0], np.int32), np.array([3, 0], np.int32),
                np.array([2, 5], np.int32)):
        args = (free, head, elig, vn, vr, req)
        model = tt.cover_curve_model(*args)
        np.testing.assert_array_equal(model, tg.cover_curve_plain(
            *(torch.from_numpy(x) for x in args)).numpy())
        np.testing.assert_array_equal(model, _jax_curve(args))


@pytest.mark.parametrize("seed", range(4))
def test_batched_plain_matches_per_slice_curves(seed):
    """Every slice of an attempt at once (padded to the largest slice and
    victim list) gives each slice's own curve."""
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 4))
    req = rng.integers(0, 6, size=r).astype(np.int64)
    slices = []
    for _ in range(int(rng.integers(1, 6))):
        ns, k = int(rng.integers(1, 20)), int(rng.integers(0, 30))
        slices.append((rng.integers(-3, 40, size=(ns, r)).astype(np.int64),
                       rng.integers(0, 9, size=ns).astype(np.int64), rng.random(ns) > 0.2,
                       rng.integers(0, ns, size=k).astype(np.int64),
                       rng.integers(0, 9, size=(k, r)).astype(np.int64)))
    got = tg.cover_curves_batched(slices, req, device="cpu")
    assert len(got) == len(slices)
    for x, caps in zip(slices, got):
        want = tg.cover_curves(*x, req, device="cpu")
        assert caps.dtype == np.int64 and np.array_equal(caps, want)
        assert np.array_equal(caps, jg.cover_curves(*x, req))


def test_batch_plain_is_the_per_slice_plain():
    cases = [_case(s, ns=16, r=3, k=32)[0] for s in range(3)]
    stacked = [torch.from_numpy(np.stack([c[i] for c in cases])) for i in range(5)]
    req = torch.from_numpy(cases[0][5])
    got = tg.cover_curve_batch(*stacked, req)
    assert got.shape == (3, 33) and got.dtype == torch.int32
    for s, c in enumerate(cases):
        want = tg.cover_curve_plain(*(torch.from_numpy(x) for x in c[:5]), req)
        assert torch.equal(got[s], want)
    assert tg.cover_curves_batched([], np.zeros(3, np.int64), device="cpu") == []


def _ctx(m, slices_free, victims_per_slice, nodes_per_slice=3):
    """A preemption context of len(slices_free) slices: slice s's nodes
    have `slices_free[s]` free cpu units, and `victims_per_slice[s]`
    priority-1 victims of 1 unit spread over its nodes."""
    n_slices = len(slices_free)
    n = n_slices * nodes_per_slice
    v_node, pods = [], []
    for s, nv in enumerate(victims_per_slice):
        for i in range(nv):
            v_node.append(s * nodes_per_slice + i % nodes_per_slice)
            pods.append(m.MakePod(f"v-{s}-{i}").priority(1).req({"cpu": "1"}).obj())
    return {
        "cluster": SimpleNamespace(n=n),
        "sub": SimpleNamespace(
            gang_of_pod=np.zeros(4, np.int64), class_of_pod=np.zeros(4, np.int64),
            req=np.array([[3]] * 4, dtype=np.int64),
            tables=SimpleNamespace(filter_ok=np.ones((1, n), dtype=bool))),
        "free": np.repeat(np.asarray(slices_free, np.int64), nodes_per_slice)[:, None],
        "headroom": np.full(n, 2000, dtype=np.int64),
        "slice_ids": np.repeat(np.arange(n_slices), nodes_per_slice).astype(np.int64),
        "victims": (np.array(v_node, np.int64), np.ones(len(pods), np.int64),
                    np.ones((len(pods), 1), np.int64), pods),
        "pdb_blocked": np.zeros(len(pods), dtype=bool),
    }


@pytest.mark.parametrize("slices_free,victims,want", [
    # slice 0 has room: the attempt stops there; slice 1's capped list is
    # never counted
    ((12, 0), (5, 1100), (True, 5, False)),
    # slice 0 is capped and coverable, slice 1 has room: both counted
    ((0, 12), (1100, 4), (True, 1024 + 4, True)),
    # no room anywhere: every slice counted, the cheaper cover chosen
    ((0, 0, 0), (20, 1100, 9), (False, 20 + 1024 + 9, True)),
])
def test_batched_walk_keeps_the_loops_exit_and_counts(slices_free, victims, want):
    outs = []
    for m, gp_mod in ((jt, jgp), (tt, tgp)):
        ctx = _ctx(m, slices_free, victims)
        gp = gp_mod.GangPreemptor.__new__(gp_mod.GangPreemptor)
        gp.sched = SimpleNamespace(device=torch.device("cpu"))
        c = gp._select_cover(gid=0, need=4, prio=100, ctx=ctx)
        outs.append((c.room_exists, c.considered, c.capped, c.slice_id,
                     None if c.chosen is None else c.chosen.tolist(), c.cost, c.max_prio))
    assert outs[1] == outs[0]
    assert outs[1][:3] == want
