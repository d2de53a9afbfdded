"""Kernel D's redesign: the repair check as one thread-block-cluster launch.

Kernel D (csrc/repair_check.cu) sums each CTA's node slice (whole quads of
four nodes, read 16 bytes at a time where a row allows it) into the domain
table, replicated in every CTA's shared memory (mode 0), owned a slice of
the domains per CTA in the cluster's shared memory (mode 1) or in a global
scratch (mode 2), reduces the spread rows' n_valid and minimum over the
cluster, then tests each CTA's slice of the pods. testing.repair_check_model
is that schedule in numpy; the CPU tests hold it equal to
repair_check_plain and to the JAX package's repair_check on seeded problems
(every gate pair; minDomains above the domain count; nodes without the key;
d_max 1, 10, 5,000 and 70,000; wrapping int32 sums; unplaced and pad rows),
on clusters of 16 and 8 CTAs. Tolerance: exact (bool masks).

The tests marked `gpu` hold the kernel against the plain version on the
card, one CUDA launch a call, on every route; they skip without a card and
run with `python -m pytest --noconftest -m gpu
tests/test_torch_repair_redesign.py` (this file imports JAX only inside its
CPU tests).
"""

import numpy as np
import pytest
import torch

import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu_torch.models import repair as trep
from kubernetes_tpu_torch.ops import kernels

GATES = [(True, True), (True, False), (False, True), (False, False)]

# name: (nodes, pods, d_max, repair_problem keywords, the route at 16 CTAs
# with both gates on)
CASES = {
    "zones_d10": (300, 200, 10, {}, "replicate"),
    "one_domain_d1": (200, 100, 1, {}, "replicate"),
    "keys_missing": (400, 150, 10, dict(missing=0.5), "replicate"),
    "min_domains_over": (300, 120, 10, dict(min_domains_over=True), "replicate"),
    "wrapping_sums": (800, 100, 10, dict(wrap=True), "replicate"),
    "unplaced_and_pads": (300, 130, 10, dict(placed=0.5), "replicate"),
    "hostname_d5000": (5000, 500, 5000, dict(kk=1, sc=40, g=40, c=20), "owner"),
    "hostname_wrap_d5000": (5000, 300, 5000, dict(kk=2, sc=3, g=2, wrap=True), "owner"),
    "global_d70000": (70000, 300, 70000, dict(kk=2, sc=5, g=2), "global"),
}


def _case(name, seed=0):
    n, p, d_max, kw, _ = CASES[name]
    return tt.repair_problem(seed + sum(map(ord, name)), n, p, d_max, **kw), d_max


def _plain(args, d_max, has_affinity, has_ct):
    masks = trep.repair_check_plain(*[torch.from_numpy(a) for a in args], d_max=d_max,
                                    has_affinity=has_affinity, has_ct=has_ct)
    assert all(m.dtype == torch.bool for m in masks)
    return torch.stack(masks).numpy()


def _jax(args, d_max, has_affinity, has_ct):
    import jax.numpy as jnp

    from kubernetes_tpu.models import repair as jrep

    masks = jrep.repair_check(*[jnp.asarray(a) for a in args], d_max=d_max,
                              has_affinity=has_affinity, has_ct=has_ct)
    return np.stack([np.asarray(m) for m in masks])


@pytest.mark.parametrize("has_affinity,has_ct", GATES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_model_matches_plain_and_jax(name, has_affinity, has_ct):
    args, d_max = _case(name)
    want = _plain(args, d_max, has_affinity, has_ct)
    np.testing.assert_array_equal(want, _jax(args, d_max, has_affinity, has_ct))
    for cs in (16, 8):
        got, info = tt.repair_check_model(args, d_max, has_affinity, has_ct, cs=cs)
        np.testing.assert_array_equal(got, want)
        assert info["plan"]["cluster_size"] == cs


@pytest.mark.parametrize("name", sorted(CASES))
def test_route_of_each_case(name):
    args, d_max = _case(name)
    _, info = tt.repair_check_model(args, d_max, True, True, cs=16)
    assert info["plan"]["mode"] == CASES[name][4]


def test_cases_fire_every_violation_kind():
    """The seeded problems are not vacuous: across the cases every mask
    kind fires and stays clear somewhere, and pad rows never fire."""
    fired = np.zeros(4, bool)
    clear = np.zeros(4, bool)
    for name in CASES:
        args, d_max = _case(name)
        masks = _plain(args, d_max, True, True)
        node_of = args[0]
        assert not masks[:, node_of < 0].any()
        fired |= masks.any(axis=1)
        clear |= (~masks[:, node_of >= 0]).any(axis=1)
    assert fired.all() and clear.all()


def test_min_domains_above_the_domain_count_zeroes_the_minimum():
    args, d_max = _case("min_domains_over")
    _, info = tt.repair_check_model(args, d_max, False, True)
    ct_class = args[14]
    assert (info["ct_min"][ct_class >= 0] == 0).all()
    assert (args[18] > d_max).all()


def test_replicated_partials_sum_to_the_owner_slices():
    """Mode 0's per-CTA partial tables and mode 1's owner slices hold the
    same totals (the reduction is exact in any order)."""
    args, d_max = _case("zones_d10")
    _, rep = tt.repair_check_model(args, d_max, True, True, cs=16)
    total = sum(p.astype(np.uint64) for p in rep["partials"]) % 2**32
    assert len(rep["partials"]) == 16
    big = tt.repair_problem(5, 2000, 64, 2000, kk=1, sc=2, g=1)
    _, own = tt.repair_check_model(big, 2000, True, True, cs=8)
    assert own["plan"]["mode"] == "owner" and len(own["partials"]) == 8
    assert all(p.shape[1] == own["plan"]["domains_per_cta"] for p in own["partials"])
    assert total.shape[1] == d_max


def test_plan_refuses_spread_rows_beyond_shared_memory():
    with pytest.raises(ValueError, match="spread rows exceed"):
        kernels.repair_plan(256, 100, 1, 2, 4000, 10, True, True, 16)


def test_packed_check_on_cpu_stacks_the_plain_masks():
    args, d_max = _case("zones_d10")
    t = [torch.from_numpy(a) for a in args]
    packed = trep.repair_check_packed(*t, d_max=d_max)
    assert packed.shape == (4, args[0].shape[0]) and packed.dtype == torch.bool
    for row, mask, plain in zip(packed, trep.repair_check(*t, d_max=d_max),
                                trep.repair_check_plain(*t, d_max=d_max)):
        assert torch.equal(row, mask) and torch.equal(row, plain)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("has_affinity,has_ct", GATES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_d_one_cluster_launch_matches_plain_on_card(cuda_device, name, has_affinity,
                                                           has_ct):
    args, d_max = _case(name)
    dev = [torch.from_numpy(a).to(cuda_device) for a in args]
    before, cuda_before = kernels.LAUNCHES["repair_check"], kernels.CUDA_LAUNCHES["repair_check"]
    got = trep.repair_check(*dev, d_max=d_max, has_affinity=has_affinity, has_ct=has_ct)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["repair_check"] == before + 1
    assert kernels.CUDA_LAUNCHES["repair_check"] == cuda_before + 1
    if has_affinity and has_ct:
        assert kernels.LAST_REPAIR_PLAN["mode"] == CASES[name][4]
    want = trep.repair_check_plain(*dev, d_max=d_max, has_affinity=has_affinity, has_ct=has_ct)
    for a, b in zip(got, want):
        assert a.dtype == torch.bool and torch.equal(a, b)
    # the masks are the rows of one tensor
    assert len({m.untyped_storage().data_ptr() for m in got}) == 1


@pytest.mark.gpu
def test_kernel_d_refused_shape_raises(cuda_device):
    args, d_max = _case("zones_d10")
    dev = [torch.from_numpy(a).to(cuda_device) for a in args]
    many = [torch.zeros(4000, dtype=torch.int32, device=cuda_device) for _ in range(5)]
    with pytest.raises(ValueError, match="spread rows exceed"):
        trep.repair_check(*dev[:14], *many, d_max=d_max)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["zones_d10", "hostname_wrap_d5000"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_d_count_rows_off_16_byte_alignment_on_card(cuda_device, name, offset):
    """Count rows that start 4, 8 or 12 bytes past a 16-byte boundary (views
    into a larger buffer): their quads are read entry by entry."""
    args, d_max = _case(name)
    dev = [torch.from_numpy(a).to(cuda_device) for a in args]
    for i in (2, 3):
        buf = torch.zeros(dev[i].numel() + 8, dtype=torch.int32, device=cuda_device)
        dev[i] = buf[offset:offset + dev[i].numel()].view(dev[i].shape).copy_(dev[i])
        assert dev[i].data_ptr() % 16 == 4 * offset
    got = trep.repair_check(*dev, d_max=d_max)
    want = trep.repair_check_plain(*dev, d_max=d_max)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
