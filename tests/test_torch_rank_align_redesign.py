"""Kernel H's redesign: the rank alignment as one launch of two on-chip sorts.

Kernel H (csrc/rank_align.cu) sorts the rows by (group, rank, index) and
by (group, pos_key, index) in one cluster, a team of CTAs a sort: each CTA
sorts its slice in shared memory (32-row bitonic runs by warp shuffles,
then warp-cooperative merge levels, a block barrier each), the team merges
the sorted chunks level by level through a global scratch (it stays in
L2), a cluster barrier a level; then the scatter out[order_rank[i]] =
assignment[order_pos[i]] in the same launch.
testing.rank_align_model is that schedule in numpy; the CPU tests hold it
equal to rank_align_plain and to the JAX package's rank_align_kernel on
seeded cases (ties in rank and in pos_key, non-members and padding, one
group over every row, p_max 1, 2, 2,048, 4,096, 8,192 and 16,384, slices
of several chunks, clusters of 16 and 8 CTAs). Tolerance: exact (int32).

The tests marked `gpu` hold the kernel against the plain version on the
card, one CUDA launch a call; they skip without a card and run with
`python -m pytest --noconftest -m gpu tests/test_torch_rank_align_redesign.py`
(this file imports JAX only inside its CPU tests).
"""

import numpy as np
import pytest
import torch

import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu_torch.models import gangcover as gcv
from kubernetes_tpu_torch.ops import kernels

_BIG = 2**30


def align_case(seed, p, p_max, groups, ties=False, members=1.0, one_group=False):
    """Seeded padded rank_align arguments: `groups` gangs of ranked members
    at shuffled positions (ties: ranks and positions in [0, 8), a tenth
    unplaced with the position sentinel), a share of non-members with their
    unique ids, the padding rows' ids above every group."""
    rng = np.random.default_rng(seed)
    a = np.full(p_max, -1, np.int32)
    g = np.arange(p_max, dtype=np.int32) + np.int32(_BIG)
    rank = np.zeros(p_max, np.int32)
    pos = np.zeros(p_max, np.int32)
    a[:p] = rng.integers(0, 5000, size=p)
    m = int(p * members)
    g[:m] = 0 if one_group else rng.integers(0, groups, size=m)
    g[m:p] = _BIG // 2 + np.arange(m, p)
    if ties:
        rank[:p] = rng.integers(0, 8, size=p)
        pos[:p] = rng.integers(0, 8, size=p)
        unplaced = rng.random(p) < 0.1
        a[:p][unplaced] = -1
        pos[:p][unplaced] = _BIG
    else:
        rank[:p] = rng.permutation(p)
        pos[:p] = rng.permutation(p)
    return a, g, rank, pos


CASES = {
    "p1": (1, 1, 1, {}),
    "p2_ties": (2, 2, 1, dict(ties=True)),
    "p2048_gang_2k_250": (2000, 2048, 8, {}),
    "p4096_16_gangs": (4096, 4096, 16, {}),
    "p4096_ties_unplaced_nonmembers": (3000, 4096, 5, dict(ties=True, members=0.75)),
    "p4096_one_group": (4096, 4096, 1, dict(one_group=True, ties=True)),
    "p8192_ties": (8000, 8192, 32, dict(ties=True, members=0.9)),
    "p16384_ties": (16000, 16384, 64, dict(ties=True, members=0.9)),
}
# chunks below the slice (several a CTA, more team levels): (case, rows)
CHUNKED = [("p2048_gang_2k_250", 128), ("p4096_ties_unplaced_nonmembers", 256),
           ("p8192_ties", 512), ("p16384_ties", 1024)]


def _case(name):
    p, p_max, groups, kw = CASES[name]
    return align_case(sum(map(ord, name)), p, p_max, groups, **kw)


def _plain(args):
    out = gcv.rank_align_plain(*(torch.from_numpy(x) for x in args))
    assert out.dtype == torch.int32
    return out.numpy()


def _jax(args):
    import jax.numpy as jnp

    from kubernetes_tpu.models import gangcover as jgc

    return np.asarray(jgc.rank_align_kernel(*(jnp.asarray(x) for x in args),
                                            p_max=args[0].shape[0]))


@pytest.mark.parametrize("cs", [16, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_model_matches_plain_and_jax(name, cs):
    args = _case(name)
    want = _plain(args)
    np.testing.assert_array_equal(want, _jax(args))
    got, info = tt.rank_align_model(*args, cs=cs)
    np.testing.assert_array_equal(got, want)
    assert info["plan"]["chunk"] == info["plan"]["slice"]


@pytest.mark.parametrize("cs", [16, 8])
@pytest.mark.parametrize("name,smem_rows", CHUNKED)
def test_chunked_slices_model_matches_plain(name, smem_rows, cs):
    """Slices of several chunks (a smaller chunk than the slice)."""
    args = _case(name)
    got, info = tt.rank_align_model(*args, cs=cs, smem_rows=smem_rows)
    assert info["plan"]["chunk"] == smem_rows < info["plan"]["slice"]
    assert [b for _, _, b in info["levels"]].count("cluster") == \
        info["plan"]["team_merge_levels"] > 0
    np.testing.assert_array_equal(got, _plain(args))


@pytest.mark.parametrize("p_max,local_levels,team_levels",
                         [(2, 0, 0), (64, 0, 1), (2048, 3, 3), (4096, 4, 3), (8192, 5, 3)])
def test_steps_and_their_barriers(p_max, local_levels, team_levels):
    """32-row runs by warp shuffles (no barrier), a block barrier a merge
    level inside a CTA's slice, a cluster barrier a team level."""
    args = align_case(3, p_max, p_max, 4)
    _, info = tt.rank_align_model(*args, cs=16)
    kinds = [b for _, _, b in info["levels"]]
    assert kinds == ["warp"] + ["block"] * local_levels + ["cluster"] * team_levels
    assert info["plan"]["slice"] == p_max // info["plan"]["active"]


def test_rank_align_wrapper_packs_one_upload(monkeypatch):
    """rank_align hands the kernel four rows of one [4, p_max] tensor."""
    seen = []

    def spy(*rows):
        seen.append(rows)
        return gcv.rank_align_plain(*rows)

    monkeypatch.setattr(gcv, "rank_align_kernel", spy)
    a = np.array([5, 6, 7], np.int32)
    g = np.zeros(3, np.int32)
    out = gcv.rank_align(a, g, np.array([2, 0, 1]), np.array([0, 1, 2]), device="cpu")
    np.testing.assert_array_equal(out, [7, 5, 6])
    rows = seen[0]
    assert len({r.untyped_storage().data_ptr() for r in rows}) == 1
    assert [r.shape[0] for r in rows] == [4] * 4


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card(args, device, smem_rows=None):
    dev = [torch.from_numpy(x).to(device) for x in args]
    before, cuda_before = kernels.LAUNCHES["rank_align"], kernels.CUDA_LAUNCHES["rank_align"]
    got = (gcv.rank_align_kernel(*dev) if smem_rows is None
           else kernels.launch_rank_align(*dev, _smem_rows=smem_rows))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rank_align"] == before + 1
    assert kernels.CUDA_LAUNCHES["rank_align"] == cuda_before + 1
    want = gcv.rank_align_plain(*dev)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return dict(kernels.LAST_RANK_ALIGN_PLAN)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_h_one_launch_matches_plain_on_card(cuda_device, name):
    plan = _on_card(_case(name), cuda_device)
    assert plan == kernels.rank_align_plan(CASES[name][1], plan["cluster_size"])


@pytest.mark.gpu
@pytest.mark.parametrize("p,p_max", [(30000, 32768), (65000, 65536)])
def test_kernel_h_large_p_max_on_card(cuda_device, p, p_max):
    plan = _on_card(align_case(p, p, p_max, 64, ties=True, members=0.9), cuda_device)
    assert plan == kernels.rank_align_plan(p_max, plan["cluster_size"])


@pytest.mark.gpu
@pytest.mark.parametrize("name,smem_rows", CHUNKED)
def test_kernel_h_chunked_slices_on_card(cuda_device, name, smem_rows):
    plan = _on_card(_case(name), cuda_device, smem_rows)
    assert plan["chunk"] == smem_rows < plan["slice"]


@pytest.mark.gpu
def test_kernel_h_p65536_in_chunks_of_2048_on_card(cuda_device):
    plan = _on_card(align_case(7, 65000, 65536, 64, ties=True, members=0.9), cuda_device, 2048)
    assert plan["chunk"] == 2048


@pytest.mark.gpu
def test_kernel_h_refused_shape_raises(cuda_device):
    args = [torch.from_numpy(x).to(cuda_device) for x in _case("p4096_16_gangs")]
    with pytest.raises(ValueError, match="power of two"):
        gcv.rank_align_kernel(*(a[:3000].contiguous() for a in args))
    with pytest.raises(ValueError, match="chunk of 3000 rows"):
        kernels.launch_rank_align(*args, _smem_rows=3000)
