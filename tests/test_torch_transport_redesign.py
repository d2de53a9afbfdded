"""Kernels E and F as one thread-block cluster each, checked on the CPU.

- Kernel E accepts only at the nodes that got a bid (and, in round 1, at
  every node whose x0 is not zero), and merges each group's K + 1 best from
  the CTAs' own K + 1 best. testing.auction_phase_touched is that round in
  numpy; it must give the same x, price, level and rounds as the port's
  plain version (models/transport.py _auction_phase_plain) and as the JAX
  reference's `_auction_phase` (jitted on the CPU, as its own tests run it),
  exactly, on the seeded transport_problem cases (scarce, equal levels, a
  dead group, a warm price, the max_rounds cuts) and on a warm x0 that
  overfills nodes, for cluster sizes 16 and 8.
- The layout plans of E and F (ops/kernels.py auction_plan, sinkhorn_plan):
  which regions sit in shared memory at the shapes chip_smoke.py drives,
  and where the global slice takes over.
- The kernel build key covers the headers a source includes.
The kernels themselves are held against the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models import transport as jtr
from kubernetes_tpu_torch.models import transport as ttr
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.testing import (auction_phase_touched, overfilled_start,
                                          transport_problem)

ARGS = ("utility", "jcap", "supply", "slots", "req", "free")


def three_ways(p, eps, max_rounds=400, price0=None, start=None, cs=16):
    """(JAX, port plain, touched model) outputs as numpy, for one phase."""
    g, n = p["utility"].shape
    price0 = np.zeros(n, np.float32) if price0 is None else price0
    x0, level0 = start if start is not None else (np.zeros((g, n), np.int32),
                                                  np.full((g, n), -1e30, np.float32))
    j = jtr._auction_phase(*(jnp.asarray(p[k]) for k in ARGS), jnp.asarray(x0),
                           jnp.asarray(price0), jnp.asarray(level0), jnp.float32(eps), max_rounds)
    t = ttr._auction_phase_plain(*(torch.from_numpy(p[k]) for k in ARGS), torch.from_numpy(x0),
                                 torch.from_numpy(price0.copy()), torch.from_numpy(level0.copy()),
                                 eps, max_rounds)
    m = auction_phase_touched(*(p[k] for k in ARGS), x0, price0, level0, eps, max_rounds, cs=cs)
    return ([np.asarray(a) for a in j[:3]] + [int(j[3])],
            [a.numpy() for a in t[:3]] + [t[3]], list(m))


def assert_all_equal(outs):
    ref = outs[0]
    for got in outs[1:]:
        for a, b in zip(got[:3], ref[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[3] == ref[3]


CASES = {
    "scarce": dict(g=5, n=24, scarce=True),
    "equal_levels": dict(g=3, n=24, ties=True),
    "equal_levels_scarce": dict(g=8, n=24, ties=True, scarce=True),
    "dead_group": dict(g=5, n=24, dead_group=True),
    "one_group_large_supply": dict(g=1, n=40, supply_hi=2000),
    "fewer_nodes_than_k": dict(g=2, n=10),
    "ragged_slices": dict(g=4, n=70, scarce=True),
}


@pytest.mark.parametrize("cs", [16, 8])
@pytest.mark.parametrize("eps", [40.0, 0.9])
@pytest.mark.parametrize("case", sorted(CASES))
def test_touched_round_matches_plain_and_jax(case, eps, cs):
    p = transport_problem(sorted(CASES).index(case) + 200, **CASES[case])
    assert_all_equal(three_ways(p, eps, cs=cs))


@pytest.mark.parametrize("seed", range(3))
def test_touched_round_warm_price_matches(seed):
    p = transport_problem(210 + seed, g=4, n=64, ties=True)
    price0 = np.random.default_rng(seed).integers(0, 5, size=64).astype(np.float32)
    assert_all_equal(three_ways(p, 0.9, price0=price0))


@pytest.mark.parametrize("max_rounds", [1, 2, 3])
def test_touched_round_max_rounds_cut_matches(max_rounds):
    p = transport_problem(220, g=5, n=48, scarce=True)
    outs = three_ways(p, 0.9, max_rounds=max_rounds)
    assert_all_equal(outs)
    assert outs[0][3] <= max_rounds


@pytest.mark.parametrize("max_rounds", [1, 2, 3, 400])
@pytest.mark.parametrize("seed", range(2))
def test_touched_round_overfilled_warm_start_matches(seed, max_rounds):
    """A warm x0 overfills nodes: the reference re-knapsacks them in round 1
    and drops units there, so round 1 must walk every node that holds units
    even where no bid lands."""
    p = transport_problem(230 + seed, g=5, n=48, scarce=True)
    x0, level0 = overfilled_start(p, seed)
    outs = three_ways(p, 0.9, max_rounds=max_rounds, start=(x0, level0))
    assert_all_equal(outs)
    held = (x0 > 0).any(axis=0)
    assert (outs[0][0][:, held] < x0[:, held]).any()  # round 1 dropped held units


def test_touched_round_no_round_returns_the_start():
    """max_rounds 0: x0, price0 and level0 come back as given (no level
    reset)."""
    p = transport_problem(240, g=3, n=24)
    x0, level0 = overfilled_start(p, 1)
    outs = three_ways(p, 0.9, max_rounds=0, start=(x0, level0))
    assert_all_equal(outs)
    np.testing.assert_array_equal(outs[2][2], level0)


# ---------------------------------------------------------------------------
# the layout plans
# ---------------------------------------------------------------------------

SHAPES = [(g, n) for g in (1, 8, 2100) for n in (40, 300, 5000, 10000)]


def check_layout(plan, regions):
    off, goff = plan["off"], plan["goff"]
    assert list(off) == list(regions)
    placed = sorted((off[k], k) for k in regions if off[k] >= 0)
    assert all(o % 16 == 0 for o, _ in placed)
    assert plan["smem_bytes"] <= kernels.CLUSTER_SMEM_BUDGET
    assert plan["in_smem"] == [k for k in regions if off[k] >= 0]
    assert plan["in_global"] == [k for k in regions if off[k] < 0]
    slices = [k for k in plan["in_global"] if k != "exchange"]
    assert [goff[k] for k in slices] == sorted(goff[k] for k in slices)
    assert plan["exchange"] == ("st.async" if "exchange" in plan["in_smem"]
                                else "global + barrier.cluster")


@pytest.mark.parametrize("cs", [16, 8])
@pytest.mark.parametrize("g,n", SHAPES)
def test_auction_plan_at_chip_smoke_shapes(g, n, cs):
    plan = kernels.auction_plan(g, n, 3, cs)
    check_layout(plan, kernels.AUCTION_REGIONS)
    chunk = -(-n // cs)
    assert plan["cluster_size"] == cs and plan["nodes_per_cta"] == chunk
    assert plan["threads"] == kernels.AUCTION_THREADS
    # G <= 8 keeps the whole phase in shared memory up to 5,000 nodes (the
    # transport batches); G 2,100 sends the lists through global memory
    if g <= 8 and n <= 5000:
        assert plan["in_global"] == [] and plan["global_bytes_per_cta"] == 0
    if g == 2100:
        assert {"exchange", "candidates"} <= set(plan["in_global"])
    assert plan["exchange_bytes"] == 2 * cs * g * 17 * 16


def test_auction_plan_sizes_by_hand():
    """G 1 x N 5,000, R 3, 16 CTAs (the first Transport_50k phase): 313
    nodes a CTA; groups 24 -> 32 bytes, nodes 7 x 313 x 4 = 8,764 -> 8,768,
    exchange 2 x 16 x 17 x 16 = 8,704, lists 8 warps x 32 lanes x 17 x 8 =
    34,816, cells 6 x 313 x 4 = 7,512 -> 7,520, candidates 8 warps x 2 x 16
    = 256."""
    plan = kernels.auction_plan(1, 5000, 3, 16)
    assert plan["off"] == {"groups": 0, "nodes": 32, "exchange": 8800, "lists": 17504,
                           "cells": 52320, "candidates": 59840}
    assert plan["smem_bytes"] == 60096


@pytest.mark.parametrize("cs", [16, 8])
def test_auction_plan_global_slice_takes_over_by_shape(cs):
    """At G 8 the cells leave shared memory at the first N whose regions no
    longer fit the budget, and stay out for every larger N."""
    def fits(n):
        chunk = -(-n // cs)
        need = (kernels._align16(6 * 8 * 4) + kernels._align16(7 * chunk * 4)
                + 2 * cs * 8 * 17 * 16 + 8 * 32 * 17 * 8 + kernels._align16(6 * 8 * chunk * 4))
        return need <= kernels.CLUSTER_SMEM_BUDGET

    first = next(n for n in range(1, 100000) if not fits(n))
    assert "cells" in kernels.auction_plan(8, first - 1, 3, cs)["in_smem"]
    for n in (first, first + 1, 2 * first):
        assert "cells" in kernels.auction_plan(8, n, 3, cs)["in_global"]


@pytest.mark.parametrize("cs", [16, 8])
@pytest.mark.parametrize("g,n", SHAPES)
def test_sinkhorn_plan_at_chip_smoke_shapes(g, n, cs):
    plan = kernels.sinkhorn_plan(g, n, cs)
    check_layout(plan, kernels.SINKHORN_REGIONS)
    chunk = plan["nodes_per_cta"]
    assert -(-n // cs) <= chunk <= -(-n // cs) + 4 * (plan["row_threads_per_cta"] + 1)
    assert plan["threads"] % 32 == 0 and 64 <= plan["threads"] <= kernels.SINKHORN_MAX_THREADS
    assert plan["threads"] >= min(chunk, kernels.SINKHORN_MAX_THREADS)
    if g <= 8:  # every transport batch: z and the exchange in shared memory
        assert plan["in_global"] == []
    if "z" in plan["in_global"]:
        assert plan["global_bytes_per_cta"] >= kernels._align16(g * plan["nodes_per_cta"] * 4)


def test_sinkhorn_plan_sizes_by_hand():
    """G 8 x N 5,000 (TransportMixed), 16 CTAs: torch adds a row over 64
    threads of float4 vectors (1,250 vectors: threads 0-33 take 20, the rest
    19), CTA c owns threads c, c + 16, c + 32, c + 48: 316 nodes for c < 2,
    312 else; 320 threads. groups (4 x 8 + 4 x 8 x 4 + 4 + 1) x 4 = 660 ->
    672, nodes 4 x 316 x 4 = 5,056, exchange 16 x 8 x 4 x 2 = 1,024, z 8 x
    316 x 4 = 10,112. G 128 x N 10,000 puts z in the global slice and G
    2,100 (16 CTAs) or 3,600 (8) at N 40 the exchange in global memory."""
    plan = kernels.sinkhorn_plan(8, 5000, 16)
    assert plan["order"] == dict(vec=True, bw=64, by=1, cy=1, exact=True)
    assert plan["nodes_per_cta"] == 316 and plan["threads"] == 320
    assert plan["off"] == {"groups": 0, "nodes": 672, "exchange": 5728, "z": 6752}
    assert plan["smem_bytes"] == 16864
    for cs, g in ((16, 2100), (8, 3600)):
        big = kernels.sinkhorn_plan(128, 10000, cs)
        assert big["in_global"] == ["z"]
        assert "exchange" in kernels.sinkhorn_plan(g, 40, cs)["in_global"]


# torch's CUDA sum layouts read off the card (NVIDIA H100, torch 2.11):
# sums of seeded [G, N] float32 tensors over dim 1 and dim 0 were matched
# bit for bit by this order at every shape below (the misaligned rows of N
# % 4 != 0 excepted, as sinkhorn_order says)
TORCH_ORDERS = {
    (1, 5000): (True, 512, 1, 1), (8, 5000): (True, 64, 1, 1), (5, 300): (True, 64, 1, 1),
    (3, 24): (False, 16, 1, 1), (2, 7): (False, 4, 1, 1), (3, 1): (False, 1, 1, 1),
    (128, 10000): (True, 32, 16, 4), (2100, 40): (False, 32, 1, 16), (2, 5000): (True, 256, 1, 1),
    (1, 10000): (True, 512, 1, 1), (64, 1000): (True, 32, 1, 4), (3500, 40): (False, 32, 1, 16),
}


@pytest.mark.parametrize("g,n", sorted(TORCH_ORDERS))
def test_sinkhorn_order_mirrors_torch(g, n):
    vec, bw, by, cy = TORCH_ORDERS[g, n]
    assert kernels.sinkhorn_order(g, n) == dict(vec=vec, bw=bw, by=by, cy=cy, exact=True)


def _row_elements(t, x, y, order, n):
    """Row thread t's nodes in torch's order (element s into accumulator s % 4)."""
    w = order["bw"] * order["by"]
    if not order["vec"]:
        return list(range(t, n, w))
    v = n // 4
    out = [4 * u + i for u in range(t, v, w) for i in range(4)]
    return out + ([4 * v + x] if y == 0 and x < n - 4 * v else [])


def _partial(row, elems):
    acc = [np.float32(0)] * 4
    for s, j in enumerate(elems):
        acc[s % 4] = np.float32(acc[s % 4] + row[j])
    return np.float32(np.float32(np.float32(acc[0] + acc[1]) + acc[2]) + acc[3])


def _halving(v):
    v, o = list(v), len(v) // 2
    while o:
        for k in range(o):
            v[k] = np.float32(v[k] + v[k + o])
        o //= 2
    return v[0]


@pytest.mark.parametrize("cs", [16, 8])
@pytest.mark.parametrize("g,n", [(1, 5000), (8, 5000), (5, 300), (3, 24), (2, 7), (3, 1),
                                 (4, 130), (2, 20000), (16, 700)])
def test_sinkhorn_cluster_split_keeps_torch_order(g, n, cs):
    """Kernel F's split of a row sum over the cluster (CTA c owns row
    threads x = c, c + cx, ...; the x tree's levels at offsets >= cx in the
    CTA, the rest and the y tree over the CTAs' partials) adds in torch's
    order bit for bit, and the CTAs' nodes partition the row."""
    order = kernels.sinkhorn_order(g, n)
    bw, by = order["bw"], order["by"]
    cx = min(cs, bw)
    row = np.exp(-np.random.default_rng(n).random(n) * 20).astype(np.float32)
    whole = _halving([_halving([_partial(row, _row_elements(x + bw * y, x, y, order, n))
                                for x in range(bw)]) for y in range(by)])
    parts, seen = {}, []
    for c in range(cx):
        for y in range(by):
            elems = [_row_elements(c + cx * m + bw * y, c + cx * m, y, order, n)
                     for m in range(bw // cx)]
            seen += [j for e in elems for j in e]
            parts[c, y] = _halving([_partial(row, e) for e in elems])
    split = _halving([_halving([parts[c, y] for c in range(cx)]) for y in range(by)])
    assert split == whole
    assert sorted(seen) == list(range(n))
    counts = kernels._sinkhorn_counts(order, n, cs)
    assert sum(counts) == n and max(counts) == kernels.sinkhorn_plan(g, n, cs)["nodes_per_cta"]


# ---------------------------------------------------------------------------
# the build key
# ---------------------------------------------------------------------------


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """Editing csrc/cluster_exchange.cuh changes the library name of A, C, E,
    F and J, and editing csrc/block_scan.cuh that of C and G (so a stale
    build is never reused), and of no other kernel."""
    for f in kernels.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    includes = {"greedy_scan": ["cluster_exchange.cuh"], "auction_phase": ["cluster_exchange.cuh"],
                "sinkhorn": ["cluster_exchange.cuh"],
                "waterfill": ["block_scan.cuh", "cluster_exchange.cuh"],
                "cover_curve": ["block_scan.cuh"],
                "feasibility_rows": ["cluster_exchange.cuh"],
                "repair_check": ["cluster_exchange.cuh"], "rank_align": ["cluster_exchange.cuh"]}
    for name, headers in includes.items():
        assert [f.name for f in kernels._sources_of(tmp_path / kernels.SOURCES[name])] == [
            kernels.SOURCES[name], *headers]
    for header_name in ("cluster_exchange.cuh", "block_scan.cuh"):
        users = {name for name, headers in includes.items() if header_name in headers}
        before = {name: kernels._lib_path(name) for name in kernels.SOURCES}
        header = tmp_path / header_name
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        after = {name: kernels._lib_path(name) for name in kernels.SOURCES}
        assert {name for name in kernels.SOURCES if after[name] != before[name]} == users
    assert kernels._lib_path("auction_phase") == after["auction_phase"]  # stable


def test_build_key_raises_on_a_missing_header(tmp_path, monkeypatch):
    for f in kernels.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "cluster_exchange.cuh").unlink()
    with pytest.raises(FileNotFoundError, match="cluster_exchange.cuh"):
        kernels._lib_path("sinkhorn")
