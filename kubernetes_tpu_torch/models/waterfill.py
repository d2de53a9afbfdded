"""Water-filling batch solver — the fast path for constraint-free batches.

The counterpart of `kubernetes_tpu/models/waterfill.py`. Greedy scheduling
of identical pods is a water-filling process: each placement takes the
current-best node, whose score then decreases. For a group of identical pods
(same class AND same request vector) the j-th placement on node n has a
computable marginal score s[n, j], so the whole greedy sequence collapses
into ONE top-k over the [N, j_max] marginal-score matrix instead of one step
per pod (reference: schedule_one.go:754 prioritizeNodes).

Exactness: scores are evaluated against group-start normalization and made
monotone by a running min along j, so selections have the prefix property.
Filter correctness is exact: a selected slot always fits.

Two implementations of `waterfill_group`:
  waterfill_group_plain  plain PyTorch (waterfill_keys_plain, then
                         torch.topk)
  kernel C               csrc/waterfill.cu, one thread-block-cluster launch
                         a group (ops/kernels.py launch_waterfill_group)
`waterfill_group` sends CPU tensors to the plain version and CUDA tensors to
the kernel; it never falls back from one to the other. `waterfill_solve`
commits each group's placements into used / used_nz / pod_count /
port_taken with torch ops on the inputs' device, as the JAX package does
outside its jitted kernel, and reads the placements to the host once a
batch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.solver import (INT_MIN, SolverInputs, balanced_score, default_normalize,
                          least_allocated_score)

# the masked key of a slot that can never be chosen (waterfill.py:142)
SENTINEL = -(2**31) + 1


def host(a) -> np.ndarray:
    """A host numpy view of a tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def bucket_j_max(max_pods, pod_count, n: int, max_slots: int,
                 cap_hint: Optional[int] = None) -> Optional[int]:
    """Pow2-bucketed per-node slot depth for the waterfill sort key.

    j_max must cover every node's remaining pod headroom, or schedulable pods
    would be silently clipped; the int32 sort key bounds total slots at
    `max_slots` (max_total_score * slots < 2^31). Derived from the STATIC
    capacity (max_pods) when it fits; only when that blows the key range does
    the dynamic headroom (then a raw, unbucketed one) come in. cap_hint (the
    repair path's largest group size) tightens the depth when no group can
    ever fill a node. Returns None when the problem shape exceeds the key
    range entirely (callers fall back to the scan solver)."""
    max_pods = host(max_pods)
    cap = max(1, int(max_pods.max(initial=1)))
    if cap_hint is not None:
        cap = min(cap, max(1, int(cap_hint)))
    j_max = 1 << (cap - 1).bit_length()
    if n * j_max > max_slots:
        headroom = max(1, int((max_pods - host(pod_count)).max(initial=1)))
        if cap_hint is not None:
            headroom = min(headroom, max(1, int(cap_hint)))
        j_max = 1 << (headroom - 1).bit_length()
        if n * j_max > max_slots:
            if n * headroom > max_slots:
                return None
            j_max = headroom
    return j_max


def k_slots_for(group: int, n: int, j_max: int) -> int:
    """The top-k width of one group: pow2 of the group size, never wider
    than the slot count, floored at 256 slots (waterfill.py:188-189)."""
    k_slots = min(1 << (group - 1).bit_length(), n * j_max)
    return max(k_slots, min(256, n * j_max))


def waterfill_group(alloc, used, used_nz, pod_count, max_pods,
                    filter_ok_row, port_conflict_row, has_port: bool,
                    napref_row, has_napref, taint_row, img_row,
                    req, req_nz, bal_active, group_size: int,
                    j_max: int, k_slots: int,
                    gang_row=None, has_gang: bool = False):
    """Place `group_size` (<= k_slots) identical pods. Returns (k_per_node [N]
    int32, placement node ids [k_slots] int32 in greedy order, -1 beyond the
    placed ones). has_napref and bal_active are one-element bool tensors (a
    row of the class/pod tables); has_port is a host bool.

    CPU tensors run the plain version; CUDA tensors launch kernel C; any
    other device raises."""
    args = (alloc, used, used_nz, pod_count, max_pods, filter_ok_row, port_conflict_row,
            has_port, napref_row, has_napref, taint_row, img_row, req, req_nz, bal_active,
            group_size, j_max, k_slots, gang_row, has_gang)
    dev = alloc.device
    if dev.type == "cpu":
        return waterfill_group_plain(*args)
    if dev.type == "cuda":
        from ..ops.kernels import launch_waterfill_group

        return launch_waterfill_group(*args)
    raise ValueError(f"waterfill_group: no implementation for device {dev}")


def waterfill_keys_plain(alloc, used, used_nz, pod_count, max_pods,
                         filter_ok_row, port_conflict_row, has_port: bool,
                         napref_row, has_napref, taint_row, img_row,
                         req, req_nz, bal_active, j_max: int,
                         gang_row=None, has_gang: bool = False) -> torch.Tensor:
    """The [N, j_max] int32 greedy-order keys of one group (SENTINEL where a
    slot can never be chosen): the first half of waterfill_group_plain. While
    keys do not wrap int32 (the slot budgets of the callers), each row's
    valid keys are a prefix of the row, strictly descending: kernel C's
    selection rests on that."""
    n = alloc.shape[0]
    dev = alloc.device
    # J_n: how many of this pod fit on node n right now
    free = alloc - used
    with_req = torch.where(req[None, :] > 0, free // req.clamp(min=1)[None, :], j_max)
    j_cap = with_req.min(dim=1).values
    j_cap = torch.minimum(j_cap, max_pods - pod_count)
    j_cap = torch.where(filter_ok_row, j_cap, 0)
    # a class with host ports holds at most one pod per node, zero where taken
    if has_port:
        j_cap = torch.where(port_conflict_row, 0, j_cap.clamp(max=1))
    j_cap = j_cap.clamp(0, j_max)

    # static per-node score, normalized over the group-start feasible set
    feas0 = j_cap > 0
    napref = torch.where(has_napref, default_normalize(napref_row, feas0, reverse=False), 0)
    taint = default_normalize(taint_row, feas0, reverse=True)
    static = 2 * napref + 3 * taint + img_row
    if has_gang:
        static = static + gang_row

    # marginal LeastAllocated + Balanced for j = 0..j_max-1 pods already
    # added, through the scan solver's own formula helpers: the [j_max * N]
    # rows are the nodes repeated once per j
    js = torch.arange(j_max, dtype=torch.int32, device=dev)
    alloc_j = alloc[:, :2].repeat(j_max, 1)
    used_nz_j = (used_nz[None, :, :2] + js[:, None, None] * req_nz[None, None, :2]).reshape(-1, 2)
    used_j = (used[None, :, :2] + js[:, None, None] * req[None, None, :2]).reshape(-1, 2)
    dyn = (least_allocated_score(alloc_j, used_nz_j, req_nz[:2])
           + balanced_score(alloc_j, used_j, req[:2], bal_active))
    score = dyn.reshape(j_max, n).T + static[:, None]  # [N, J]
    # prefix property: marginal scores non-increasing in j
    score = torch.cummin(score, dim=1).values
    score = torch.where(js[None, :] < j_cap[:, None], score, INT_MIN)

    # greedy order = (score desc, node asc, j asc) as one int32 key:
    # score * (slots + 1) - slot_rank, wrapping like XLA (int64, then cut)
    slots = n * j_max
    rank = torch.arange(slots, dtype=torch.int64, device=dev).reshape(n, j_max)
    key = (score.long() * (slots + 1) - rank).to(torch.int32)
    return torch.where(score <= INT_MIN, SENTINEL, key)


def waterfill_group_plain(alloc, used, used_nz, pod_count, max_pods,
                          filter_ok_row, port_conflict_row, has_port: bool,
                          napref_row, has_napref, taint_row, img_row,
                          req, req_nz, bal_active, group_size: int,
                          j_max: int, k_slots: int,
                          gang_row=None, has_gang: bool = False):
    """Plain PyTorch version of kernel C (the CPU path of waterfill_group and
    the reference the kernel is held against on the card)."""
    n = alloc.shape[0]
    dev = alloc.device
    key = waterfill_keys_plain(alloc, used, used_nz, pod_count, max_pods, filter_ok_row,
                               port_conflict_row, has_port, napref_row, has_napref, taint_row,
                               img_row, req, req_nz, bal_active, j_max, gang_row, has_gang)
    top_keys, top_idx = torch.topk(key.reshape(-1), k_slots)
    chosen = (top_keys > SENTINEL) & (torch.arange(k_slots, device=dev) < group_size)
    node = (top_idx // j_max).to(torch.int32)
    chosen_nodes = torch.where(chosen, node, -1)
    k_per_node = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    k_per_node.index_add_(0, torch.where(chosen, node, n).long(), chosen.to(torch.int32))
    return k_per_node[:n], chosen_nodes


def waterfill_solve(inp: SolverInputs, groups: List[Tuple[np.ndarray, int]]):
    """Solve a batch as a sequence of identical-pod groups (one waterfill_group
    call each). groups: (member pod indices in queue order, class id).
    Returns assignment[P] int32 (host numpy) like greedy_scan_solve, or None
    when the shape exceeds the int32 sort-key range (the caller falls back
    to the scan). Each group's placements stay on the device until the
    batch's end: the host reads them once a batch, not once a group."""
    p = inp.req.shape[0]
    n = inp.alloc.shape[0]
    has_gang = inp.gang_bonus is not None
    # slot budget: max_total_score 800 * slots < 2^31 (gang bonus: +100)
    max_slots = 2_300_000 if has_gang else 2_600_000
    j_max = bucket_j_max(inp.max_pods, inp.pod_count, n, max_slots)
    if j_max is None:
        return None
    assignment = np.full(p, -1, dtype=np.int32)
    used, used_nz, pod_count = inp.used, inp.used_nz, inp.pod_count
    port_taken = inp.node_ports
    class_ports = host(inp.class_ports)
    placed = []  # per group: its members and its placements on the device

    for members, cls in groups:
        pi0 = int(members[0])
        has_port = bool(class_ports[cls].any())
        port_conflict = (port_taken & inp.class_ports[cls][None, :]).any(dim=1)
        k_per_node, chosen_nodes = waterfill_group(
            inp.alloc, used, used_nz, pod_count, inp.max_pods,
            inp.filter_ok[cls], port_conflict, has_port,
            inp.napref_raw[cls], inp.has_napref[cls], inp.taint_cnt[cls], inp.img_score[cls],
            inp.req[pi0], inp.req_nz[pi0], inp.balanced_active[pi0], len(members),
            j_max=j_max, k_slots=k_slots_for(len(members), n, j_max),
            gang_row=inp.gang_bonus[cls] if has_gang else None, has_gang=has_gang)
        placed.append((members, chosen_nodes[:len(members)]))
        # commit the group's effects
        used = used + k_per_node[:, None] * inp.req[pi0][None, :]
        used_nz = used_nz + k_per_node[:, None] * inp.req_nz[pi0][None, :]
        pod_count = pod_count + k_per_node
        if has_port:
            port_taken = port_taken | ((k_per_node > 0)[:, None] & inp.class_ports[cls][None, :])
    if placed:
        got = host(torch.cat([c for _, c in placed]))  # the batch's one read
        if inp.alloc.device.type == "cuda":
            from ..ops import kernels

            kernels.bump(kernels.HOST_SYNCS, "waterfill")
        at = 0
        for members, c in placed:
            chosen = np.full(len(members), -1, dtype=np.int32)
            chosen[:c.shape[0]] = got[at:at + c.shape[0]]  # k_slots may be < group size
            at += c.shape[0]
            assignment[np.asarray(members)] = chosen
    return assignment


def make_groups(batch) -> List[Tuple[np.ndarray, int]]:
    """Group batch pods by (class, resource vector), preserving queue order of
    first appearance (the fast path's priority approximation)."""
    keys = {}
    order = []
    for i in range(len(batch.pods)):
        k = (int(batch.class_of_pod[i]), batch.req[i].tobytes(), batch.req_nz[i].tobytes(),
             bool(batch.balanced_active[i]))
        if k not in keys:
            keys[k] = []
            order.append(k)
        keys[k].append(i)
    return [(np.array(keys[k], dtype=np.int64), k[0]) for k in order]
