"""Gang victim cover and rank alignment (kernels G and H).

The counterpart of `kubernetes_tpu/models/gangcover.py`. Two problems the
gang preemptor (scheduler/gangpreempt.py) and the rank-aware placement pass
(scheduler/batch.py) hand to this module:

  victim cover    for ONE slice, the capacity curve of eviction: caps[k] =
                  how many gang members the slice hosts after evicting the
                  first k victims of a caller-ordered victim list. The
                  preemptor takes the smallest k with caps[k] >= quorum, or
                  vetoes when no k reaches it on any slice (a partial
                  eviction that strands a half-placed gang is what this
                  exists to prevent). Kernel G, `csrc/cover_curve.cu`;
                  cover_curve_plain mirrors the JAX body with torch ops and
                  cover_curve_host is the numpy oracle. The preemptor hands
                  every slice of one attempt to cover_curves_batched: one
                  packed copy, one launch (one CTA a slice), one read.
  rank alignment  the solver places a gang's identical members as an
                  interchangeable group, so which MEMBER lands on which node
                  is a free permutation. rank_align matches rank order to
                  ring-position order per (gang, class, request) group (the
                  sorted-to-sorted matching minimizes consecutive-rank
                  gaps). Kernel H, `csrc/rank_align.cu`; rank_align_plain
                  uses stable torch sorts and rank_align_host is the numpy
                  oracle.

The wrappers cover_curves and rank_align pad to the same power-of-two
buckets as JAX and take a device: "cuda" (the default) launches the kernel
for every call, "cpu" runs the plain version. Unlike the JAX wrapper,
cover_curves never hands a shape to the numpy oracle (JAX does for k == 0 or
a padded [K+1, Ns, R] tensor above 4,000,000 elements, because XLA
materializes that tensor; kernel G does not). The outputs are the same.
Everything is int32 on the device, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.solver import resolve_device

# victims considered per slice (ordered best-first by victim_order, so the
# cap drops only the WORST candidates); the preemptor counts it in its
# victims_capped stat
COVER_MAX_VICTIMS = 1024

_INT32_BIG = 2**30  # "infinite" capacity / unplaced-position sentinel


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


# -- victim ordering ----------------------------------------------------------


def victim_order(prio: np.ndarray, freed_norm: np.ndarray) -> np.ndarray:
    """Eviction order for a candidate victim list: lowest priority first,
    then the victim freeing the MOST capacity, then index."""
    idx = np.arange(len(prio))
    return np.lexsort((idx, -np.asarray(freed_norm, dtype=np.int64),
                       np.asarray(prio, dtype=np.int64)))


# -- kernel G: the victim cover curve ------------------------------------------


def cover_curve_plain(free: torch.Tensor, headroom: torch.Tensor, eligible: torch.Tensor,
                      v_node: torch.Tensor, v_req: torch.Tensor, req: torch.Tensor
                      ) -> torch.Tensor:
    """caps[k], k = 0..k_max: gang members the slice fits after evicting the
    first k victims (plain version of kernel G, the JAX body in torch ops).
    free [n_slots, R] int32, headroom [n_slots] int32, eligible [n_slots]
    bool, v_node [k_max] int32 (slice-local node, -1 pads), v_req [k_max, R]
    int32, req [R] int32 -> [k_max + 1] int32."""
    n_slots, r = free.shape
    i32 = torch.int32
    valid = v_node >= 0
    onehot = ((v_node[:, None] == torch.arange(n_slots, dtype=i32, device=free.device)[None, :])
              & valid[:, None])
    freed1 = torch.cumsum(onehot[:, :, None].to(i32) * v_req[:, None, :], dim=0, dtype=i32)
    freed = torch.cat([torch.zeros((1, n_slots, r), dtype=i32, device=free.device), freed1])
    rel1 = torch.cumsum(onehot.to(i32), dim=0, dtype=i32)
    released = torch.cat([torch.zeros((1, n_slots), dtype=i32, device=free.device), rel1])
    avail = free[None, :, :] + freed
    nz = req > 0
    per = torch.where(nz[None, None, :],
                      torch.div(avail, torch.clamp(req, min=1)[None, None, :],
                                rounding_mode="floor"),
                      torch.tensor(_INT32_BIG, dtype=i32, device=free.device))
    cap = per.amin(dim=2)
    cap = torch.minimum(cap, headroom[None, :] + released)
    cap = torch.where(eligible[None, :], torch.clamp(cap, min=0), torch.zeros_like(cap))
    return cap.sum(dim=1).to(i32)  # the int64 sum cast back wraps like int32


def cover_curve(free, headroom, eligible, v_node, v_req, req) -> torch.Tensor:
    """Kernel G for CUDA tensors, its plain version for CPU tensors."""
    if free.device.type == "cpu":
        return cover_curve_plain(free, headroom, eligible, v_node, v_req, req)
    if free.device.type == "cuda":
        from ..ops.kernels import launch_cover_curve

        return launch_cover_curve(free, headroom, eligible, v_node, v_req, req)
    raise ValueError(f"cover_curve: no implementation for device {free.device}")


def cover_curve_host(free: np.ndarray, headroom: np.ndarray, eligible: np.ndarray,
                     v_node: np.ndarray, v_req: np.ndarray, req: np.ndarray) -> np.ndarray:
    """Numpy oracle of the cover curve (unpadded): one incremental pass,
    O(R) work per victim. Returns caps[len(v_node) + 1] int64."""
    free = np.asarray(free, dtype=np.int64).copy()
    headroom = np.asarray(headroom, dtype=np.int64).copy()
    eligible = np.asarray(eligible, dtype=bool)
    req = np.asarray(req, dtype=np.int64)
    nz = req > 0

    def node_cap(n: int) -> int:
        if not eligible[n]:
            return 0
        c = int(headroom[n])
        if nz.any():
            c = min(c, int((free[n, nz] // req[nz]).min()))
        return max(c, 0)

    caps = np.empty(len(v_node) + 1, dtype=np.int64)
    cap_by_node = np.array([node_cap(n) for n in range(free.shape[0])], dtype=np.int64)
    total = int(cap_by_node.sum())
    caps[0] = total
    for k, n in enumerate(np.asarray(v_node, dtype=np.int64).tolist()):
        free[n] += np.asarray(v_req[k], dtype=np.int64)
        headroom[n] += 1
        new = node_cap(n)
        total += new - int(cap_by_node[n])
        cap_by_node[n] = new
        caps[k + 1] = total
    return caps


def cover_curves(free: np.ndarray, headroom: np.ndarray, eligible: np.ndarray,
                 v_node: np.ndarray, v_req: np.ndarray, req: np.ndarray,
                 device="cuda") -> np.ndarray:
    """Pad to the power-of-two buckets (n_slots, k_max) and run the curve on
    `device`. Returns caps[len(v_node) + 1] as numpy int64."""
    device = resolve_device(device)
    k = len(v_node)
    ns, r = free.shape
    n_slots, k_max = _pow2(ns), _pow2(k)
    free_p = np.zeros((n_slots, r), dtype=np.int32)
    free_p[:ns] = free
    head_p = np.zeros(n_slots, dtype=np.int32)
    head_p[:ns] = headroom
    elig_p = np.zeros(n_slots, dtype=bool)
    elig_p[:ns] = eligible
    vn_p = np.full(k_max, -1, dtype=np.int32)
    vn_p[:k] = v_node
    vr_p = np.zeros((k_max, r), dtype=np.int32)
    vr_p[:k] = v_req

    def t(a):
        return torch.from_numpy(a).to(device)

    caps = cover_curve(t(free_p), t(head_p), t(elig_p), t(vn_p), t(vr_p),
                       t(np.asarray(req, dtype=np.int32)))
    return caps.cpu().numpy()[: k + 1].astype(np.int64)


def cover_curve_batch_plain(free: torch.Tensor, headroom: torch.Tensor, eligible: torch.Tensor,
                            v_node: torch.Tensor, v_req: torch.Tensor, req: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version of kernel G over S slices: free [S, n_slots, R],
    headroom and eligible [S, n_slots], v_node [S, k_max], v_req [S, k_max,
    R], req [R] -> caps [S, k_max + 1] int32, slice s's row equal to
    cover_curve_plain of slice s."""
    rows = [cover_curve_plain(free[s], headroom[s], eligible[s], v_node[s], v_req[s], req)
            for s in range(free.shape[0])]
    if not rows:
        return torch.zeros((0, v_node.shape[1] + 1), dtype=torch.int32, device=free.device)
    return torch.stack(rows)


def cover_curve_batch(free, headroom, eligible, v_node, v_req, req) -> torch.Tensor:
    """Kernel G over S slices in one launch for CUDA tensors, its plain
    version for CPU tensors."""
    if free.device.type == "cpu":
        return cover_curve_batch_plain(free, headroom, eligible, v_node, v_req, req)
    if free.device.type == "cuda":
        from ..ops.kernels import launch_cover_curves

        return launch_cover_curves(free, headroom, eligible, v_node, v_req, req)
    raise ValueError(f"cover_curve_batch: no implementation for device {free.device}")


def cover_curves_batched(slices: Sequence[Tuple[np.ndarray, ...]], req: np.ndarray,
                         device="cuda") -> List[np.ndarray]:
    """Every slice of one cover attempt as one problem: `slices` holds, per
    slice, (free [ns, R], headroom [ns], eligible [ns], v_node [k] slice-local,
    v_req [k, R]) as numpy; all are padded to the power-of-two buckets of the
    largest (n_slots, k_max) and packed into one buffer, so the device sees
    one host-to-device copy, one launch of kernel G (one CTA a slice) and
    one read back. Returns each slice's caps[k + 1] as numpy int64, equal to
    cover_curves on that slice alone."""
    device = resolve_device(device)
    if not slices:
        return []
    s = len(slices)
    r = int(np.asarray(req).shape[0])
    n_slots = _pow2(max(int(x[0].shape[0]) for x in slices))
    k_max = _pow2(max(len(x[3]) for x in slices))
    # int32 sections (4-byte aligned), then the bool one
    shapes = {"free": (s, n_slots, r), "headroom": (s, n_slots), "v_node": (s, k_max),
              "v_req": (s, k_max, r), "req": (r,)}
    offs, at = {}, 0
    for name, shape in shapes.items():
        offs[name] = at
        at += 4 * int(np.prod(shape))
    offs["eligible"] = at
    buf = np.zeros(at + s * n_slots, dtype=np.uint8)

    def view(name, dtype=np.int32):
        shape = shapes.get(name, (s, n_slots))
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return buf[offs[name]:offs[name] + n].view(dtype).reshape(shape)

    free_p, head_p, elig_p = view("free"), view("headroom"), view("eligible", np.bool_)
    vn_p, vr_p = view("v_node"), view("v_req")
    vn_p[:] = -1
    view("req")[:] = req
    for i, (free, headroom, eligible, v_node, v_req) in enumerate(slices):
        ns, k = free.shape[0], len(v_node)
        free_p[i, :ns] = free
        head_p[i, :ns] = headroom
        elig_p[i, :ns] = eligible
        vn_p[i, :k] = v_node
        vr_p[i, :k] = v_req
    dev = torch.from_numpy(buf).to(device)  # the one host-to-device copy

    def t(name, dtype=torch.int32):
        shape = shapes.get(name, (s, n_slots))
        n = int(np.prod(shape)) * (1 if dtype is torch.bool else 4)
        return dev[offs[name]:offs[name] + n].view(dtype).view(shape)

    caps = cover_curve_batch(t("free"), t("headroom"), t("eligible", torch.bool), t("v_node"),
                             t("v_req"), t("req"))
    host = caps.cpu().numpy().astype(np.int64)  # the one read back
    if device.type == "cuda":
        from ..ops import kernels

        kernels.bump(kernels.HOST_SYNCS, "cover_curve")
    return [host[i, :len(x[3]) + 1] for i, x in enumerate(slices)]


# -- kernel H: rank alignment ---------------------------------------------------


def _lexsort_order(group: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Indices sorting rows by (group, key, index): two stable sorts."""
    o = torch.sort(key, stable=True).indices
    return o[torch.sort(group[o], stable=True).indices]


def rank_align_plain(assignment: torch.Tensor, group_id: torch.Tensor, rank: torch.Tensor,
                     pos_key: torch.Tensor) -> torch.Tensor:
    """Permute assignments WITHIN each group so rank order matches position
    order: out[order_rank] = assignment[order_pos], where order_rank sorts
    rows by (group, rank, index) and order_pos by (group, pos_key, index)
    (plain version of kernel H). All [p_max] int32."""
    order_rank = _lexsort_order(group_id, rank)
    order_pos = _lexsort_order(group_id, pos_key)
    out = torch.zeros_like(assignment)
    out[order_rank] = assignment[order_pos]
    return out


def rank_align_kernel(assignment, group_id, rank, pos_key) -> torch.Tensor:
    """Kernel H for CUDA tensors, its plain version for CPU tensors."""
    if assignment.device.type == "cpu":
        return rank_align_plain(assignment, group_id, rank, pos_key)
    if assignment.device.type == "cuda":
        from ..ops.kernels import launch_rank_align

        return launch_rank_align(assignment, group_id, rank, pos_key)
    raise ValueError(f"rank_align: no implementation for device {assignment.device}")


def rank_align_host(assignment: np.ndarray, group_id: np.ndarray,
                    rank: np.ndarray, pos_key: np.ndarray) -> np.ndarray:
    """Numpy oracle of the rank alignment."""
    idx = np.arange(len(assignment))
    order_rank = np.lexsort((idx, rank, group_id))
    order_pos = np.lexsort((idx, pos_key, group_id))
    out = np.zeros_like(assignment)
    out[order_rank] = assignment[order_pos]
    return out


def rank_align(assignment: np.ndarray, group_id: np.ndarray, rank: np.ndarray,
               pos_key: np.ndarray, device="cuda") -> np.ndarray:
    """Pad to the power-of-two pod bucket and run the alignment on `device`.
    Padding rows get group ids 2^30 + i, above every real group, so their
    permutation is the identity. Inputs must be in int32 range."""
    device = resolve_device(device)
    p = len(assignment)
    p_max = _pow2(p)
    # the four padded rows in one buffer: one host-to-device copy
    rows = np.zeros((4, p_max), dtype=np.int32)
    a, g, r, k = rows
    a[:] = -1
    a[:p] = assignment
    g[:] = np.arange(p_max, dtype=np.int32) + np.int32(_INT32_BIG)
    g[:p] = group_id
    r[:p] = rank
    k[:p] = pos_key
    packed = torch.from_numpy(rows).to(device)
    out = rank_align_kernel(*packed.unbind(0))
    return out.cpu().numpy()[:p].astype(assignment.dtype)


def alignment_groups(gang_of_pod: np.ndarray, class_of_pod: np.ndarray,
                     req: np.ndarray, req_nz: np.ndarray) -> np.ndarray:
    """Group ids for rank alignment: members are interchangeable ONLY within
    (gang, class, request vector), the key make_groups solves by, so a
    permutation never moves a pod onto a node that fits another request or
    filter row. Non-members get unique singleton ids 2^29 + i (identity
    permutation)."""
    p = len(gang_of_pod)
    member = np.asarray(gang_of_pod) >= 0
    out = np.empty(p, dtype=np.int32)
    out[~member] = _INT32_BIG // 2 + np.nonzero(~member)[0].astype(np.int32)
    if member.any():
        rows = np.nonzero(member)[0]
        key = np.column_stack([
            np.asarray(gang_of_pod)[rows].astype(np.int64),
            np.asarray(class_of_pod)[rows].astype(np.int64),
            np.asarray(req)[rows].astype(np.int64),
            np.asarray(req_nz)[rows].astype(np.int64)])
        _uniq, inv = np.unique(key, axis=0, return_inverse=True)
        out[rows] = inv.reshape(-1).astype(np.int32)
    return out


# -- adjacency metric ---------------------------------------------------------


def mean_neighbor_distance(group_id: Sequence[int], rank: Sequence[int],
                           slice_of: Sequence[int], pos: Sequence[int],
                           ring_len: Dict[int, int]) -> Optional[float]:
    """Mean ring distance between consecutive-rank placed members: for ranks
    r and r+1 on one slice, the ring hop count min(|dp|, L - |dp|); a
    cross-slice pair pays the worst ring length. None when no gang has two
    placed members."""
    by_group: Dict[int, List[Tuple[int, int, int]]] = {}
    for g, r, s, p in zip(group_id, rank, slice_of, pos):
        if g < 0 or s < 0:
            continue
        by_group.setdefault(int(g), []).append((int(r), int(s), int(p)))
    worst = max(ring_len.values(), default=1)
    dists: List[float] = []
    for members in by_group.values():
        members.sort()
        for (r1, s1, p1), (r2, s2, p2) in zip(members, members[1:]):
            if s1 == s2:
                ln = max(ring_len.get(s1, 1), 1)
                d = abs(p2 - p1)
                dists.append(min(d, ln - d))
            else:
                dists.append(worst)
    if not dists:
        return None
    return float(np.mean(dists))
