"""Slice defragmentation: the fragmentation score and kernel I.

The counterpart of `kubernetes_tpu/models/defrag.py`. The background
rebalancer (scheduler/rebalance.py) hands this module two problems:

  fragmentation score — per resource r with nonzero total free capacity,
      frag_r = 1 - max_slice_free_r / total_free_r: 0 when every free unit
      sits on one slice (a gang admits without eviction), approaching 1 as
      free capacity smears evenly across slices. The cycle score is the max
      over resources, computed on the host (numpy, int64) from the cluster
      tensors alone, as in JAX.

  defrag assignment — given the candidate victims of a donor slice (in
      caller-supplied drain order) and the free/headroom tensors of the
      candidate target nodes, greedily re-place each victim on the
      tightest-fitting eligible node (best-fit: minimize the summed free
      capacity remaining after placement, ties to the lowest node index),
      carrying (free, headroom) from victim to victim. Kernel I,
      `csrc/defrag_assign.cu`; defrag_assign_plain is the same scan in torch
      ops with JAX's int32 semantics, and defrag_assign_host the numpy
      oracle.

defrag_plan pads to the same power-of-two buckets as JAX and takes a
device: "cuda" (the default) launches kernel I for every plan, "cpu" runs
the plain version. Unlike the JAX wrapper it never hands a shape to the
numpy oracle: JAX does above 4,000,000 padded elements
(`_DEFRAG_KERNEL_MAX_ELEMS`) because XLA's scan builds per-step
[n_slots, R] fit masks for all v_max steps; kernel I builds none (one block
keeps the carried state in shared memory, or in a global scratch copy when
it does not fit), so on the card it runs at every size. The targets are the
same. Everything is int32 (bool masks) on the device, as in JAX: quantized
magnitudes (millicores, MiB) keep a node's dimension sum far below 2^31, and
where it is not, the sum wraps as XLA's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.solver import resolve_device
from .gangcover import _pow2

# victims considered per rebalance cycle before the plan budget even
# applies; the rebalancer publishes a candidates_capped stat when it clips —
# never a silent truncation
DEFRAG_MAX_VICTIMS = 1024

_INT32_BIG = 2**30  # "no eligible target" sentinel for the best-fit argmin


# -- fragmentation score ------------------------------------------------------


def slice_fragmentation(free: np.ndarray, slice_of_node: np.ndarray,
                        active: Optional[np.ndarray] = None,
                        ) -> Tuple[float, np.ndarray]:
    """(score, per_slice_free [S, R]) from the cluster free tensor
    (alloc - used, [N, R]) and the per-node slice ids (scheduler/gang.py
    node_slice_ids; -1 = unlabeled, excluded). Score is the max over
    resources with nonzero total free of 1 - max_slice_free / total_free:
    0 on a zero-frag (or single-slice, or fully-packed) cluster.

    active ([R] bool) restricts the score to resources the cluster actually
    CONSUMES (the rebalancer passes used.sum(axis=0) > 0): a dim nothing
    requests has its free capacity spread evenly by construction, and
    scoring it would read a permanent ~1-1/S "fragmentation" no migration
    can change."""
    free = np.maximum(np.asarray(free, dtype=np.int64), 0)
    sl = np.asarray(slice_of_node, dtype=np.int64)
    labeled = sl >= 0
    if not labeled.any():
        return 0.0, np.zeros((0, free.shape[1]), dtype=np.int64)
    s = int(sl[labeled].max()) + 1
    per_slice = np.zeros((s, free.shape[1]), dtype=np.int64)
    np.add.at(per_slice, sl[labeled], free[labeled])
    if s < 2:
        return 0.0, per_slice
    total = per_slice.sum(axis=0)
    nz = total > 0
    if active is not None:
        nz &= np.asarray(active, dtype=bool)
    if not nz.any():
        return 0.0, per_slice
    frag = 1.0 - per_slice[:, nz].max(axis=0) / total[nz]
    return float(frag.max()), per_slice


# -- kernel I: defrag assignment -----------------------------------------------


def defrag_assign_plain(free: torch.Tensor, headroom: torch.Tensor, target_ok: torch.Tensor,
                        v_req: torch.Tensor, v_valid: torch.Tensor) -> torch.Tensor:
    """Target node per victim, -1 = no eligible target (plain version of
    kernel I, the JAX scan as a Python loop over the victims). free
    [n_slots, R] int32, headroom [n_slots] int32, target_ok [n_slots] bool,
    v_req [v_max, R] int32 in drain order, v_valid [v_max] bool (False pads)
    -> [v_max] int32. The inputs are not modified."""
    i32 = torch.int32
    fr = free.clone()
    hd = headroom.clone()
    big = torch.tensor(_INT32_BIG, dtype=i32, device=free.device)
    none = torch.tensor(-1, dtype=i32, device=free.device)
    out = torch.empty(v_req.shape[0], dtype=i32, device=free.device)
    for k in range(v_req.shape[0]):
        vr = v_req[k]
        fits = (fr >= vr[None, :]).all(dim=1) & (hd > 0) & target_ok
        # best-fit key: free capacity REMAINING after placement, summed
        # across dims; the int64 sum cast back wraps like XLA's int32 sum
        waste = (fr - vr[None, :]).sum(dim=1, dtype=torch.int64).to(i32)
        key = torch.where(fits, waste, big)
        tgt = torch.argmin(key)  # the first minimum: lowest index on ties
        place = (key[tgt] < big) & v_valid[k]
        # a victim that stays still has an argmin (index 0): it adds nothing
        fr[tgt] -= vr * place.to(i32)
        hd[tgt] -= place.to(i32)
        out[k] = torch.where(place, tgt.to(i32), none)
    return out


def defrag_assign(free, headroom, target_ok, v_req, v_valid) -> torch.Tensor:
    """Kernel I for CUDA tensors, its plain version for CPU tensors."""
    if free.device.type == "cpu":
        return defrag_assign_plain(free, headroom, target_ok, v_req, v_valid)
    if free.device.type == "cuda":
        from ..ops.kernels import launch_defrag_assign

        return launch_defrag_assign(free, headroom, target_ok, v_req, v_valid)
    raise ValueError(f"defrag_assign: no implementation for device {free.device}")


def defrag_assign_host(free: np.ndarray, headroom: np.ndarray,
                       target_ok: np.ndarray,
                       v_req: np.ndarray) -> np.ndarray:
    """Numpy oracle of defrag_assign (unpadded, int64: it does not wrap).
    Same greedy, same best-fit key, same first-min tie-break."""
    free = np.asarray(free, dtype=np.int64).copy()
    headroom = np.asarray(headroom, dtype=np.int64).copy()
    target_ok = np.asarray(target_ok, dtype=bool)
    v_req = np.asarray(v_req, dtype=np.int64)
    out = np.full(len(v_req), -1, dtype=np.int64)
    for k in range(len(v_req)):
        vr = v_req[k]
        fits = (free >= vr[None, :]).all(axis=1) & (headroom > 0) & target_ok
        if not fits.any():
            continue
        waste = np.sum(free - vr[None, :], axis=1)
        key = np.where(fits, waste, np.int64(_INT32_BIG))
        tgt = int(np.argmin(key))
        out[k] = tgt
        free[tgt] -= vr
        headroom[tgt] -= 1
    return out


def defrag_plan(free: np.ndarray, headroom: np.ndarray, target_ok: np.ndarray,
                v_req: np.ndarray, device="cuda") -> np.ndarray:
    """Pad to the power-of-two buckets (n_slots, v_max) and run the
    assignment on `device`: kernel I on "cuda", the plain version on "cpu".
    Returns the [V] target node index vector as numpy int64 (-1 = stay)."""
    device = resolve_device(device)
    v = len(v_req)
    ns, r = free.shape
    n_slots, v_max = _pow2(ns), _pow2(v)
    if v == 0:
        return np.zeros(0, dtype=np.int64)
    free_p = np.zeros((n_slots, r), dtype=np.int32)
    free_p[:ns] = free
    head_p = np.zeros(n_slots, dtype=np.int32)
    head_p[:ns] = headroom
    ok_p = np.zeros(n_slots, dtype=bool)
    ok_p[:ns] = target_ok
    vr_p = np.zeros((v_max, r), dtype=np.int32)
    vr_p[:v] = v_req
    valid_p = np.zeros(v_max, dtype=bool)
    valid_p[:v] = True

    def t(a):
        return torch.from_numpy(a).to(device)

    out = defrag_assign(t(free_p), t(head_p), t(ok_p), t(vr_p), t(valid_p))
    return out.cpu().numpy()[:v].astype(np.int64)
