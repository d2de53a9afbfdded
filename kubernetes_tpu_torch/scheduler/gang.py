"""Gang scheduling: all-or-nothing PodGroup placement for the batched solver.

The counterpart of `kubernetes_tpu/scheduler/gang.py`. A multi-host training
job is a gang of ranks; placing half of it deadlocks the cluster (the placed
ranks hold capacity waiting for peers that never come). Three pieces, wired
into the existing pipeline:

  directory   GangDirectory mirrors PodGroup objects (min_member quorum) and
              the members already placed (assumed or bound), fed by the
              scheduler's watch ingest and its assume/forget hooks.
  queue gate  SchedulingQueue holds gang members in a staging area until the
              group reaches quorum, then admits the whole gang contiguously
              so ONE solver batch sees it together (scheduler/queue.py).
  batch veto  after the device solve, gangs whose placed count (in batch +
              already placed) misses min_member are stripped BEFORE any
              assume or bind and requeued as a unit with backoff; a gang
              that loses a member at assume time releases every assumed
              sibling (BatchScheduler.schedule_batch).

Topology packing: nodes advertise their TPU slice via LABEL_TPU_SLICE;
gang_slice_bonus computes a per-(class, node) score bonus for the slice that
best fits the gang, so a gang's ranks prefer one interconnect domain.

Everything here is host numpy and pay-for-what-you-use: with no PodGroup
objects the directory is inactive, the tensorizer threads no gang rows and
the solvers run their gang-free variants.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..api import Pod
from ..api.podgroup import LABEL_TPU_SLICE, LABEL_TPU_SLICE_INDEX, pod_gang_rank, pod_group_key
from ..store import DELETED

# Score bonus for nodes on a gang's chosen slice. Sized like one full plugin
# score (MAX_NODE_SCORE): it dominates the least-allocated/balanced deltas
# between near-equal nodes without overriding feasibility or hard plugin
# vetoes (which mask the score entirely). The waterfill sort key budgets for
# it (models/waterfill.py slot guard).
GANG_SLICE_BONUS = 100


class GangDirectory:
    """Authoritative gang state inside the scheduler: PodGroup quorums and the
    members already placed (assumed by us or observed bound). Mutated from
    the scheduling thread (watch ingest, assume) and the bind worker
    (bind-failure forgets) — a small lock keeps the two honest."""

    def __init__(self):
        self._lock = threading.Lock()
        self._min: Dict[str, int] = {}  # group key -> min_member
        self._placed: Dict[str, Set[str]] = {}  # group key -> placed pod keys

    # -- activity gate (the pay-for-what-you-use switch) -----------------------

    @property
    def active(self) -> bool:
        """True once any PodGroup exists; every per-pod gang code path is
        gated on this so gang-free clusters pay one attribute read."""
        return bool(self._min)

    # -- membership ------------------------------------------------------------

    @staticmethod
    def group_of(pod: Pod) -> Optional[str]:
        key = pod_group_key(pod)
        return key or None

    def min_member(self, group: str) -> Optional[int]:
        return self._min.get(group)

    def placed_count(self, group: str) -> int:
        got = self._placed.get(group)
        return len(got) if got else 0

    def quorum_ready(self, group: str, staged_count: int) -> Optional[bool]:
        """Queue-side gate: True admits a staged gang (staged + already-
        placed members reach min_member), False keeps it waiting, None means
        the group has NO PodGroup (deleted, or not created yet) — falsy for
        the wait path, but the queue's staleness sweep uses it to release
        long-stranded members as ordinary pods instead of parking them
        forever."""
        m = self._min.get(group)
        if m is None:
            return None
        return staged_count + self.placed_count(group) >= m

    # -- watch-fed state -------------------------------------------------------

    def observe_podgroup(self, etype: str, pg) -> None:
        with self._lock:
            if etype == DELETED:
                self._min.pop(pg.key, None)
            else:
                self._min[pg.key] = max(1, pg.spec.min_member)

    def observe_pod(self, etype: str, pod: Pod) -> None:
        """Track placed members from the ordinary pod event stream: bound,
        non-terminal members count toward quorum; deletes/terminals free the
        slot. Unlabeled pods return on the first dict lookup."""
        group = pod_group_key(pod)
        if not group:
            return
        with self._lock:
            if etype == DELETED or pod.is_terminal() or not pod.spec.node_name:
                got = self._placed.get(group)
                if got is not None:
                    got.discard(pod.key)
                    if not got:
                        self._placed.pop(group, None)
            else:
                self._placed.setdefault(group, set()).add(pod.key)

    def note_assumed(self, pod: Pod) -> None:
        """An accepted member was assumed by the batch scheduler (our own bind
        confirmations short-circuit the event stream, so assume time is when
        we learn about our own placements)."""
        group = pod_group_key(pod)
        if not group:
            return
        with self._lock:
            self._placed.setdefault(group, set()).add(pod.key)

    def note_forgotten(self, pod: Pod) -> None:
        """Assume rolled back (gang veto at assume, bind failure): the member
        no longer counts toward quorum."""
        group = pod_group_key(pod)
        if not group:
            return
        with self._lock:
            got = self._placed.get(group)
            if got is not None:
                got.discard(pod.key)
                if not got:
                    self._placed.pop(group, None)

    def note_expired_keys(self, keys) -> int:
        """Count expired assumes back OUT of the quorum: the pod keys whose
        assume expired stop counting as placed, so a gang with expired
        assumed members re-evaluates its quorum against reality instead of
        silently under-counting (Scheduler.sweep_expired_assumes calls it
        with the keys the cache expired). Returns how many placed entries
        were removed."""
        removed = 0
        with self._lock:
            for group in list(self._placed):
                got = self._placed[group]
                before = len(got)
                got.difference_update(keys)
                removed += before - len(got)
                if not got:
                    self._placed.pop(group, None)
        return removed

    def quorum_expired_count(self, contains) -> int:
        """How many placed members still counted toward some quorum are no
        longer known to the cache at all. `contains` is Cache.contains;
        called OUTSIDE our lock, stats path only."""
        with self._lock:
            keys = [k for placed in self._placed.values() for k in placed]
        return sum(1 for k in keys if not contains(k))

    def reset(self) -> None:
        """Relist: state is rebuilt from the fresh LIST."""
        with self._lock:
            self._min.clear()
            self._placed.clear()

    # -- batch tensorization ---------------------------------------------------

    def batch_rows(self, pods: Sequence[Pod]
                   ) -> Tuple[Optional[np.ndarray], List[str],
                              Optional[np.ndarray]]:
        """Group-id rows for one solver batch: ([P] int32, -1 = not a gang
        member, else an index into the returned group-key list), plus the
        members' rank rows ([P] int32 from the positional rank label, -1
        absent; None when NO member carries a rank — the rank-alignment
        pass is then skipped). Pods whose group has no PodGroup
        object (deleted between admission and solve) read -1 — without a
        quorum they schedule as ordinary pods. Returns (None, [], None)
        when the batch has no gang members at all."""
        rows = np.full(len(pods), -1, dtype=np.int32)
        ranks = np.full(len(pods), -1, dtype=np.int32)
        any_rank = False
        keys: List[str] = []
        idx: Dict[str, int] = {}
        known = self._min
        for i, pod in enumerate(pods):
            group = pod_group_key(pod)
            if not group or group not in known:
                continue
            gi = idx.get(group)
            if gi is None:
                gi = idx[group] = len(keys)
                keys.append(group)
            rows[i] = gi
            r = pod_gang_rank(pod)
            if r >= 0:
                ranks[i] = r
                any_rank = True
        if not keys:
            return None, [], None
        return rows, keys, (ranks if any_rank else None)


def gang_veto_mask(assignment: np.ndarray, gang_rows: np.ndarray,
                   need: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The all-or-nothing decision for one solved batch (vectorized).

    assignment [K] — node index per pod row, -1 unplaced (the device solve's
    output for the gang's rows); gang_rows [K] — group id per row (-1 none);
    need [G] — members each group still needs placed (min_member minus
    already-placed), from the GangDirectory at veto time.

    Returns (veto [K] bool, satisfied [G] bool): veto marks every row of a
    gang whose in-batch placements miss its need — placed members included,
    so none of them bind; satisfied groups keep their placements (their
    unplaced extras fail individually, without preemption)."""
    g = len(need)
    member = gang_rows >= 0
    placed = member & (assignment >= 0)
    placed_per_group = np.bincount(gang_rows[placed], minlength=g)
    satisfied = placed_per_group >= np.maximum(need, 0)
    veto = member & ~satisfied[np.clip(gang_rows, 0, max(g - 1, 0))]
    return veto, satisfied


def node_slice_ids(cluster) -> Optional[np.ndarray]:
    """[N] int32 slice id per node from LABEL_TPU_SLICE (-1 = unlabeled), or
    None when no node carries the label (non-TPU or single-slice clusters:
    packing is moot). Dictionary-encoded through NodeColumns like every other
    topology key."""
    _vocab, ids = cluster.cols.val_ids(LABEL_TPU_SLICE)
    if (ids < 0).all():
        return None
    return ids


def node_slice_positions(cluster) -> Tuple[Optional[np.ndarray],
                                           Optional[np.ndarray]]:
    """(slice_ids [N], pos [N]) — each node's ICI ring position within its
    slice, for the rank-alignment pass (models/gangcover.py). Positions come
    from LABEL_TPU_SLICE_INDEX when every slice-labeled node carries a
    numeric value; otherwise (mixed or unlabeled) each node's enumeration
    order within its slice — deterministic either way, and exact when nodes
    are listed in ring order. (None, None) when no node has a slice label
    (single-ICI-domain clusters: adjacency is moot)."""
    slice_ids = node_slice_ids(cluster)
    if slice_ids is None:
        return None, None
    n = cluster.n
    vocab, idx_ids = cluster.cols.val_ids(LABEL_TPU_SLICE_INDEX)
    labeled = slice_ids >= 0
    pos = np.full(n, -1, dtype=np.int64)
    parsed = None
    if vocab:
        by_id = {}
        ok = True
        for val, vid in vocab.items():
            try:
                by_id[vid] = int(val)
            except ValueError:
                ok = False
                break
        if ok and bool((idx_ids[labeled] >= 0).all()):
            parsed = np.full(n, -1, dtype=np.int64)
            has = idx_ids >= 0
            parsed[has] = [by_id[v] for v in idx_ids[has].tolist()]
    if parsed is not None:
        pos = np.where(labeled, parsed, -1)
    else:
        # fallback: rank of the node within its slice, in node order
        order = np.argsort(slice_ids[labeled], kind="stable")
        rows = np.nonzero(labeled)[0][order]
        counts: Dict[int, int] = {}
        for i in rows.tolist():
            s = int(slice_ids[i])
            pos[i] = counts.get(s, 0)
            counts[s] = pos[i] + 1
    return slice_ids, pos


def ring_lengths(slice_ids: np.ndarray, pos: np.ndarray) -> Dict[int, int]:
    """Per-slice ICI ring length (max position + 1) — the adjacency
    metric's wrap-around modulus, shared by the scheduler's rank-align
    telemetry, the bench adjacency column, and tests (one definition: a
    position-semantics change lands everywhere at once)."""
    return {int(s): int(pos[slice_ids == s].max()) + 1
            for s in np.unique(slice_ids[slice_ids >= 0]).tolist()}


def gang_slice_bonus(cluster, class_of_pod: np.ndarray, req: np.ndarray,
                     filter_ok: np.ndarray, gang_rows: np.ndarray,
                     n_classes: int) -> Optional[np.ndarray]:
    """Per-(class, node) packing bonus: for each gang, pick the TPU slice that
    best fits the whole gang and award GANG_SLICE_BONUS to its nodes.

    Slice choice is best-fit packing over CURRENT feasible headroom: among
    slices whose member headroom covers the gang's in-batch size, the one
    with the least spare capacity (dense packing leaves big slices whole for
    big gangs); when none covers it, the roomiest slice (partial locality
    still beats scatter). Headroom uses the gang's own request vector against
    alloc-used and the class's static filter row — the same inputs the solver
    sees, so the bonus never points at nodes the gang can't use.

    Classes are gang-exclusive by construction: the gang label is part of
    pod_class_signature, so biasing a class's row never leaks onto non-gang
    pods. Returns [C, N] int32, or None when nodes carry no slice labels."""
    slice_ids = node_slice_ids(cluster)
    if slice_ids is None:
        return None
    n = cluster.n
    n_slices = int(slice_ids.max()) + 1
    alloc = cluster.alloc.astype(np.int64)
    used = cluster.used.astype(np.int64)
    free = np.maximum(alloc - used, 0)
    pod_headroom = np.maximum(
        cluster.max_pods.astype(np.int64) - cluster.pod_count.astype(np.int64), 0)
    bonus = np.zeros((n_classes, n), dtype=np.int32)

    # one representative row per (gang, class) pair present in the batch
    member_rows = np.nonzero(gang_rows >= 0)[0]
    gang_sizes = np.bincount(gang_rows[member_rows])
    seen = set()
    for i in member_rows.tolist():
        ci = int(class_of_pod[i])
        gi = int(gang_rows[i])
        if (gi, ci) in seen:
            continue
        seen.add((gi, ci))
        r = req[i].astype(np.int64)
        nz = r > 0
        if nz.any():
            cap = (free[:, nz] // r[nz]).min(axis=1)
        else:
            cap = np.full(n, 2**31 - 1, dtype=np.int64)
        cap = np.minimum(cap, pod_headroom)
        cap = np.where(filter_ok[ci] & (slice_ids >= 0), cap, 0)
        per_slice = np.bincount(slice_ids[slice_ids >= 0],
                                weights=cap[slice_ids >= 0],
                                minlength=n_slices).astype(np.int64)
        if per_slice.max(initial=0) <= 0:
            continue
        size = int(gang_sizes[gi])
        fits = per_slice >= size
        if fits.any():
            # best fit: least spare among covering slices, lowest id on ties
            spare = np.where(fits, per_slice - size, np.iinfo(np.int64).max)
            best = int(np.argmin(spare))
        else:
            best = int(np.argmax(per_slice))
        bonus[ci, slice_ids == best] = GANG_SLICE_BONUS
    if not seen:
        return None
    return bonus
