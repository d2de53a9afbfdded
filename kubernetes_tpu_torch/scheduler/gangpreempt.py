"""Gang-aware preemption: a batched victim cover that makes room for WHOLE
gangs.

The counterpart of `kubernetes_tpu/scheduler/gangpreempt.py`. Per-pod
preemption is useless to a gang (evicting enough for ONE member strands the
rest, and the victims, for nothing), so this preempts at the gang's own
granularity:

  cover      when a gang's quorum is vetoed by the solver, select a min-cost
             victim set whose release fits the ENTIRE quorum on ONE slice.
             The per-slice eviction capacity curve is kernel G
             (models/gangcover.py cover_curves_batched, every slice of an
             attempt in one launch): caps[k] after evicting the
             first k victims of the slice's (priority asc, biggest-freed
             first) order; the cover is the smallest k reaching the quorum,
             minimized across slices by (max victim priority, victim count,
             priority sum, slice).
  veto       if NO slice reaches the quorum even after every eligible victim,
             NOTHING is evicted: all-or-nothing applied to eviction.
  execute    victims ride DefaultPreemption's execution half
             (scheduler/plugins/default_preemption.py): "Preempted"
             narration and one batched store.delete_pods, on the
             preparation worker when async_preparation is on.
  park/retry the preempting gang PARKS in the queue's parked tier: each
             victim's DELETED event checks it off and the last one releases
             the gang to re-stage at once, or the deadline sweep releases it
             if deletions stall.

Victim eligibility: priority below the gang's MINIMUM member priority, not
itself a gang member, not blocked by an exhausted PodDisruptionBudget, and on
a node the gang's class can use. Everything here runs on the scheduling
thread, off the hot path. A fired cover counts one
scheduler_gang_preempted_total{reason="victim_cover"} (server/metrics.py);
the totals dict (stats()) carries the same counts.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..api import compute_pod_resource_request
from ..api.podgroup import pod_group_key
from ..models.gangcover import COVER_MAX_VICTIMS, cover_curves_batched, victim_order
from ..server import metrics
from ..snapshot.tensorizer import _quantize
from .gang import node_slice_ids


def flatten_snapshot_victims(snapshot, dims):
    """Flatten every bound pod into dense victim arrays in ONE pass over the
    snapshot. Returns (v_node [V] int64, v_prio [V] int64, v_req [V, R]
    int64 quantized requests, v_pods [V], node_victims: per-node victim
    index lists)."""
    n = len(snapshot.node_info_list)
    r = len(dims)
    v_node, v_prio, v_req, v_pods = [], [], [], []
    node_victims: List[List[int]] = [[] for _ in range(n)]
    for i, ni in enumerate(snapshot.node_info_list):
        for pi in ni.pods:
            p = pi.pod
            node_victims[i].append(len(v_pods))
            v_node.append(i)
            v_prio.append(p.spec.priority)
            v_req.append(_quantize(
                compute_pod_resource_request(p), dims, is_request=True))
            v_pods.append(p)
    if not v_pods:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros((0, r), np.int64), [], node_victims)
    return (np.array(v_node, np.int64), np.array(v_prio, np.int64),
            np.array(v_req, np.int64).reshape(len(v_pods), r),
            v_pods, node_victims)


def pdb_blocked_mask(v_pods, pdbs) -> np.ndarray:
    """Approximate PDB exhaustion per victim: True when the victim matches any budget with no disruptions left —
    excluded from the cover outright (a gang cover has no per-node reprieve
    pass to repair an over-evicted budget)."""
    blocked = np.zeros(len(v_pods), dtype=bool)
    if not pdbs:
        return blocked
    for vi, p in enumerate(v_pods):
        blocked[vi] = any(
            pd.metadata.namespace == p.metadata.namespace
            and pd.selector is not None
            and pd.selector.matches(p.metadata.labels)
            and pd.disruptions_allowed <= 0
            for pd in pdbs)
    return blocked


@dataclass
class _Cover:
    """One selected victim cover (or the veto that found none)."""

    slice_id: int = -1
    victims: List = field(default_factory=list)
    chosen: Optional[np.ndarray] = None  # ctx victim indices of `victims`
    cost: int = 0  # victim priority sum
    max_prio: int = 0
    considered: int = 0  # candidate victims examined across slices
    capped: bool = False  # COVER_MAX_VICTIMS truncated some slice's list
    # some slice fits the quorum with ZERO evictions (caps[0] >= need):
    # preemption must not fire at all — the next solve places there (free
    # room may also be a PRIOR cover's in-flight deletions, folded into
    # ctx by consume_cover)
    room_exists: bool = False


class GangPreemptor:
    """Owned by a BatchScheduler; try_preempt is called from the gang
    requeue path for solver-vetoed gangs, note_pod_deleted from the watch
    ingest, sweep from the idle loops. All three run on the scheduling
    thread; the lock covers the stats/waiting reads from sched_stats'
    HTTP handler threads."""

    PARK_TIMEOUT_S = 10.0  # deadline for victim deletions before fallback

    def __init__(self, sched):
        self.sched = sched
        self._lock = threading.Lock()
        # gang key -> outstanding victim keys; the parked-gang release gate
        self._waiting: Dict[str, Set[str]] = {}
        self._deadline: Dict[str, float] = {}
        self.totals = {
            "attempts": 0, "preempted": 0, "victims": 0, "cover_cost": 0,
            "slices_ripped": 0, "vetoed_partial": 0, "released": 0,
            "expired": 0, "victims_capped": 0}

    @property
    def has_waiting(self) -> bool:
        # unlocked truthiness probe: the per-DELETED-event fast-out
        return bool(self._waiting)

    # -- context (built lazily, once per batch with vetoed gangs) -------------

    def build_ctx(self, snapshot, cluster, sub, assignment,
                  need: np.ndarray) -> Dict:
        """Per-batch cover context: post-batch capacity (in-batch placements
        folded in — entries later rolled back at assume read as still
        placed, which only UNDER-counts room: the safe direction), the
        flattened victim arrays, slice ids (one pseudo-slice when the
        cluster carries no slice labels: the whole cluster is then the
        placement domain), and the per-gang residual quorum need."""
        used = cluster.used.astype(np.int64).copy()
        pod_count = cluster.pod_count.astype(np.int64).copy()
        if assignment is not None:
            a = np.asarray(assignment)
            placed = a >= 0
            if placed.any():
                np.add.at(used, a[placed], sub.req[placed])
                np.add.at(pod_count, a[placed], 1)
        slice_ids = node_slice_ids(cluster)
        if slice_ids is None:
            slice_ids = np.zeros(cluster.n, dtype=np.int64)
        v_node, v_prio, v_req, v_pods, _ = flatten_snapshot_victims(
            snapshot, cluster.resource_dims)
        pdbs, _ = self.sched.store.list("poddisruptionbudgets")
        return {
            "snapshot": snapshot, "cluster": cluster, "sub": sub,
            "need": need,
            "free": np.maximum(cluster.alloc.astype(np.int64) - used, 0),
            "headroom": np.maximum(
                cluster.max_pods.astype(np.int64) - pod_count, 0),
            "slice_ids": np.asarray(slice_ids, dtype=np.int64),
            "victims": (v_node, v_prio, v_req, v_pods),
            "pdb_blocked": pdb_blocked_mask(v_pods, pdbs),
        }

    # -- cover selection ------------------------------------------------------

    def _select_cover(self, gid: int, need: int, prio: int,
                      ctx: Dict) -> _Cover:
        cluster = ctx["cluster"]
        sub = ctx["sub"]
        rows = np.nonzero(np.asarray(sub.gang_of_pod) == gid)[0]
        out = _Cover()
        if rows.size == 0:
            return out
        classes = np.unique(np.asarray(sub.class_of_pod)[rows])
        eligible = np.all(sub.tables.filter_ok[classes], axis=0)
        # conservative per-member request: the max over in-batch members
        # (mixed-request gangs are covered for their largest member)
        req = np.asarray(sub.req)[rows].astype(np.int64).max(axis=0)
        nz = req > 0
        v_node, v_prio, v_req, v_pods = ctx["victims"]
        if len(v_pods) == 0:
            return out
        # victim pool: below the gang's priority floor, never a gang member,
        # PDB-allowed, on an eligible node (ineligible capacity is useless)
        pool = ((v_prio < prio) & ~ctx["pdb_blocked"]
                & eligible[v_node])
        if pool.any():
            is_member = np.fromiter(
                (bool(pod_group_key(v_pods[i]))
                 for i in np.nonzero(pool)[0]), dtype=bool,
                count=int(pool.sum()))
            pool_idx = np.nonzero(pool)[0][~is_member]
        else:
            pool_idx = np.zeros(0, dtype=np.int64)
        slice_ids = ctx["slice_ids"]
        free, headroom = ctx["free"], ctx["headroom"]
        # "frees the most" normalization: victim request in units of the
        # gang request (scaled), summed over the gang's nonzero dims
        if nz.any() and pool_idx.size:
            freed_norm_all = (v_req[:, nz] * 1000
                              // np.maximum(req[nz], 1)).sum(axis=1)
        else:
            freed_norm_all = np.zeros(len(v_pods), dtype=np.int64)
        # every eligible slice's victim order first, then all curves of the
        # attempt in one call (one launch of kernel G on the card); the walk
        # below keeps the slice order, the early exit and the counting of a
        # loop that computed one curve at a time
        slices = []
        for s in np.unique(slice_ids[slice_ids >= 0]).tolist():
            snodes = np.nonzero(slice_ids == s)[0]
            if not eligible[snodes].any():
                continue
            local = np.full(cluster.n, -1, dtype=np.int64)
            local[snodes] = np.arange(len(snodes))
            vsel = pool_idx[np.isin(v_node[pool_idx], snodes)]
            order = vsel[victim_order(v_prio[vsel], freed_norm_all[vsel])]
            capped = len(order) > COVER_MAX_VICTIMS
            if capped:
                order = order[:COVER_MAX_VICTIMS]
            slices.append((s, order, capped, (free[snodes], headroom[snodes], eligible[snodes],
                                              local[v_node[order]], v_req[order])))
        curves = cover_curves_batched([x[3] for x in slices], req, device=self.sched.device)
        best: Optional[Tuple] = None
        for (s, order, capped, _), caps in zip(slices, curves):
            if capped:
                out.capped = True
            out.considered += len(order)
            ks = np.nonzero(caps >= need)[0]
            if ks.size == 0:
                continue
            if ks[0] == 0:
                # this slice already fits the quorum with no eviction: the
                # WHOLE attempt aborts — evicting on another slice when
                # free room exists would delete pods for nothing
                out.room_exists = True
                out.victims = []
                return out
            k = int(ks[0])
            chosen = order[:k]
            cand = (int(v_prio[chosen].max()), k, int(v_prio[chosen].sum()),
                    int(s), chosen)
            if best is None or cand[:4] < best[:4]:
                best = cand
        if best is not None:
            out.max_prio, _, out.cost, out.slice_id, chosen = best
            out.chosen = chosen
            out.victims = [v_pods[i] for i in chosen.tolist()]
        return out

    @staticmethod
    def consume_cover(ctx: Dict, cover: _Cover) -> None:
        """Fold a fired cover OUT of the shared per-batch context: the
        chosen victims leave the candidate pool and their room folds into
        free/headroom (their deletion is in flight). A second gang vetoed
        in the SAME batch then reasons against the post-eviction cluster —
        it either finds the freed room (room_exists: no double eviction,
        it places on a later solve) or proves its own DISJOINT cover,
        never double-counting a victim."""
        v_node, v_prio, v_req, v_pods = ctx["victims"]
        chosen = cover.chosen
        np.add.at(ctx["free"], v_node[chosen], v_req[chosen])
        np.add.at(ctx["headroom"], v_node[chosen], 1)
        keep = np.ones(len(v_pods), dtype=bool)
        keep[chosen] = False
        rows = np.nonzero(keep)[0]
        ctx["victims"] = (v_node[rows], v_prio[rows], v_req[rows],
                          [v_pods[i] for i in rows.tolist()])
        ctx["pdb_blocked"] = ctx["pdb_blocked"][rows]

    # -- entry point from the gang requeue path -------------------------------

    def try_preempt(self, gang_key: str, gid: int, members: List,
                    ctx: Dict) -> Optional[Dict]:
        """Attempt a victim cover for one solver-vetoed gang. Returns None
        when preemption does not apply (policy Never, no plugin, no
        candidates at all — the gang requeues normally, silently), a dict
        with "vetoed": True when candidates existed but NO single slice can
        be covered (narrated; zero evictions; normal requeue), or the cover
        stats dict after firing the eviction and PARKING the gang."""
        sched = self.sched
        need = int(ctx["need"][gid]) if gid < len(ctx["need"]) else 0
        if need <= 0 or gang_key in self._waiting:
            return None
        if any(m.pod.spec.preemption_policy == "Never" for m in members):
            return None
        fw = sched._fw(members[0].pod) or sched.framework
        plugin = sched._preemption_plugin(fw)
        if plugin is None:
            return None
        prio = min(m.pod.spec.priority for m in members)
        with self._lock:
            self.totals["attempts"] += 1
        cover = self._select_cover(gid, need, prio, ctx)
        if cover.capped:
            with self._lock:
                self.totals["victims_capped"] += 1
        if cover.room_exists:
            # free room (possibly a prior cover's in-flight deletions)
            # already fits the quorum: no eviction, no veto — the gang
            # requeues and places on a later solve
            return None
        if not cover.victims:
            if cover.considered == 0:
                return None  # nothing evictable: a plain capacity wait
            with self._lock:
                self.totals["vetoed_partial"] += 1
            sched.recorder.event(
                members[0].pod, "Warning", "GangPreemptionVetoed",
                f"gang {gang_key}: no victim set on any single slice frees "
                f"room for all {need} member(s) "
                f"({cover.considered} candidate victim(s) examined); "
                "partial eviction refused")
            return {"vetoed": True, "considered": cover.considered}
        k = len(cover.victims)
        slice_name = str(cover.slice_id)
        sched.recorder.event(
            members[0].pod, "Normal", "GangPreempting",
            f"gang {gang_key}: evicting {k} victim(s) on slice "
            f"{slice_name} (cover cost {cover.cost}) to fit all {need} "
            "member(s); gang parked awaiting victim termination")
        # the DefaultPreemption execution machinery: narration + batched
        # store.delete_pods, on the preparation worker in async mode
        preemptor = f"gang/{gang_key}"
        node_label = f"slice {slice_name}"
        if plugin.async_preparation:
            plugin._ensure_prep_worker()
            plugin._prep_q.put((list(cover.victims), preemptor, node_label))
        else:
            plugin._narrate_victims(cover.victims, preemptor, node_label)
            plugin._delete_victims(cover.victims)
        with self._lock:
            self._waiting[gang_key] = {v.key for v in cover.victims}
            self._deadline[gang_key] = (sched.clock.now()
                                        + self.PARK_TIMEOUT_S)
            self.totals["preempted"] += 1
            self.totals["victims"] += k
            self.totals["cover_cost"] += cover.cost
            self.totals["slices_ripped"] += 1
        sched.queue.park_gang(gang_key, members)
        sched.preempt_victims_total += k
        metrics.gang_preempted_total.inc(reason="victim_cover")
        # later gangs vetoed in this SAME batch must reason against the
        # post-eviction pool/room, never double-count these victims
        self.consume_cover(ctx, cover)
        return {"victims": k, "slice": cover.slice_id, "cost": cover.cost,
                "considered": cover.considered}

    # -- release plumbing -----------------------------------------------------

    def note_pod_deleted(self, key: str) -> None:
        """A pod DELETED event reached the watch ingest: check it off every
        waiting cover; the gang whose last victim terminated releases to
        re-stage immediately. Callers fast-out on has_waiting, so the
        unlabeled 100% of deletes never takes the lock."""
        releases = []
        with self._lock:
            # every waiting cover that names this key (no early break:
            # distinct covers are disjoint by construction, but a release
            # must never depend on that invariant)
            for g, wait in self._waiting.items():
                if key in wait:
                    wait.discard(key)
                    if not wait:
                        releases.append(g)
        for g in releases:
            self._release(g, "released")

    def sweep(self, now: float) -> int:
        """Deadline fallback, run from the idle loops: a cover whose victim
        deletions stalled (wedged kubelet, chaos fault) releases its gang
        anyway — back to the normal retry ladder, never stranded parked."""
        with self._lock:
            expired = [g for g, d in self._deadline.items() if now >= d]
        for g in expired:
            self._release(g, "expired")
        return len(expired)

    def _release(self, gang_key: str, counter: str) -> None:
        with self._lock:
            self._waiting.pop(gang_key, None)
            self._deadline.pop(gang_key, None)
            self.totals[counter] += 1
        self.sched.queue.release_parked_gang(gang_key)

    def reset(self) -> None:
        """Crash resync: parked state was rebuilt from the store LIST (the
        queue re-admits every pending pod fresh), so in-flight cover
        tracking is meaningless — drop it."""
        with self._lock:
            self._waiting.clear()
            self._deadline.clear()

    def stats(self) -> Dict:
        with self._lock:
            out = dict(self.totals)
            out["waiting_gangs"] = len(self._waiting)
        return out
