"""Global rebalancer & slice defragmenter.

The counterpart of `kubernetes_tpu/scheduler/rebalance.py`, whole.
Placement is one-shot greedy per batch: once a pod binds, nothing revisits
the decision, and fragmentation accretes until arriving gangs can only be
admitted by destroying work through preemption (scheduler/gangpreempt.py).
The Rebalancer is the background optimizer on top: it periodically
snapshots the cluster through the scheduler's tensorizer, scores per-slice
fragmentation on the host from the cluster tensors (models/defrag.py), and
when the score crosses the threshold re-solves the movable remainder of one
donor slice as ONE batched problem on the scheduler's device: kernel I on
the card, its plain version on the CPU, at every size. The current->target
delta compiles into a BOUNDED migration plan executed as
priority-ascending, PDB-respecting waves:

  * per-wave and per-cycle migration budgets are HARD caps — a rebalance
    never thunders; candidates beyond the cycle budget wait for the next
    cycle (budget_clamped stat, never a silent truncation);
  * each wave creates the pre-bound replacement pods FIRST
    (store.create_many) and only then evicts the originals with the batched
    store.delete_pods — a kill between the two leaves a transient
    duplicate, never a lost or double-bound pod;
  * an abort path runs before every wave: the caller-supplied slo_probe
    returning False stops the cycle with the remaining waves unexecuted
    (slo_aborts stat);
  * the `rebalance.cycle` FaultInject site fires at cycle start, at every
    wave boundary and MID-WAVE (key="midwave", between replacement create
    and victim delete); an injected fault mid-wave rolls the wave's
    replacements back before aborting, a hard kill is the conservation
    chaos case above.

Only pods that are trivially re-placeable migrate: bound, non-gang,
priority below the ceiling, no affinity / node selector / topology spread
/ host ports, and not PDB-exhausted (gangpreempt.pdb_blocked_mask). Gang
members never move — their placement is rank-aligned to the ICI ring
(models/gangcover.py) and a single-member move would break the alignment
the gang paid preemption for.

Exactly ONE rebalancer may run against a store: a second instance would
silently double-count the migration budget, so claims go through a
module-level weak registry and losers count inert_conflict no-ops. The
rebalancer is also inert on a SHARD pipeline of a partitioned scheduler
(partition_index >= 0, scheduler/partition.py): a shard's view is partial.
Only the residual full-view pipeline (partition_index == -1) or a
standalone scheduler (None) migrates.

_candidates reads the store's columnar pod view (store.pod_columns()) to
find the donor slice's rows without copying the whole cluster, then gets
only those pods; on a dict store (APIStore(columnar=False)) it lists the
pods, which gives the same candidates in the same order (both sort by key
before the cap).
"""

from __future__ import annotations

import re
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..api.resources import compute_pod_resource_request
from ..api.types import new_uid
from ..chaos import faultinject
from ..obs import tracebuf as _tracebuf
from ..chaos.faultinject import FaultInjected
from ..models.defrag import (DEFRAG_MAX_VICTIMS, defrag_plan,
                             slice_fragmentation)
from ..snapshot.tensorizer import _quantize
from ..store.store import pod_structural_clone
from .gang import node_slice_ids

# one rebalancer per store: store -> weakref(owning
# Rebalancer). Weak on BOTH sides — the registry must neither keep a dead
# store alive nor keep a rebalancer alive through its own claim.
_OWNERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_OWNERS_LOCK = threading.Lock()

_MG_RE = re.compile(r"-mg\d+$")


def _mg_name(name: str, seq: int) -> str:
    """Replacement pod name: strip any prior migration suffix first, so a
    pod migrated twice is web-0-mg7, not web-0-mg3-mg7 (names stay bounded
    however often the rebalancer touches a pod)."""
    return f"{_MG_RE.sub('', name)}-mg{seq}"


class Rebalancer:
    """Background whole-cluster re-solve with bounded migration waves.

    Construct against a (Batch)Scheduler and drive cycles explicitly
    (cycle()) or through the pacing wrapper (maybe_cycle(), wired into
    run_until_idle's quiesce path when attached via
    scheduler.enable_rebalancer()). Thread-safe: one cycle at a time, stats
    under their own lock (GangPreemptor convention)."""

    def __init__(self, sched, *, frag_threshold: float = 0.25,
                 budget_per_wave: int = 8, budget_per_cycle: int = 32,
                 priority_ceiling: int = 100, min_interval_s: float = 0.0,
                 slo_probe: Optional[Callable[[], bool]] = None):
        if budget_per_wave <= 0 or budget_per_cycle <= 0:
            raise ValueError("migration budgets must be positive")
        self.sched = sched
        self.frag_threshold = float(frag_threshold)
        self.budget_per_wave = int(budget_per_wave)
        self.budget_per_cycle = int(budget_per_cycle)
        self.priority_ceiling = int(priority_ceiling)
        self.min_interval_s = float(min_interval_s)
        self.slo_probe = slo_probe
        # single-flight guard for cycle(): a FLAG, not a lock held across
        # the body — the body may sleep (fault delay plans) and launches
        # kernel I, neither of which belongs under a lock
        self._cycle_active = False
        self._lock = threading.Lock()
        self._last_cycle_ts = float("-inf")
        self._seq = 0
        # victim key -> replacement key, recorded only after the victim's
        # delete committed; resolve_keys follows chains for conservation
        self._moves: Dict[str, str] = {}
        # which route the last _candidates took: "columnar" (the store's
        # pod view) or "list" (a dict store); None before the first plan
        self.candidates_route: Optional[str] = None
        self._totals: Dict[str, float] = {
            "cycles": 0, "noop_cycles": 0, "plans": 0, "migrations": 0,
            "waves": 0, "slo_aborts": 0, "fault_aborts": 0,
            "budget_clamped": 0, "candidates_capped": 0,
            "inert_partition": 0, "inert_conflict": 0,
            "last_frag": 0.0, "last_migrations": 0,
        }

    # -- observability ---------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)

    def reset(self) -> None:
        with self._lock:
            for k in self._totals:
                self._totals[k] = 0

    def resolve_keys(self, keys) -> List[str]:
        """Map submitted pod keys through the migration chain to the key of
        the pod that carries that workload NOW — the conservation-report
        input after a run that migrated some of the submitted pods."""
        with self._lock:
            moves = dict(self._moves)
        out = []
        for k in keys:
            seen = set()
            while k in moves and k not in seen:
                seen.add(k)
                k = moves[k]
            out.append(k)
        return out

    # -- ownership ---------------------------------------------------------------

    def _claim_store(self) -> bool:
        store = self.sched.store
        with _OWNERS_LOCK:
            ref = _OWNERS.get(store)
            cur = ref() if ref is not None else None
            if cur is None or cur is self:
                _OWNERS[store] = weakref.ref(self)
                return True
            return False

    def release(self) -> None:
        """Drop the store claim so another rebalancer may take over (tests,
        scheduler teardown)."""
        store = self.sched.store
        with _OWNERS_LOCK:
            ref = _OWNERS.get(store)
            if ref is not None and ref() is self:
                del _OWNERS[store]

    # -- driving ---------------------------------------------------------------

    def maybe_cycle(self) -> Optional[dict]:
        """cycle() if at least min_interval_s has passed since the last run
        (None otherwise) — the pacing entry run_until_idle's quiesce path
        calls; a zero interval rebalances on every quiesce."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_cycle_ts < self.min_interval_s:
                return None
            self._last_cycle_ts = now
        return self.cycle()

    def cycle(self) -> dict:
        """One rebalance cycle. Returns a summary dict; mutates nothing when
        inert (wrong partition, lost store claim, a cycle already in
        flight) or when fragmentation is below threshold (the
        allocation-free steady-state no-op)."""
        with self._lock:
            if self._cycle_active:
                return {"ran": False, "reason": "busy"}
            self._cycle_active = True
        res = None
        t0 = time.perf_counter()
        try:
            res = self._cycle_inner()
            return res
        finally:
            t1 = time.perf_counter()
            # trace timeline: one slice per cycle (the steady-state no-op
            # included — its near-zero width IS the "rebalance costs
            # nothing when defragmented" evidence)
            if _tracebuf.ACTIVE is not None:
                _tracebuf.ACTIVE.note_span(
                    "rebalance", "cycle", t0, t1, cat="rebalance",
                    args=dict(res) if isinstance(res, dict) else None)
            with self._lock:
                self._cycle_active = False

    def _cycle_inner(self) -> dict:
        t = self._totals
        pi = getattr(self.sched, "partition_index", None)
        if pi is not None and pi >= 0:
            # shard pipeline of a PartitionedScheduler: a shard's cluster
            # view is partial — migrating on it would fight the residual
            with self._lock:
                t["inert_partition"] += 1
            return {"ran": False, "reason": "partition"}
        if not self._claim_store():
            with self._lock:
                t["inert_conflict"] += 1
            return {"ran": False, "reason": "conflict"}
        with self._lock:
            t["cycles"] += 1
        try:
            if faultinject.ACTIVE is not None:
                faultinject.ACTIVE.fire("rebalance.cycle", key="cycle")
        except FaultInjected:
            with self._lock:
                t["fault_aborts"] += 1
            return {"ran": False, "reason": "fault"}

        sched = self.sched
        snapshot = sched.cache.update_snapshot()
        cluster, _ = sched._tensor_cache.cluster_tensors(snapshot)
        slice_ids = node_slice_ids(cluster)
        if slice_ids is None or cluster.n == 0:
            with self._lock:
                t["noop_cycles"] += 1
                t["last_frag"] = 0.0
                t["last_migrations"] = 0
            return {"ran": True, "frag": 0.0, "migrations": 0, "waves": 0}
        used = cluster.used.astype(np.int64)
        free = cluster.alloc.astype(np.int64) - used
        # only resources the cluster consumes can fragment (an unrequested
        # dim's free capacity is evenly spread by construction)
        active = used.sum(axis=0) > 0
        score, per_slice = slice_fragmentation(free, slice_ids, active)
        if score < self.frag_threshold:
            # steady state: tensors + the frag score alone — no pod
            # listing, no plan, no kernel launch
            with self._lock:
                t["noop_cycles"] += 1
                t["last_frag"] = score
                t["last_migrations"] = 0
            return {"ran": True, "frag": score, "migrations": 0, "waves": 0}

        # donor slice: in the most fragmented resource dim, the slice
        # holding the most free capacity — the cheapest to finish draining
        # into the rest (consolidation empties IT, the others fill)
        total = per_slice.sum(axis=0)
        nz = (total > 0) & active
        frag_dims = np.zeros(per_slice.shape[1])
        frag_dims[nz] = 1.0 - per_slice[:, nz].max(axis=0) / total[nz]
        dim = int(np.argmax(frag_dims))
        donor = int(np.argmax(per_slice[:, dim]))

        cands, capped = self._candidates(cluster, slice_ids, donor)
        clamped = len(cands) > self.budget_per_cycle
        cands = cands[:self.budget_per_cycle]
        with self._lock:
            t["last_frag"] = score
            if capped:
                t["candidates_capped"] += 1
            if clamped:
                t["budget_clamped"] += 1
        if not cands:
            with self._lock:
                t["noop_cycles"] += 1
                t["last_migrations"] = 0
            return {"ran": True, "frag": score, "migrations": 0, "waves": 0}

        dims = cluster.resource_dims
        v_req = np.array(
            [_quantize(compute_pod_resource_request(p), dims,
                       is_request=True) for p in cands],
            dtype=np.int64).reshape(len(cands), len(dims))
        headroom = (cluster.max_pods.astype(np.int64)
                    - cluster.pod_count.astype(np.int64))
        target_ok = (slice_ids >= 0) & (slice_ids != donor)
        targets = defrag_plan(np.maximum(free, 0), headroom, target_ok, v_req,
                              device=sched.device)
        migs: List[Tuple[object, str]] = [
            (p, cluster.node_names[int(ti)])
            for p, ti in zip(cands, targets) if ti >= 0]
        with self._lock:
            t["plans"] += 1
            t["last_migrations"] = len(migs)
        if not migs:
            return {"ran": True, "frag": score, "migrations": 0, "waves": 0}
        moved, waves, aborted = self._execute(migs)
        with self._lock:
            t["migrations"] += moved
            t["waves"] += waves
        return {"ran": True, "frag": score, "migrations": moved,
                "waves": waves, "aborted": aborted}

    # -- candidate selection ---------------------------------------------------

    def _candidates(self, cluster, slice_ids, donor) -> Tuple[list, bool]:
        """Movable pods on the donor slice, priority-ascending (ties by key
        for determinism), PDB-screened. Uses the store's columnar view where
        it has one, to find rows without materializing the whole cluster;
        else store.list, which gives the same order. Returns (pods,
        capped)."""
        store = self.sched.store
        donor_nodes = {cluster.node_names[i] for i in range(cluster.n)
                       if slice_ids[i] == donor}
        raw = []
        view = (store.pod_columns()
                if hasattr(store, "pod_columns") else None)
        self.candidates_route = "list" if view is None else "columnar"
        if view is not None:
            for row in range(view.n):
                key = view.keys[row]
                if key is None or view.node_id[row] < 0:
                    continue
                if view.gang[row] or view.priority[row] >= self.priority_ceiling:
                    continue
                if view.node_names[view.node_id[row]] not in donor_nodes:
                    continue
                raw.append(key)
            raw.sort()
            pods = []
            for key in raw:
                try:
                    p = store.get("pods", key)
                except KeyError:
                    continue
                if self._movable(p):
                    pods.append(p)
        else:
            items, _rv = store.list("pods")
            pods = [p for p in items
                    if p.spec.node_name in donor_nodes
                    and (p.spec.priority or 0) < self.priority_ceiling
                    and self._movable(p)]
            pods.sort(key=lambda p: p.key)
        capped = len(pods) > DEFRAG_MAX_VICTIMS
        pods = pods[:DEFRAG_MAX_VICTIMS]
        pdbs, _rv = store.list("poddisruptionbudgets")
        if pdbs:
            from .gangpreempt import pdb_blocked_mask

            blocked = pdb_blocked_mask(pods, pdbs)
            pods = [p for p, b in zip(pods, blocked) if not b]
        pods.sort(key=lambda p: ((p.spec.priority or 0), p.key))
        return pods, capped

    def _movable(self, p) -> bool:
        """Trivially re-placeable: bound, non-terminal, non-gang, and free
        of every placement constraint the defrag kernel does not model."""
        from ..api.podgroup import pod_group_key

        s = p.spec
        if not s.node_name or p.is_terminal():
            return False
        if pod_group_key(p):
            return False
        if s.affinity is not None or getattr(s, "node_selector", None):
            return False
        if getattr(s, "topology_spread_constraints", None):
            return False
        for c in (s.containers or ()):
            if getattr(c, "ports", None):
                return False
        return True

    # -- migration waves -------------------------------------------------------

    def _execute(self, migs) -> Tuple[int, int, bool]:
        """Run the plan in waves of budget_per_wave. Returns (migrated,
        waves, aborted). Create-before-delete per wave: a crash between the
        two leaves a duplicate (replacement + original both bound), never a
        lost pod; an INJECTED mid-wave fault additionally rolls the wave's
        replacements back before aborting."""
        store = self.sched.store
        t = self._totals
        moved = 0
        waves = 0
        for wi in range(0, len(migs), self.budget_per_wave):
            wave = migs[wi:wi + self.budget_per_wave]
            # trace timeline: one instant per wave boundary
            if _tracebuf.ACTIVE is not None:
                _tracebuf.ACTIVE.instant(
                    "rebalance", "wave-%d" % (wi // self.budget_per_wave),
                    cat="rebalance", args={"migrations": len(wave)})
            try:
                if faultinject.ACTIVE is not None:
                    faultinject.ACTIVE.fire(
                        "rebalance.cycle",
                        key=f"wave-{wi // self.budget_per_wave}")
            except FaultInjected:
                with self._lock:
                    t["fault_aborts"] += 1
                return moved, waves, True
            if self.slo_probe is not None and not self.slo_probe():
                with self._lock:
                    t["slo_aborts"] += 1
                return moved, waves, True
            reps, vkeys = [], []
            for victim, target in wave:
                with self._lock:
                    self._seq += 1
                    seq = self._seq
                rep = pod_structural_clone(victim)
                rep.metadata.name = _mg_name(victim.metadata.name, seq)
                rep.metadata.uid = new_uid()
                rep.metadata.resource_version = 0
                rep.spec.node_name = target
                # Pod.key's contract is "every rename parses a NEW Pod" —
                # this is the one rename-in-place in tree, so the clone's
                # inherited key memo MUST go (a stale key would make the
                # cache file the replacement under the victim's key and the
                # victim's DELETE would then evict both). The sig memos
                # anchor to the victim's old spec and would never validate;
                # _req_cache is still correct (requests are unchanged) and
                # deliberately kept.
                rep.__dict__.pop("_key_cache", None)
                rep.__dict__.pop("_class_sig", None)
                rep.__dict__.pop("_req_sig", None)
                reps.append(rep)
                vkeys.append(victim.key)
            _created, cerrs = store.create_many("pods", reps,
                                               origin="rebalance")
            failed = {k for k, _m in cerrs}
            rep_keys = [r.key for r in reps]
            live = [(vk, rk) for vk, rk in zip(vkeys, rep_keys)
                    if rk not in failed]
            try:
                if faultinject.ACTIVE is not None:
                    faultinject.ACTIVE.fire("rebalance.cycle", key="midwave")
            except FaultInjected:
                # roll the wave back: evicting nothing beats leaving both
                # copies bound; the originals were never touched
                store.delete_pods([rk for _vk, rk in live],
                                  origin="rebalance")
                with self._lock:
                    t["fault_aborts"] += 1
                return moved, waves, True
            _n, derrs = store.delete_pods([vk for vk, _rk in live],
                                          origin="rebalance")
            dfailed = {k for k, _m in derrs}
            with self._lock:
                for vk, rk in live:
                    if vk not in dfailed:
                        self._moves[vk] = rk
                        moved += 1
            waves += 1
        return moved, waves, False
