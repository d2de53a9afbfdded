"""Partitioned scheduler: N solve pipelines over disjoint node shards.

The counterpart of `kubernetes_tpu/scheduler/partition.py`. N
`BatchScheduler` pipelines each own a DISJOINT node shard (hash or zone
partition of the node set) against the ONE shared store, pulling from a
partition-aware dispatch layer:

  routing    Pending pods route by feasibility fingerprint — a cheap spec
             probe (spans_partitions): constraint-spanning pods (inter-pod
             affinity classes, gangs, topology-spread groups) are judged
             against the WHOLE cluster by definition, so they go straight
             to the global residual pass (a shard-limited pipeline could
             ACCEPT a placement that violates a required constraint whose
             witnesses live on another shard — only declines are
             recoverable); with the residual disabled they PIN to the
             designated partition instead (best-effort shard-local
             semantics). Everything else hashes over the live partitions.
             Bound pods route by their node's shard, so each pipeline's
             cache accounts exactly its own nodes — while gang-quorum
             accounting stays cluster-scoped (foreign-shard members still
             feed every pipeline's GangDirectory).

  pipelines  Each pipeline runs its own ingest→tensorize→solve→assume→bind
             stages on its own thread, with its own cache, tensor cache and
             device mirrors (kernel B), flight recorder, breaker and bind
             worker — one partition's GIL-held host work overlaps another's
             GIL-free kernel launches and device waits. Every pipeline
             launches on torch's current stream of its thread, the one
             default stream, so the pipelines' kernels serialize on the card
             and each one's pinned staging and caching-allocator scratch stay
             ordered on that stream.

  re-route   A pod UNSCHEDULABLE in one shard is not unschedulable in the
             cluster: the reroute hook hands it to the next partition's
             active queue (hop-bounded), and when every shard has declined
             — or the pod spans partitions and the pinned shard declined —
             it falls through to the GLOBAL RESIDUAL PASS: a full-view
             pipeline rebuilt from a consistent LIST that runs between
             partition rounds (propose per partition, repair the global
             constraints after).

  conflicts  Cross-partition races are absorbed OPTIMISTICALLY: pipelines
             assume into their private caches without coordination, and the
             store's bind_many is the arbiter — a per-pod "already bound"
             error is a FACT, not a fault (store.is_bind_conflict). The
             losing pipeline forgets its assume and drops the pod; the
             winner's commit is the pod's one true binding. Exactly-once
             binding therefore needs no cross-partition locking at all.

  failure    A partition is a failure domain: a hard-killed pipeline
             (chaos site `partition.dispatch`, or any FaultKill escaping
             its drive loop) is absorbed by the survivors — the router
             remaps the dead shard's slots, and each survivor
             resync_from_store()s under the new routing, re-adopting the
             dead partition's nodes and pods. Any of the dead pipeline's
             in-flight binds that still land are reconciled through the
             same conflict machinery.

LOCK DISCIPLINE: the dispatch-layer locks — `PartitionRouter._route_lock`
and `PartitionedScheduler._dispatch_lock` — are LEAF locks, ordered strictly
AFTER the store's `_lock` → `_pods_lock` → `_nodes_lock` chain: code holding
either may touch only the router/coordinator's own bookkeeping, NEVER call
into the store, a cache, a queue or a kernel. (Routing happens at ingest,
where no store lock is held; a store call under a dispatch lock would
invert against every pipeline's commit path.)

`partitions=1` is byte-identical to a standalone BatchScheduler: no gates,
no hooks, no residual — pure delegation.

Background mode (JAX partition.py :734-778): start() starts every live
pipeline's BatchScheduler.start() loop and a supervisor thread that, every
0.5 s, absorbs a pipeline whose loop thread died (the survivors stopped
around the absorb so their resync does not race their own loops, then
restarted) and runs the residual pass over the parked pods; stop() ends the
supervisor, then every member.
"""

from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import Pod
from ..api.podgroup import pod_group_key
from ..chaos import faultinject as _chaos
from ..chaos.faultinject import FaultInjected, FaultKill
from ..ops.kernels import launch_scope
from ..store import APIStore
from .batch import BatchScheduler
from .queue import QueuedPodInfo

LABEL_ZONE = "topology.kubernetes.io/zone"


def _crc(name: str) -> int:
    return zlib.crc32(name.encode("utf-8", "surrogatepass"))


def spans_partitions(pod: Pod) -> bool:
    """The feasibility fingerprint's constraint probe: does placing this pod
    correctly require visibility beyond one node shard? Inter-pod
    (anti-)affinity counts other pods wherever they run, topology spread
    balances across ALL domains, and a gang's all-or-nothing quorum must be
    solved by ONE pipeline. Node-local predicates (node selector/affinity,
    taints, resources, ports, volumes) shard cleanly and return False."""
    spec = pod.spec
    if spec.topology_spread_constraints:
        return True
    a = spec.affinity
    if a is not None and (a.pod_affinity_required or a.pod_affinity_preferred
                          or a.pod_anti_affinity_required
                          or a.pod_anti_affinity_preferred):
        return True
    return bool(pod_group_key(pod))


class PartitionRouter:
    """Shared routing state of the dispatch layer. Thread-safe; every method
    is pure bookkeeping under the LEAF `_route_lock` (see the module
    docstring's lock discipline — no store/cache/queue call is ever made
    while it is held)."""

    def __init__(self, partitions: int, partition_by: str = "hash"):
        if partitions < 1:
            raise ValueError("partitions must be >= 1")
        if partition_by not in ("hash", "zone"):
            raise ValueError(f"unknown partition_by {partition_by!r} "
                             "(want 'hash' or 'zone')")
        self.n = partitions
        self.partition_by = partition_by
        # the dispatch/routing lock — LEAF (module docstring): nothing
        # store/cache/queue-shaped may be called while held
        self._route_lock = threading.Lock()
        # slot -> owning partition index; identity until a partition dies,
        # then the dead partition's slots remap round-robin over survivors
        self._slot_owner: List[int] = list(range(partitions))
        self._alive: List[bool] = [True] * partitions
        # zone mode: node/zone name -> slot, learned from node objects at
        # sync (and node events later); unknown names hash-fallback so a
        # node arriving before its zone is known still routes somewhere
        self._zone_slot: Dict[str, int] = {}
        self._node_slot: Dict[str, int] = {}
        self._next_zone_slot = 0
        # pod key -> (partition, hops): advisory re-route overrides. Safe to
        # lose or clear at any time — double-routing is absorbed by the bind
        # conflict machinery — so this map is pruned aggressively (cleared
        # at coordinator idle) instead of tracked precisely.
        self._overrides: Dict[str, Tuple[int, int]] = {}

    # -- nodes -----------------------------------------------------------------

    def observe_node(self, node) -> int:
        """Learn (zone mode) and return the owning partition of a Node
        OBJECT — the pipelines' node filters call this for every node event
        and LIST row, so the name->slot memo is populated before any bound
        pod on that node needs routing by name."""
        name = node.metadata.name
        if self.partition_by == "zone":
            zone = (node.metadata.labels or {}).get(LABEL_ZONE, "")
            with self._route_lock:
                if zone:
                    slot = self._zone_slot.get(zone)
                    if slot is None:
                        # round-robin assignment in discovery order keeps few
                        # zones balanced (a pure hash could collide all onto
                        # one slot)
                        slot = self._next_zone_slot % self.n
                        self._next_zone_slot += 1
                        self._zone_slot[zone] = slot
                else:
                    slot = _crc(name) % self.n
                self._node_slot[name] = slot
                return self._slot_owner[slot]
        with self._route_lock:
            return self._slot_owner[_crc(name) % self.n]

    def partition_of_node_name(self, name: str) -> int:
        with self._route_lock:
            slot = self._node_slot.get(name)
            if slot is None:
                slot = _crc(name) % self.n
            return self._slot_owner[slot]

    # -- pods ------------------------------------------------------------------

    def partition_of_pod(self, pod: Pod) -> int:
        """The dispatch decision for a PENDING pod: re-route override if one
        is active, else the pinned partition for constraint-spanning pods,
        else the feasibility-fingerprint hash over the slots."""
        key = pod.key
        spanning = spans_partitions(pod)
        with self._route_lock:
            ov = self._overrides.get(key)
            if ov is not None:
                return ov[0]
            if spanning:
                return self._slot_owner[0]  # the designated partition
            return self._slot_owner[_crc(key) % self.n]

    def next_hop(self, pod: Pod, frm: int) -> Optional[int]:
        """One re-route decision: the next live partition for a pod that
        partition `frm` declined, or None when the routing is exhausted (or
        the pod spans partitions — no other shard-limited pipeline can do
        better) and the pod must fall through to the global residual pass.
        Hop-bounded at the live-partition count so re-routing can never
        livelock."""
        if spans_partitions(pod):
            return None
        key = pod.key
        with self._route_lock:
            alive = [i for i, ok in enumerate(self._alive) if ok]
            if len(alive) <= 1:
                self._overrides.pop(key, None)
                return None
            hops = self._overrides.get(key, (frm, 0))[1] + 1
            if hops >= len(alive):
                self._overrides.pop(key, None)
                return None
            pos = alive.index(frm) if frm in alive else 0
            target = alive[(pos + 1) % len(alive)]
            self._overrides[key] = (target, hops)
            return target

    def designated(self) -> int:
        """The live owner of slot 0 — the partition whose gate parks
        spanning pods for the residual pass (exactly one parker), and the
        pin target when the residual is disabled."""
        with self._route_lock:
            return self._slot_owner[0]

    def forget(self, key: str) -> None:
        with self._route_lock:
            self._overrides.pop(key, None)

    def clear_overrides(self) -> None:
        with self._route_lock:
            self._overrides.clear()

    def override_count(self) -> int:
        with self._route_lock:
            return len(self._overrides)

    # -- partition lifecycle ---------------------------------------------------

    def live_partitions(self) -> List[int]:
        with self._route_lock:
            return [i for i, ok in enumerate(self._alive) if ok]

    def absorb(self, dead: int) -> List[int]:
        """Mark a partition dead and remap its slots round-robin over the
        survivors. Returns the survivor indices (callers resync them under
        the new routing). Overrides pointing at the corpse are dropped —
        those pods re-route by their home slot, now owned by a survivor."""
        with self._route_lock:
            self._alive[dead] = False
            alive = [i for i, ok in enumerate(self._alive) if ok]
            if not alive:
                return []
            rr = 0
            for slot, owner in enumerate(self._slot_owner):
                if owner == dead:
                    self._slot_owner[slot] = alive[rr % len(alive)]
                    rr += 1
            for key, (target, _hops) in list(self._overrides.items()):
                if target == dead:
                    del self._overrides[key]
            return alive


class PartitionedScheduler:
    """The coordinator: N BatchScheduler pipelines + the dispatch layer +
    the global residual pass. Mirrors the BatchScheduler driving surface
    (sync / run_until_idle / stop / flush_binds / sched_stats /
    resync_from_store) so a harness can swap it in.

    framework: a Framework for partitions=1, or (partitions>1) a ZERO-ARG
    FACTORY returning a fresh Framework per pipeline — plugins carry
    per-scheduler handles (recorders, preemption state), and sharing one
    instance across pipelines would cross-wire them."""

    MAX_IDLE_ROUNDS = 12  # reroute hops are partition-bounded; this is slack

    def __init__(self, store: APIStore, framework=None, partitions: int = 2,
                 partition_by: str = "hash", profiles=None,
                 residual: bool = True, concurrent: Optional[bool] = None,
                 **kw):
        import os

        self.store = store
        self.partitions = partitions
        self.router = PartitionRouter(partitions, partition_by)
        self._single = partitions == 1
        # concurrent drive (run_until_idle): one thread per pipeline so host
        # work overlaps GIL-free kernel launches and device waits — the
        # point of the mode — but ONLY when the box has cores to overlap on.
        # On a 1-core machine N CPU-bound threads just thrash the GIL, so the
        # default degrades to round-robin sequential drives: same
        # dispatch/conflict/death semantics, no thrash.
        if concurrent is None:
            try:
                concurrent = len(os.sched_getaffinity(0)) > 1
            except AttributeError:  # platforms without affinity
                concurrent = (os.cpu_count() or 1) > 1
        self.concurrent_drive = bool(concurrent)
        if not self._single and not callable(framework):
            raise ValueError(
                "partitions > 1 needs a zero-arg framework FACTORY (each "
                "pipeline gets its own Framework; plugin handles are "
                "per-scheduler)")
        self._fw_factory = (framework if callable(framework)
                            else (lambda _fw=framework: _fw))
        self._profiles = profiles
        self._kw = dict(kw)
        # coordinator bookkeeping lock — LEAF like the router's: guards the
        # residual parking lot + death records only
        self._dispatch_lock = threading.Lock()
        self._residual_enabled = residual and not self._single
        self._residual: Optional[BatchScheduler] = None
        self._residual_keys: Set[str] = set()
        self._residual_qps: List[QueuedPodInfo] = []
        self._pending_dead: Set[int] = set()
        self._dead: Set[int] = set()
        self.dispatch_faults = 0  # absorbed partition.dispatch fail plans
        self.residual_passes = 0
        self.partitions_absorbed = 0
        self._sup_thread: Optional[threading.Thread] = None
        self._sup_stop = threading.Event()

        self.pipelines: List[BatchScheduler] = []
        for i in range(partitions):
            pipe = self._build_pipeline()
            if not self._single:
                pipe.partition_index = i
                pipe._node_filter = self._make_node_filter(i)
                pipe._pod_gate = self._make_pod_gate(i, pipe)
                pipe.reroute_hook = self._make_reroute_hook(i)
                pipe.conflict_sink = self._make_conflict_sink(i)
            self.pipelines.append(pipe)
        if not self._single:
            # each pipeline skips its PEERS' coalesced bind batches in O(1)
            # (disjoint shards, serial.py _peer_bind_origins); the
            # residual's origin is excluded: its binds can land on any shard
            for pipe in self.pipelines:
                pipe._peer_bind_origins = frozenset(
                    p._bind_origin for p in self.pipelines if p is not pipe)

    def _build_pipeline(self) -> BatchScheduler:
        if self._profiles is not None:
            return BatchScheduler(self.store, profiles=self._profiles,
                                  **self._kw)
        return BatchScheduler(self.store, self._fw_factory(), **self._kw)

    # -- dispatch-layer closures (one set per pipeline) ------------------------

    def _make_node_filter(self, idx: int) -> Callable:
        router = self.router

        def node_filter(node) -> bool:
            # serial.py passes the Node OBJECT from every LIST row and node
            # event, so zone mode learns name->zone here; hash mode is a
            # pure crc. Chaos can perturb routing only at the coordinator's
            # drive loop, never here (this runs inside ingest).
            return router.observe_node(node) == idx

        return node_filter

    def _make_pod_gate(self, idx: int, pipe: BatchScheduler) -> Callable:
        router = self.router
        from ..store import DELETED

        def gate(etype: str, pod: Pod) -> bool:
            node = pod.spec.node_name
            if node or pod.is_terminal():
                mine = (router.partition_of_node_name(node) == idx if node
                        else router.partition_of_pod(pod) == idx)
                if not mine and pipe.queue.contains(pod.key):
                    # a pod WE still track went bound/terminal through
                    # another partition — the lost-race cleanup (O(1) probe
                    # per foreign event; delete only on a hit)
                    pipe.queue.delete_key(pod.key)
                return mine
            if self._residual_enabled and spans_partitions(pod):
                # constraint-spanning PENDING pods (inter-pod affinity,
                # topology spread, gangs) are judged against the WHOLE
                # cluster by definition — a shard-limited pipeline could
                # ACCEPT a placement that violates a required constraint
                # whose witnesses live on another shard (a wrong accept
                # is final; only declines fall through). They go straight
                # to the global residual pass, parked ONCE by the
                # designated partition's gate (dedup by key); with the
                # residual disabled they pin to the designated partition
                # instead — best-effort, shard-local semantics.
                if etype != DELETED and idx == router.designated():
                    self._park_residual(pod)
                return False
            return router.partition_of_pod(pod) == idx

        return gate

    def _make_reroute_hook(self, idx: int) -> Callable:
        def hook(qp: QueuedPodInfo, _status) -> bool:
            target = self.router.next_hop(qp.pod, idx)
            from ..server import metrics as m

            if target is None:
                # routing exhausted (or constraint-spanning): the global
                # residual pass owns the terminal verdict
                if not self._residual_enabled:
                    return False  # park locally like a standalone scheduler
                with self._dispatch_lock:
                    self._residual_keys.add(qp.pod.key)
                    self._residual_qps.append(qp)
                m.partition_reroutes_total.inc(partition=str(idx),
                                               target="residual")
                return True
            self.pipelines[target].queue.add_requeued([qp])
            m.partition_reroutes_total.inc(partition=str(idx),
                                           target=str(target))
            return True

        return hook

    def _make_conflict_sink(self, idx: int) -> Callable:
        def sink(qp: QueuedPodInfo, _msg: str) -> None:
            from ..server import metrics as m

            m.partition_conflicts_total.inc(partition=str(idx))
            self.router.forget(qp.pod.key)

        return sink

    # -- aggregate counters ----------------------------------------------------

    def _members(self) -> List[BatchScheduler]:
        out = [p for i, p in enumerate(self.pipelines) if i not in self._dead]
        if self._residual is not None:
            out.append(self._residual)
        return out

    @property
    def scheduled_count(self) -> int:
        return sum(p.scheduled_count for p in self._members())

    @property
    def failed_count(self) -> int:
        return sum(p.failed_count for p in self._members())

    @property
    def conflicts_total(self) -> int:
        return sum(p.partition_conflicts for p in self.pipelines)

    @property
    def reroutes_total(self) -> int:
        return sum(p.partition_reroutes for p in self.pipelines)

    def conservation_members(self) -> Tuple[List[BatchScheduler],
                                            Optional[BatchScheduler]]:
        """(live pipelines, residual-or-None) for the pod-conservation
        checker: pipeline caches are DISJOINT (double-accounting across two
        of them is a bug), the residual's cache is a deliberate full MIRROR
        (every bound pod appears there too) and is only checked internally."""
        return ([p for i, p in enumerate(self.pipelines)
                 if i not in self._dead], self._residual)

    # -- lifecycle -------------------------------------------------------------

    def sync(self) -> None:
        for i, pipe in enumerate(self.pipelines):
            if i not in self._dead:
                pipe.sync()

    def flush_binds(self) -> None:
        for p in self._members():
            p.flush_binds()

    def pump_events(self) -> None:
        for p in self._members():
            p.pump_events()

    def flush_queues(self) -> None:
        """Backoff/unschedulable maintenance across every member (what the
        chaos harness drives between waves, mirroring the standalone
        loop's idle-path calls)."""
        for p in self._members():
            p.queue.flush_backoff_completed()
            p.queue.move_all_to_active_or_backoff()

    def attach_resource_sampler(self, sampler) -> None:
        """Forward an obs/resource.py ResourceSampler to every pipeline: each
        partition's windows grow resource columns and its sched/bind threads
        register under partition-labeled names (p0-sched, p1-bind, ...) so
        the per-thread CPU attribution shows whether the pipelines overlapped
        on a machine with several cores."""
        for p in self._members():
            p.attach_resource_sampler(sampler)

    def take_bind_failures(self) -> List:
        out: List = []
        for p in self._members():
            out.extend(p.take_bind_failures())
        return out

    def resync_from_store(self) -> Dict[str, int]:
        totals = {"nodes": 0, "bound": 0, "pending": 0, "dropped_assumes": 0}
        for p in self._members():
            counts = p.resync_from_store()
            for k in totals:
                totals[k] += counts.get(k, 0)
        return totals

    # -- driving ---------------------------------------------------------------

    def run_until_idle(self, max_cycles: int = 10_000) -> int:
        """Drive every live pipeline concurrently until the whole dispatch
        layer quiesces: pipelines drain their shards (overlapping solve and
        host work across threads), re-routed pods hop between rounds, dead
        partitions are absorbed, and parked residual pods get the global
        pass. Bounded like the standalone run_until_idle — pods in backoff
        stay there (the harness owns flush cadence)."""
        if self._single:
            return self.pipelines[0].run_until_idle(max_cycles)
        total = 0
        for _round in range(self.MAX_IDLE_ROUNDS):
            alive = [i for i in range(len(self.pipelines))
                     if i not in self._dead]
            if not alive:
                break
            cycles = [0] * len(self.pipelines)
            if self.concurrent_drive:
                threads = [
                    threading.Thread(target=self._drive_pipeline,
                                     args=(i, cycles, max_cycles),
                                     daemon=True)
                    for i in alive]
                for t in threads:
                    t.start()
                for idx, t in zip(alive, threads):
                    # per-thread CPU attribution: this round's drive thread
                    # IS the partition's scheduling thread; re-registration
                    # points the column at the live thread
                    sam = self.pipelines[idx].resource_sampler
                    if sam is not None:
                        sam.register_thread(f"p{idx}-sched", t)
                for t in threads:
                    t.join()
            else:
                # 1-core degradation: round-robin drives, identical
                # semantics (reroutes/conflicts/kills), no GIL thrash; the
                # bind workers still overlap their pipeline's solve
                for i in alive:
                    self._drive_pipeline(i, cycles, max_cycles)
            total += sum(cycles)
            with self._dispatch_lock:
                newly_dead = set(self._pending_dead)
                self._pending_dead.clear()
            if newly_dead:
                self._absorb_dead(newly_dead)
                continue  # survivors re-drive under the new routing
            self._run_residual_pass()
            if not self._work_remaining():
                break
        # advisory overrides are prunable at idle (double-routing is safe:
        # the conflict machinery absorbs it) — this bounds the map by the
        # in-flight re-routes instead of the run's history
        self.router.clear_overrides()
        return total

    def _drive_pipeline(self, i: int, cycles: List[int],
                        max_cycles: int) -> None:
        # the pipeline's kernel launches count under "p<i>" as well
        # (ops/kernels.py SCOPED_LAUNCHES)
        with launch_scope(f"p{i}"):
            self._drive_pipeline_scoped(i, cycles, max_cycles)

    def _drive_pipeline_scoped(self, i: int, cycles: List[int],
                               max_cycles: int) -> None:
        pipe = self.pipelines[i]
        n = 0
        try:
            while n < max_cycles:
                try:
                    if _chaos.ACTIVE is not None:
                        # the partition.dispatch chaos site: a fail plan is
                        # an absorbed dispatch hiccup (the cycle retries), a
                        # kill plan is THIS partition's hard death — the
                        # coordinator absorbs the shard (see _absorb_dead)
                        _chaos.ACTIVE.fire("partition.dispatch",
                                           key=f"partition-{i}")
                    if pipe.schedule_batch() == 0:
                        pipe.flush_binds()
                        pipe.pump_events()
                        pipe.sweep_expired_assumes()
                        if pipe.schedule_batch() == 0:
                            break
                    else:
                        pipe._drain_bind_results()
                    n += 1
                except FaultInjected:
                    self.dispatch_faults += 1
                    n += 1
            # the trailing flush sits INSIDE the kill domain too: a bind-
            # path kill plan (native.commit, store sites) firing here is
            # still this partition's hard death and must be absorbed
            pipe.flush_binds()
        except FaultKill:
            # hard partition death: no flush, no cleanup — exactly what a
            # crashed scheduler process leaves behind. In-flight bind
            # chunks may still land (committed RPCs); the survivors'
            # resync + conflict machinery reconcile either way.
            with self._dispatch_lock:
                self._pending_dead.add(i)
        cycles[i] = n

    def _park_residual(self, pod: Pod) -> None:
        """Hand a pending pod to the global residual pass (deduped by key:
        N events for one pod park it once — the pass re-LISTs anyway, the
        parking is the work signal + admission key)."""
        now = self.pipelines[0].clock.now()
        key = pod.key
        with self._dispatch_lock:
            if key in self._residual_keys:
                return
            self._residual_keys.add(key)
            self._residual_qps.append(QueuedPodInfo(pod=pod, timestamp=now))

    def _parked_count(self) -> int:
        with self._dispatch_lock:
            return len(self._residual_qps)

    def _work_remaining(self) -> bool:
        for i, pipe in enumerate(self.pipelines):
            if i in self._dead:
                continue
            if pipe.queue.lengths()[0] > 0:
                return True  # a re-route landed after that pipeline drained
        with self._dispatch_lock:
            return bool(self._residual_qps)

    # -- the global residual pass ----------------------------------------------

    def _ensure_residual(self) -> BatchScheduler:
        if self._residual is None:
            r = self._build_pipeline()
            r.partition_index = -1  # full view; labeled for observability
            r._pod_gate = self._residual_gate
            self._residual = r
        return self._residual

    def _residual_gate(self, _etype: str, pod: Pod) -> bool:
        if pod.spec.node_name or pod.is_terminal():
            return True  # the residual cache mirrors every node + bound pod
        with self._dispatch_lock:
            return pod.key in self._residual_keys

    def _run_residual_pass(self) -> int:
        """Schedule the parked residual pods against the FULL node set. Runs
        between partition rounds (a serialization point, so its assumes
        rarely race a live pipeline; when they do — background `start()`
        mode — the bind conflict machinery decides, like any cross-partition
        race). Rebuilds from a consistent LIST each pass: the residual
        pipeline holds no watch between passes, so its steady-state cost is
        zero when nothing falls through. On the card it launches kernel B
        for its full-view mirrors and, for constrained pods in the fast
        mode, C, D and A (propose and repair)."""
        with self._dispatch_lock:
            parked = self._residual_qps
            self._residual_qps = []
        if not parked:
            return 0
        r = self._ensure_residual()
        self.residual_passes += 1
        # the LIST re-admits every parked key through _residual_gate; parked
        # QueuedPodInfos are superseded by the fresh LIST rows (attempts
        # reset — the residual is a fresh global verdict, like a restarted
        # scheduler), so the qps themselves are dropped here
        r.resync_from_store()
        with launch_scope("residual"):
            handled = r.run_until_idle()
        r.flush_binds()
        if r._watch is not None:
            # no watch between passes: the next pass re-lists anyway, and an
            # idle subscription would just accumulate (then overflow) the
            # whole cluster's events
            r._watch.stop()
            r._watch = None
        # queue snapshot BEFORE the dispatch lock (leaf-lock discipline:
        # no queue/store/cache call may run while it is held)
        still = set(r.queue.tracked_keys())
        with self._dispatch_lock:
            # keys that bound (or went terminal) leave the residual set; a
            # pod the GLOBAL pass declared unschedulable stays parked in the
            # residual queue (its terminal verdict) until an event or the
            # next pass re-lists it
            self._residual_keys &= still | {
                qp.pod.key for qp in self._residual_qps}
        return handled

    # -- partition failure domains ---------------------------------------------

    def _absorb_dead(self, dead: Set[int]) -> None:
        """Survivors adopt a hard-killed partition's shard: remap the
        router, stop the corpse's machinery, then resync every survivor
        from the store under the new routing (bound pods and pending pods
        re-enter per the remapped slots — the crash-resync path, now
        cluster-shaped)."""
        from ..server import metrics as m

        for i in sorted(dead):
            if i in self._dead:
                continue  # already absorbed (idempotence)
            self._dead.add(i)
            self.partitions_absorbed += 1
            m.partition_deaths_total.inc(partition=str(i))
            self.router.absorb(i)
            corpse = self.pipelines[i]
            try:
                # a real crash takes the watch and workers with it; binds
                # already queued to the store may still land, which the
                # conflict machinery reconciles
                corpse.stop()
            except Exception:
                pass
        dead_origins = {self.pipelines[i]._bind_origin for i in self._dead}
        for j, pipe in enumerate(self.pipelines):
            if j not in self._dead:
                # the corpse's origin leaves the peer-skip set BEFORE the
                # resync: its in-flight binds that land after the survivor's
                # LIST are on nodes the survivor now OWNS and must be
                # ingested like any foreign bind
                pipe._peer_bind_origins = (pipe._peer_bind_origins
                                           - dead_origins)
                pipe.resync_from_store()

    def kill_partition(self, i: int) -> None:
        """Test/chaos surface: absorb partition i as if its drive thread
        had died hard (the chaos site does this in-band; this entry exists
        for harnesses that drive pipelines directly). Idempotent: a second
        kill of a corpse must not double-count the death or re-resync the
        survivors."""
        with self._dispatch_lock:
            self._pending_dead.discard(i)
            if i in self._dead:
                return
        self._absorb_dead({i})

    # -- background mode -------------------------------------------------------

    def start(self) -> None:
        if self._single:
            self.pipelines[0].start()
            return
        for i, pipe in enumerate(self.pipelines):
            if i not in self._dead:
                pipe.start()
        if self._sup_thread is not None:
            return
        self._sup_stop.clear()

        def supervise():
            while not self._sup_stop.is_set():
                for i, pipe in enumerate(self.pipelines):
                    if i in self._dead:
                        continue
                    t = pipe._thread
                    if t is not None and not t.is_alive():
                        # quiesce the SURVIVORS before the absorb: their
                        # resync_from_store must not race their own running
                        # loops (run_until_idle joins its drive threads
                        # before an absorb)
                        for j, other in enumerate(self.pipelines):
                            if j != i and j not in self._dead:
                                other.stop()
                        self._absorb_dead({i})
                        for j, other in enumerate(self.pipelines):
                            if j not in self._dead:
                                other.start()
                with self._dispatch_lock:
                    parked = bool(self._residual_qps)
                if parked:
                    self._run_residual_pass()
                self._sup_stop.wait(0.5)

        self._sup_thread = threading.Thread(target=supervise, daemon=True)
        self._sup_thread.start()

    def stop(self) -> None:
        self._sup_stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=2)
            self._sup_thread = None
        for p in self._members():
            p.stop()

    # -- observability ---------------------------------------------------------

    def sched_stats(self) -> Dict:
        """The coordinator's MERGED view: aggregate counters, the dispatch
        layer's routing/conflict/death totals, a merged stage table (totals
        summed; p99 is the per-partition max — a conservative tail), and
        one summary row per partition. Per-partition FULL stats stay on the
        pipelines' own registered sched_stats (each pipeline registers
        itself like any BatchScheduler, flightrec.register_scheduler)."""
        if self._single:
            return self.pipelines[0].sched_stats()
        merged_stages: Dict[str, Dict] = {}
        rows = []
        for i, pipe in enumerate(self.pipelines):
            dead = i in self._dead
            rows.append({
                "index": i,
                "dead": dead,
                "nodes": 0 if dead else pipe.cache.node_count(),
                "scheduled": pipe.scheduled_count,
                "failed": pipe.failed_count,
                "conflicts": pipe.partition_conflicts,
                "reroutes": pipe.partition_reroutes,
                "breaker": pipe.breaker.state,
                "queue": dict(zip(("active", "backoff", "unschedulable"),
                                  pipe.queue.lengths())),
            })
            if dead:
                continue
            for stage, row in pipe.flightrec.stage_table().items():
                got = merged_stages.setdefault(stage, {
                    "total_ms": 0.0, "batches": 0, "p99_ms": None,
                    "overlapped": row.get("overlapped", False)})
                got["total_ms"] = round(got["total_ms"]
                                        + (row.get("total_ms") or 0.0), 3)
                got["batches"] += row.get("batches", 0)
                p99 = row.get("p99_ms")
                if p99 is not None:
                    got["p99_ms"] = max(got["p99_ms"] or 0.0, p99)
        return {
            "partitions": self.partitions,
            "partition_by": self.router.partition_by,
            "concurrent_drive": self.concurrent_drive,
            "live": len(self.router.live_partitions()),
            "scheduled": self.scheduled_count,
            "failed": self.failed_count,
            "conflicts": self.conflicts_total,
            "reroutes": self.reroutes_total,
            "dispatch_faults": self.dispatch_faults,
            "partitions_absorbed": self.partitions_absorbed,
            "residual": {
                "enabled": self._residual_enabled,
                "passes": self.residual_passes,
                "parked": self._parked_count(),
                "scheduled": (self._residual.scheduled_count
                              if self._residual is not None else 0),
            },
            "stages_merged": merged_stages,
            "rows": rows,
        }
