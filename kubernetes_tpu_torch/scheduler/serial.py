"""The serial scheduler: the store-event loop (LIST + WATCH into cache and
queue), the per-pod scheduling cycle, QueueingHints, PostFilter preemption,
bind writes and failure handling.

The counterpart of `kubernetes_tpu/scheduler/serial.py` (reference:
pkg/scheduler/schedule_one.go — ScheduleOne :65, schedulingCycle :138,
schedulePod :410, findNodesThatFitPod :462, numFeasibleNodesToFind :675
(adaptive 50 - nodes/125 %, floor 5%, min 100), prioritizeNodes :754,
selectHost :872, assume :945, bind :967, handleSchedulingFailure :1022;
eventhandlers.go:364; scheduling_queue.go:263 QueueingHintMap). One
deliberate divergence, as in the JAX package: selectHost breaks score ties
by lowest node index instead of reservoir sampling, so the per-pod cycle and
the solvers' argmax agree exactly. BatchScheduler (scheduler/batch.py)
inherits the event loop, the failure handling and the per-pod cycle, which
its device rejects reach through _maybe_preempt.

Profiles: one Framework per pod.spec.schedulerName (profile/profile.go); a
pod of a scheduler name with no profile is not ours. A cluster event moves an
unschedulable pod only if one of the plugins that rejected it registered the
event and its QueueingHint says Queue (_move_for_event); the
SchedulerQueueingHints gate off restores the move-everything behaviour.

Gang plumbing (JAX serial.py :224-233, :397-414, :545-593): PodGroups are
listed before pods so the initial backlog stages under known quorums; every
pod event feeds the gang directory's placed counts, a membership change or a
PodGroup event re-evaluates the staged gangs, and a DELETED pod checks a
victim off the gang preemptor's in-flight covers. The directory and the
preemptor are installed by BatchScheduler; each hook is gated on them.
Failures are narrated as FailedScheduling events (api/events.py).

Assume expiry (JAX serial.py :906-935): the cache runs on the scheduler's
clock; a bound assume's TTL starts at finish_binding, and
sweep_expired_assumes drops the assumes whose TTL ran out unconfirmed,
counts expired gang members back out of their quorum and requeues the pods
still pending in the store. The per-pod cycle collapses the batch path's
columnar cache rows before it snapshots (the plugins walk pod lists).

Storage and DRA (JAX serial.py :32-34, :186-196, :537-553): the volume
plugins of every profile share VolumeLister handles, filled from the store's
STORAGE_KINDS at LIST time, kept current by their watch events and cleared
on a relist; DynamicResources reads claims, slices and classes through the
store, so their events only move pods (QueueingHints).

Observability (JAX serial.py :127-132, :254, :382-389, :616, :646, :770-790,
:834): schedule_pod runs under a `Trace("Scheduling")` logged past 100 ms
(utils/tracing.py), schedule_one records the scheduling_attempts,
attempt-duration and pending-pods series (server/metrics.py), and the
flight recorder and pod tracer that BatchScheduler installs (`flightrec`,
`podtrace`, None on the serial loop) bill the watch's settlement time,
close a deleted pod's sampled span (note_deleted), stamp a pod bound by the
per-pod commit (pod_bound) and drop the live spans on a crash resync
(drop_live).

Partitioned dispatch (JAX serial.py :138-160, :225, :313-334, :400-416,
:517-526, :570-582): a shard pipeline of scheduler/partition.py carries a
node filter (LIST rows and node events outside its shard stay out of the
cache; a node re-slotted away is removed), a pod gate (pod events and LIST
rows of other partitions are skipped, after the gang directory counted
them, since quorums are cluster-scoped) and its peers' bind origins (a
peer's coalesced bind batch is skipped whole). All three are None or empty
on a standalone scheduler.

Not in this module: HTTP extenders (`extenders=` raises, ROADMAP.md queue 1
item 6) and the background start() thread (item 7g).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api import Pod
from ..api.events import EventRecorder
from ..api.podgroup import pod_group_key
from ..api.types import DEFAULT_SCHEDULER_NAME, PodCondition
from ..server import metrics
from ..store import (ADDED, DELETED, MODIFIED, APIStore, CoalescedEvent, NotFoundError,
                     pod_structural_clone)
from ..utils import Clock
from ..utils.featuregate import feature_gates
from ..utils.tracing import Trace
from .cache import Cache
from .framework import Code, CycleState, NodeInfo, Snapshot, Status
from .queue import (DEFAULT_POD_INITIAL_BACKOFF, DEFAULT_POD_MAX_BACKOFF, QueuedPodInfo,
                    SchedulingQueue)
from .runtime import Framework

_origin_seq = itertools.count()

# storage kinds mirrored into the volume plugins' VolumeLister handles
STORAGE_KINDS = ("persistentvolumeclaims", "persistentvolumes",
                 "storageclasses", "csinodes")
# DRA kinds: DynamicResources reads them through the store; their events
# only move pods
DRA_KINDS = ("resourceclaims", "resourceslices", "deviceclasses")

NOT_PORTED = "not yet ported to the PyTorch/CUDA package (ROADMAP.md queue 1 item {})"

MIN_FEASIBLE_NODES_TO_FIND = 100  # schedule_one.go:52
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5  # schedule_one.go:57


def num_feasible_nodes_to_find(num_all_nodes: int, percentage: int = 0) -> int:
    """schedule_one.go:675-701."""
    if num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND:
        return num_all_nodes
    if percentage == 0:
        percentage = int(50 - num_all_nodes / 125)
        if percentage < MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND:
            percentage = MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND
    if percentage >= 100:
        return num_all_nodes
    num = num_all_nodes * percentage // 100
    return max(num, MIN_FEASIBLE_NODES_TO_FIND)


@dataclass
class ScheduleResult:
    suggested_host: str = ""
    evaluated_nodes: int = 0
    feasible_nodes: int = 0
    status: Status = field(default_factory=Status.success)
    # node name -> failure status for PostFilter/preemption
    failed_nodes: Dict[str, Status] = field(default_factory=dict)
    scores: Dict[str, int] = field(default_factory=dict)
    # the cycle's state, threaded through Reserve/Permit/Bind (one CycleState
    # per cycle — the reference passes the same state end to end)
    state: Optional[CycleState] = None


class Scheduler:
    """Wires store watch -> cache + queue -> the scheduling cycle -> bind
    writes. framework: one port Framework (the default profile), or
    profiles: {schedulerName: Framework}; exactly one of them."""

    # LISTED_KINDS at sync and relist; WATCHED_KINDS are the kinds
    # _handle_event consumes (eventhandlers.go informer set)
    LISTED_KINDS = ("nodes", "pods", "namespaces", "podgroups") + STORAGE_KINDS
    WATCHED_KINDS = LISTED_KINDS + DRA_KINDS

    def __init__(self, store: APIStore, framework: Optional[Framework] = None,
                 clock: Optional[Clock] = None, percentage_of_nodes_to_score: int = 100,
                 profiles: Optional[Dict[str, Framework]] = None,
                 extenders: Optional[List] = None,
                 pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
                 pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF):
        if extenders:
            raise NotImplementedError("scheduler extenders are " + NOT_PORTED.format(6))
        # Profiles: one framework per pod.Spec.SchedulerName (profile/profile.go);
        # a bare framework is a single default profile.
        if profiles is None:
            if framework is None:
                raise ValueError("need framework or profiles")
            profiles = {DEFAULT_SCHEDULER_NAME: framework}
        elif framework is not None:
            raise ValueError("pass framework or profiles, not both")
        for name, fw in profiles.items():
            if not isinstance(fw, Framework):
                raise TypeError(f"profile {name!r}: expected a kubernetes_tpu_torch "
                                f"Framework, got {type(fw).__name__}")
        self.profiles = profiles
        self.framework = profiles.get(DEFAULT_SCHEDULER_NAME) or next(iter(profiles.values()))
        self.store = store
        self.clock = clock or Clock()
        self.cache = Cache(clock=self.clock)
        # QueueSort from the default profile (the reference requires every
        # profile to share one, validation.go); the default PrioritySort is
        # the queue's own tuple key (the same order, cheaper heap operations)
        from .plugins.node_plugins import PrioritySort

        qs = self.framework.queue_sort_plugin
        self.queue = SchedulingQueue(
            clock=self.clock, initial_backoff=pod_initial_backoff, max_backoff=pod_max_backoff,
            less=qs.less if qs is not None and not isinstance(qs, PrioritySort) else None,
            pre_enqueue=lambda pod: (self._fw(pod) or self.framework
                                     ).run_pre_enqueue(pod).is_success())
        self.percentage = percentage_of_nodes_to_score
        # our own bind batches come back tagged with this origin and need no
        # re-ingest (the bind path confirmed their assumes already)
        self._bind_origin = f"scheduler-torch-{next(_origin_seq)}"
        # partitioned dispatch hooks (scheduler/partition.py), installed by
        # PartitionedScheduler on its shard pipelines; all None standalone:
        #   _node_filter(node) -> bool: this pipeline's node shard (takes
        #       the Node OBJECT — zone partitioning reads its labels); a
        #       filtered node is never added to the cache.
        #   _pod_gate(etype, pod) -> bool: is this pod event MINE to ingest
        #       (bound pods by their node's shard, pending pods by the
        #       router); the gate may also clean a stale queue entry for a
        #       pod another partition just bound.
        self._node_filter = None
        self._pod_gate = None
        # bind origins of PEER partition pipelines (disjoint shards): a
        # peer's coalesced bind batch holds only pods bound onto the peer's
        # nodes, none of which this pipeline owns, so the whole batch is
        # skipped in O(1) instead of gating every event. A stale local queue
        # entry for such a pod self-heals through the bind-conflict path.
        self._peer_bind_origins: frozenset = frozenset()
        self._watch = None
        # pipeline flight recorder (scheduler/flightrec.py), installed by
        # BatchScheduler; None on the serial loop, every hook gated on it
        self.flightrec = None
        # sampled pod lifecycle tracer (scheduler/podtrace.py), installed by
        # BatchScheduler; None on the serial loop, hooks gated on it
        self.podtrace = None
        # coalesced watch ingest: a batched store write arrives as ONE
        # delivery; False takes every event per object (the parity oracle)
        self.watch_coalesce = True
        self.scheduled_count = 0
        self.failed_count = 0
        self.preemption_count = 0
        # QueueingHintMap per framework (buildQueueingHintMap, scheduler.go:405):
        # (resource, action) -> {plugin name: [hint fn | None]}
        self._hint_maps: Dict[int, Tuple[Dict, frozenset]] = {}
        # event narration (EventRecorder, schedule_one.go:1008): best effort,
        # aggregated, never blocks scheduling
        self.recorder = EventRecorder(store, component="default-scheduler", clock=self.clock)
        # gang directory and preemptor (scheduler/gang.py, gangpreempt.py),
        # installed by BatchScheduler; every hook below is gated on them
        self.gangs = None
        self.gangpreempt = None
        # namespace labels for InterPodAffinity namespaceSelector
        self._ns_labels: Dict[str, Dict[str, str]] = {}
        # plugins needing framework/store handles (DefaultPreemption); the
        # recorder is shared so plugin events use the same clock/aggregation
        for fw in self.profiles.values():
            for p in fw.plugins:
                if hasattr(p, "set_handles"):
                    p.set_handles(fw, store, recorder=self.recorder)
        # volume plugins share VolumeLister handles fed from the store's
        # storage kinds (the reference reaches these via shared informers)
        self._volume_listers = []
        seen = set()
        for fw in self.profiles.values():
            for p in fw.plugins:
                lister = getattr(p, "lister", None)
                if lister is not None and id(lister) not in seen and hasattr(lister, "add"):
                    seen.add(id(lister))
                    self._volume_listers.append(lister)
        self._push_ns_labels()

    def _fw(self, pod: Pod) -> Optional[Framework]:
        """frameworkForPod (schedule_one.go:378): profile by SchedulerName."""
        return self.profiles.get(pod.spec.scheduler_name)

    def _responsible(self, pod: Pod) -> bool:
        """responsibleForPod (eventhandlers.go): a profile exists for the pod."""
        return self._fw(pod) is not None

    def _push_ns_labels(self) -> None:
        for fw in self.profiles.values():
            for p in fw.plugins:
                if hasattr(p, "set_namespace_labels"):
                    p.set_namespace_labels(self._ns_labels)

    @classmethod
    def from_config(cls, store: APIStore, config=None, clock: Optional[Clock] = None,
                    volume_lister=None, **kwargs) -> "Scheduler":
        """Build from a KubeSchedulerConfiguration (dict or object): profiles,
        backoff, percentage (cmd/kube-scheduler/app/server.go Setup); the
        profiles' volume plugins share `volume_lister`. Extra keyword
        arguments pass to the constructor (BatchScheduler's device, solver,
        batch size)."""
        from .config import KubeSchedulerConfiguration, build_profiles

        if config is None or isinstance(config, dict):
            config = KubeSchedulerConfiguration.from_dict(config)
        profiles, _extenders = build_profiles(config, volume_lister)
        # 0 = adaptive percentage (numFeasibleNodesToFind, schedule_one.go:675)
        return cls(store, clock=clock, profiles=profiles,
                   percentage_of_nodes_to_score=config.percentage_of_nodes_to_score,
                   pod_initial_backoff=config.pod_initial_backoff_seconds,
                   pod_max_backoff=config.pod_max_backoff_seconds, **kwargs)

    # -- informer-equivalent event handling (eventhandlers.go:364) -------------

    def sync(self) -> None:
        """Initial LIST of every watched kind under one RV, then WATCH from it
        (no event can fall between the list and the watch)."""
        self._rebuild_from_store(preserve_queue=False, initial=True)

    def _rebuild_from_store(self, preserve_queue: bool,
                            initial: bool = False) -> Dict[str, int]:
        """The LIST into a fresh cache, then the WATCH. A relist or resync
        (not `initial`) also clears the volume listers first (an informer
        cache replace); the initial sync keeps objects a caller put into a
        lister it passed in, as the JAX sync does. Returns {nodes, bound,
        pending}: the listed nodes, and the listed non-terminal pods bound
        and pending."""
        if self._watch is not None:
            self._watch.stop()
        self.cache = Cache(clock=self.clock)
        if self.podtrace is not None and not preserve_queue and not initial:
            # a crash resync discards the queue, so the in-flight spans point
            # at QueuedPodInfos about to be replaced and can never complete:
            # drop them (counted as evicted). A relist KEEPS the queue's
            # objects and their span links, so their spans finish normally.
            self.podtrace.drop_live()
        self._ns_labels.clear()
        if not initial:
            for lister in self._volume_listers:
                lister.clear()
        lists, rv = self.store.list_many(self.LISTED_KINDS)
        nf = self._node_filter
        gate = self._pod_gate
        for n in lists["nodes"]:
            if nf is None or nf(n):
                self.cache.add_node(n)
        if self.gangs is not None:
            # quorums must be known BEFORE pods are ingested, or the gang
            # members of the initial backlog would all wait in staging
            self.gangs.reset()
            for pg in lists["podgroups"]:
                self.gangs.observe_podgroup(ADDED, pg)
        known_pending = set()
        bound = 0
        for p in lists["pods"]:
            if self.gangs is not None:
                # BEFORE the partition gate: gang quorums count bound
                # members wherever they run (cluster-scoped)
                self.gangs.observe_pod(ADDED, p)
            if gate is not None and not gate(ADDED, p):
                continue  # another partition's pod (dispatch layer routing)
            if p.spec.node_name:
                if not p.is_terminal():
                    self.cache.add_pod(p)
                    bound += 1
            elif not p.is_terminal():
                known_pending.add(p.key)
                if not (preserve_queue and self.queue.update(p)):
                    self._handle_pod(ADDED, p)
        if preserve_queue:
            # queued pods the LIST no longer holds as pending: gone
            for key in self.queue.tracked_keys():
                if key not in known_pending:
                    self.queue.delete_key(key)
            self.queue.move_all_to_active_or_backoff()
        for ns in lists["namespaces"]:
            self._ns_labels[ns.metadata.name] = dict(ns.metadata.labels)
        for kind in STORAGE_KINDS:
            for obj in lists[kind]:
                for lister in self._volume_listers:
                    lister.add(obj)
        self._push_ns_labels()
        self._watch = self.store.watch(kind=self.WATCHED_KINDS, since_rv=rv,
                                       maxsize=200_000, coalesce=self.watch_coalesce)
        # watch-propagation tap: settlement on OUR drain thread bills the
        # flight recorder's budget (the serial loop has none)
        self._watch.stat_sink = self.flightrec
        return {"nodes": len(lists["nodes"]), "bound": bound,
                "pending": len(known_pending)}

    def pump_events(self, max_events: int = 10_000) -> int:
        """Drain pending watch deliveries into cache/queue. An evicted (slow)
        watch forces a relist (the Reflector contract on terminated
        streams). Returns the number of per-object events ingested."""
        if self._watch is None:
            return 0
        if self._watch.terminated:
            self._rebuild_from_store(preserve_queue=True)
            return 0
        n = 0
        for ev in self._watch.drain(max_events):
            if type(ev) is CoalescedEvent:
                n += self._handle_coalesced(ev)
            else:
                self._handle_event(ev)
                n += 1
        return n

    def _handle_coalesced(self, cev: CoalescedEvent) -> int:
        """One batched write: our own bind batch needs no ingest; a batch of
        new pending pods is admitted to the queue in one call."""
        events = cev.events
        if cev.kind == "pods" and cev.type == MODIFIED and cev.origin == self._bind_origin:
            return len(events)
        if (cev.kind == "pods" and cev.type == MODIFIED and cev.origin is not None
                and cev.origin in self._peer_bind_origins):
            # a peer partition's bind batch: every event is a pod committed
            # onto THAT pipeline's disjoint node shard. MODIFIED only: an
            # origin-tagged DELETE batch frees capacity a later resync must
            # not be the first to notice
            return len(events)
        if cev.kind == "pods" and cev.type == ADDED:
            admit: List[Pod] = []
            gate = self._pod_gate
            for ev in events:
                pod = ev.obj
                if pod.spec.node_name or pod.is_terminal() or not self._responsible(pod):
                    self._handle_pod(ADDED, pod)
                elif gate is not None and not gate(ADDED, pod):
                    continue  # another partition's pod (dispatch layer)
                elif self._gate_pending_pod(pod):
                    admit.append(pod)
            self.queue.add_batch(admit)
            return len(events)
        for ev in events:
            self._handle_event(ev)
        return len(events)

    def _gate_pending_pod(self, pod: Pod) -> bool:
        """PreEnqueue one unbound pod: True admits it to the active queue; a
        gated pod is parked unschedulable with its rejecting plugin recorded,
        exactly as handleSchedulingFailure would."""
        st = (self._fw(pod) or self.framework).run_pre_enqueue(pod)
        if st.is_success():
            return True
        self.queue.add_unschedulable(QueuedPodInfo(
            pod=pod, timestamp=self.clock.now(), unschedulable_plugins=(st.plugin,)))
        return False

    _EVENT_ACTION = {ADDED: "add", MODIFIED: "update", DELETED: "delete"}

    def _hint_map(self, fw: Framework) -> Tuple[Dict, frozenset]:
        """Returns ((resource, action) -> {plugin: [hints]}, names of plugins
        that registered ANY event). A rejecting plugin that registered nothing
        is treated as interested in every event (the reference registers
        non-EnqueueExtensions plugins for all events — scheduler.go:405)."""
        got = self._hint_maps.get(id(fw))
        if got is None:
            hmap: Dict = {}
            registered = set()
            for p in fw.plugins:
                for ev in getattr(p, "events_to_register", lambda: ())():
                    registered.add(p.name)
                    hmap.setdefault((ev.resource, ev.action), {}) \
                        .setdefault(p.name, []).append(ev.hint)
            got = (hmap, frozenset(registered))
            self._hint_maps[id(fw)] = got
        return got

    def _move_for_event(self, resource: str, etype: str, obj) -> None:
        """Hint-gated requeue on a cluster event (scheduling_queue.go:263,1028
        QueueingHintMap + podMatchesEvent): an unschedulable pod moves only if
        one of its rejecting plugins registered this event and its hint (if
        any) returns Queue. Pods with no recorded rejector move conservatively;
        hint errors queue conservatively. SchedulerQueueingHints=false restores
        the pre-hints move-everything behavior."""
        if not feature_gates.enabled("SchedulerQueueingHints"):
            self.queue.move_all_to_active_or_backoff()
            return
        action = self._EVENT_ACTION.get(etype, etype)

        def should_move(qp: QueuedPodInfo) -> bool:
            if not qp.unschedulable_plugins:
                return True
            fw = self._fw(qp.pod) or self.framework
            hmap, registered = self._hint_map(fw)
            entries = hmap.get((resource, action), {})
            for name in qp.unschedulable_plugins:
                if not name or name not in registered:
                    # unattributed rejection, or a rejector that declared no
                    # events at all: conservative move on any event
                    return True
                hints = entries.get(name)
                if hints is None:
                    continue  # this plugin doesn't care about the event
                for h in hints:
                    if h is None:
                        return True
                    try:
                        if h(qp.pod, obj):
                            return True
                    except Exception:
                        return True  # hint error -> Queue (reference behavior)
            return False

        self.queue.move_pods_for_event(should_move)

    def _handle_event(self, ev) -> None:
        if ev.kind == "nodes":
            nf = self._node_filter
            if nf is not None and not nf(ev.obj):
                # not (or NO LONGER) this pipeline's shard: a routing
                # migration (zone mode — the zone label appearing after a
                # hash-fallback placement) re-slots a node to another
                # partition, and the old owner must drop it or two solvers
                # would each see the node's full capacity. remove_node of a
                # never-owned node is a no-op.
                self.cache.remove_node(ev.obj.metadata.name)
                return
            if ev.type == DELETED:
                self.cache.remove_node(ev.obj.metadata.name)
            else:
                self.cache.add_node(ev.obj)
            self._move_for_event("nodes", ev.type, ev.obj)
        elif ev.kind == "pods":
            self._handle_pod(ev.type, ev.obj)
        elif ev.kind == "namespaces":
            self._ns_labels[ev.obj.metadata.name] = dict(ev.obj.metadata.labels)
        elif ev.kind in STORAGE_KINDS:
            for lister in self._volume_listers:
                if ev.type == DELETED:
                    lister.remove(ev.obj)
                else:
                    lister.add(ev.obj)
            # a new or changed PV or class can unblock pending claims
            self._move_for_event(ev.kind, ev.type, ev.obj)
        elif ev.kind in DRA_KINDS:
            self._move_for_event(ev.kind, ev.type, ev.obj)
        elif ev.kind == "podgroups":
            # a created or raised PodGroup can complete a staged gang's
            # quorum; a delete orphans its members (they schedule as ordinary
            # pods from then on)
            if self.gangs is not None:
                self.gangs.observe_podgroup(ev.type, ev.obj)
                self.queue.reconsider_gangs()
            self._move_for_event("podgroups", ev.type, ev.obj)

    def _handle_pod(self, etype: str, pod: Pod) -> None:
        # unassigned pods of another scheduler are not ours; bound pods
        # still feed the cache
        if not pod.spec.node_name and not self._responsible(pod):
            return
        if etype == DELETED or pod.is_terminal():
            # a terminating victim checks off its cover; the LAST one
            # releases the parked gang to re-stage
            gp = self.gangpreempt
            if gp is not None and gp.has_waiting:
                gp.note_pod_deleted(pod.key)
        gate = self._pod_gate
        if gate is not None and not gate(etype, pod):
            # routed to another partition (dispatch layer), but gang quorum
            # accounting is CLUSTER-scoped: a member bound on a foreign shard
            # still counts toward this pipeline's gang directory, and a
            # membership change still re-evaluates the staged quorums
            if self.gangs is not None and self.gangs.active:
                self.gangs.observe_pod(etype, pod)
                if (etype == DELETED or pod.is_terminal() or pod.spec.node_name) \
                        and pod_group_key(pod):
                    self.queue.reconsider_gangs()
            return
        if self.gangs is not None:
            # bound members count toward quorum, deletes and terminals free
            # the slot (our own bind confirmations bypass this path: they
            # were counted at assume)
            self.gangs.observe_pod(etype, pod)
            if (self.gangs.active and (etype == DELETED or pod.is_terminal()
                                       or pod.spec.node_name) and pod_group_key(pod)):
                # membership changed: a staged gang may have reached quorum
                self.queue.reconsider_gangs()
        if pod.is_terminal() or etype == DELETED:
            pt = self.podtrace
            if etype == DELETED and not pod.is_terminal() and pt is not None and pt.enabled:
                # close a sampled span and remember the owner for the
                # evict->replace link; O(1) for unsampled pods
                pt.note_deleted(pod)
            if pod.spec.node_name:
                # a bound pod turning terminal frees its resources, the same
                # schedulability signal as an assigned-pod delete
                self.cache.remove_pod(pod)
                self._move_for_event("pods", DELETED, pod)
            else:
                self.queue.delete(pod)
            return
        if pod.spec.node_name:
            if self.cache.is_assumed(pod.key):
                self.cache.add_pod(pod)  # confirm assumed
            elif etype == MODIFIED:
                self.cache.update_pod(pod)
                self._move_for_event("pods", MODIFIED, pod)
            else:
                self.cache.add_pod(pod)
                self._move_for_event("pods", ADDED, pod)
        else:
            if etype == MODIFIED and self.queue.update(pod):
                return  # status-only updates of queued pods don't requeue
            if self._gate_pending_pod(pod):
                self.queue.add(pod)

    # -- core scheduling (schedule_one.go) -------------------------------------

    def schedule_pod(self, pod: Pod, snapshot: Optional[Snapshot] = None) -> ScheduleResult:
        """schedulePod :410 — snapshot, prefilter, filter, score, select.
        Traced with the reference's 100ms log threshold (schedule_one.go:411)."""
        trace = Trace("Scheduling", pod=pod.key)
        try:
            return self._schedule_pod_traced(pod, snapshot, trace)
        finally:
            trace.log_if_long(0.1)

    def _schedule_pod_traced(self, pod: Pod, snapshot: Optional[Snapshot],
                             trace) -> ScheduleResult:
        if snapshot is None:
            # the plugins walk snapshot pod lists: collapse the batch path's
            # columnar cache rows first (a no-op on the pure serial path)
            self.cache.materialize_columnar_rows()
            snapshot = self.cache.update_snapshot()
            trace.step("Snapshotting scheduler cache done")
        res = ScheduleResult()
        if len(snapshot) == 0:
            res.status = Status.unschedulable("no nodes available to schedule pods")
            return res
        framework = self._fw(pod) or self.framework
        state = CycleState()
        res.state = state
        pre_res, st = framework.run_pre_filter(state, pod, snapshot)
        if not st.is_success():
            res.status = st
            if st.is_rejected():
                # all nodes failed at prefilter
                res.failed_nodes = {ni.node.metadata.name: st for ni in snapshot.node_info_list}
            return res

        nodes = snapshot.node_info_list
        if pre_res.node_names is not None:
            nodes = [ni for ni in nodes if ni.node.metadata.name in pre_res.node_names]

        # Nominated-node fast path (:492): try the nominated node first
        if pod.status.nominated_node_name:
            ni = snapshot.get(pod.status.nominated_node_name)
            if ni is not None and framework.run_filter(state, pod, ni).is_success():
                res.evaluated_nodes = 1
                return self._score_and_select(state, pod, [ni], res)

        percentage = getattr(framework, "percentage_of_nodes_to_score", None)
        if percentage is None:
            percentage = self.percentage
        # in the cache's node order from its start (no rotating start index),
        # stopping once `limit` nodes fit
        limit = num_feasible_nodes_to_find(len(nodes), percentage)
        feasible: List[NodeInfo] = []
        for ni in nodes:
            st = framework.run_filter(state, pod, ni)
            res.evaluated_nodes += 1
            if st.is_success():
                feasible.append(ni)
                if len(feasible) >= limit:
                    break
            else:
                res.failed_nodes[ni.node.metadata.name] = st
        res.feasible_nodes = len(feasible)
        trace.step("Computing predicates done",
                   evaluated=res.evaluated_nodes, feasible=len(feasible))
        if not feasible:
            res.status = Status.unschedulable(f"0/{len(snapshot)} nodes are available", plugin="")
            return res
        out = self._score_and_select(state, pod, feasible, res)
        trace.step("Prioritizing done")
        return out

    def _score_and_select(self, state: CycleState, pod, feasible: List[NodeInfo],
                          res: ScheduleResult) -> ScheduleResult:
        framework = self._fw(pod) or self.framework
        res.feasible_nodes = len(feasible)
        if len(feasible) == 1:
            res.suggested_host = feasible[0].node.metadata.name
            return res
        st = framework.run_pre_score(state, pod, feasible)
        if not st.is_success():
            res.status = st
            return res
        totals = framework.run_score(state, pod, feasible)
        res.scores = totals
        # selectHost :872 — deterministic: max score, lowest list index on ties.
        best_name, best_score = None, None
        for ni in feasible:
            name = ni.node.metadata.name
            s = totals[name]
            if best_score is None or s > best_score:
                best_name, best_score = name, s
        res.suggested_host = best_name
        return res

    # -- the loop --------------------------------------------------------------

    def schedule_one(self, timeout: Optional[float] = 0.1) -> bool:
        """One ScheduleOne iteration. Returns False when no pod was popped."""
        self.pump_events()
        qp = self.queue.pop(timeout=timeout)
        if qp is None:
            return False
        t0 = time.perf_counter()
        result = self.schedule_pod(qp.pod)
        metrics.scheduling_attempts.inc(
            result="scheduled" if result.suggested_host else "unschedulable")
        metrics.scheduling_attempt_duration.observe(time.perf_counter() - t0)
        active, backoff, unsched = self.queue.lengths()
        metrics.pending_pods.set(active, queue="active")
        metrics.pending_pods.set(backoff, queue="backoff")
        metrics.pending_pods.set(unsched, queue="unschedulable")
        if not result.suggested_host:
            self._maybe_preempt(qp, result)
            self._handle_failure(qp, result.status, result.failed_nodes)
            return True
        self._commit_cycle(qp, result)
        return True

    def schedule_cycle(self) -> int:
        """One scheduling cycle; returns the number of pods handled."""
        return 1 if self.schedule_one(timeout=0.0) else 0

    def _commit_cycle(self, qp: QueuedPodInfo, result: ScheduleResult) -> bool:
        """assume (:945) -> Reserve -> Permit -> PreBind -> bind (:967) ->
        PostBind; binds synchronously. The assumed pod is a STRUCTURAL clone
        (schedule_one.go:148 DeepCopy analog): own metadata/spec/status
        objects, shared immutable innards. finish_binding starts the
        assume's TTL; our own bind's MODIFIED event confirms it on ingest."""
        pod = qp.pod
        framework = self._fw(pod) or self.framework
        assumed = pod_structural_clone(pod)
        try:
            self.cache.assume_pod(assumed, result.suggested_host)
        except ValueError:
            self._handle_failure(qp, Status.error("pod already in cache"))
            return False
        state = result.state if result.state is not None else CycleState()
        st = framework.run_reserve(state, assumed, result.suggested_host)
        if not st.is_success():
            self.cache.forget_pod(assumed)
            self._handle_failure(qp, st)
            return False
        st = framework.run_permit(state, assumed, result.suggested_host)
        if not st.is_success():
            framework.run_unreserve(state, assumed, result.suggested_host)
            self.cache.forget_pod(assumed)
            self._handle_failure(qp, st)
            return False
        try:
            st = framework.run_pre_bind(state, assumed, result.suggested_host)
            if not st.is_success():
                raise RuntimeError(f"prebind: {st.message()}")
            self.store.bind(pod.metadata.namespace, pod.metadata.name, result.suggested_host)
            self.cache.finish_binding(assumed)
            if self.gangs is not None:
                self.gangs.note_assumed(assumed)
            framework.run_post_bind(state, assumed, result.suggested_host)
            self.scheduled_count += 1
            pt = self.podtrace
            if pt is not None and pt.enabled:
                # a pod bound by the per-pod commit joins the submit->bound
                # distribution and, if sampled, completes its span here (the
                # per-pod loop's own granularity)
                pt.pod_bound(qp, self.clock.now())
            self.recorder.event(
                pod, "Normal", "Scheduled",
                f"Successfully assigned {pod.key} to {result.suggested_host}")
        except Exception as e:
            # handleBindingCycleError (:344): Unreserve + ForgetPod + requeue
            framework.run_unreserve(state, assumed, result.suggested_host)
            self.cache.forget_pod(assumed)
            self._handle_failure(qp, Status.error(str(e)))
            return False
        return True

    def _maybe_preempt(self, qp: QueuedPodInfo, result: ScheduleResult) -> None:
        """RunPostFilterPlugins on an Unschedulable cycle (schedule_one.go:175)."""
        if result.status.code != Code.UNSCHEDULABLE:
            return
        framework = self._fw(qp.pod) or self.framework
        if not framework.post_filter_plugins or not result.failed_nodes:
            return
        state = result.state if result.state is not None else CycleState()
        nominated, st = framework.run_post_filter(state, qp.pod, result.failed_nodes)
        if st.is_success() and nominated:
            qp.pod.status.nominated_node_name = nominated
            self.preemption_count += 1

    def sweep_expired_assumes(self) -> List[str]:
        """Expire the assumed pods whose bind never confirmed (cache.go's
        durationToExpireAssumedPod cleanup, scheduler.go:57-59) and act on
        it: gang quorums count the expired members back out, and the pods
        still pending in the store re-enter the queue (an expired assume
        means our bind never landed), which re-stages gang members under
        their group. Returns the expired pod keys."""
        expired = self.cache.cleanup_expired_assumed_pods()
        if not expired:
            return expired
        if self.gangs is not None and self.gangs.active:
            self.gangs.note_expired_keys(expired)
        for key in expired:
            try:
                pod = self.store.get("pods", key)
            except NotFoundError:
                continue
            if not pod.spec.node_name and not pod.is_terminal():
                self._handle_pod(ADDED, pod)
        return expired

    def run_until_idle(self, max_cycles: int = 100_000) -> int:
        """Drive the loop until the active queue drains (test/bench harness)."""
        n = 0
        while n < max_cycles:
            if self.schedule_cycle() == 0:
                self.pump_events()
                if self.schedule_cycle() == 0:
                    break
            n += 1
        return n

    # -- failure ------------------------------------------------------------------

    def _handle_failure(self, qp: QueuedPodInfo, status: Status,
                        failed_nodes: Optional[Dict[str, Status]] = None) -> None:
        """handleSchedulingFailure :1022 — park the pod unschedulable (it
        waits for a cluster event) and patch its PodScheduled condition.
        Records the rejecting plugins (QueuedPodInfo UnschedulablePlugins) so
        the hint-gated requeue knows which events matter."""
        self.failed_count += 1
        plugins = set()
        if failed_nodes:
            # keep "" for unattributed per-node rejections: should_move
            # treats it as move-on-any-event
            plugins = {st.plugin for st in failed_nodes.values()}
        elif status.plugin:
            plugins = {status.plugin}
        qp.unschedulable_plugins = tuple(sorted(plugins))
        self.queue.add_unschedulable(qp)
        message = status.message()
        self.recorder.event(qp.pod, "Warning", "FailedScheduling", message)

        def set_cond(st):
            st.phase = "Pending"
            st.conditions = [c for c in st.conditions if c.type != "PodScheduled"]
            st.conditions.append(PodCondition(type="PodScheduled", status="False",
                                              reason="Unschedulable", message=message))

        try:
            self.store.update_pod_status(qp.pod.metadata.namespace, qp.pod.metadata.name,
                                         set_cond)
        except NotFoundError:
            pass  # deleted meanwhile: its DELETED event drops it from the queue

    def stop(self) -> None:
        if self._watch is not None:
            self._watch.stop()
            self._watch = None
