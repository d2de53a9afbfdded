"""The scheduler's store-event loop: LIST + WATCH into cache and queue, bind
writes, failure handling.

The counterpart of the event plumbing in `kubernetes_tpu/scheduler/serial.py`
(sync :219, pump_events :268, _handle_event/_handle_pod, _handle_failure,
run_until_idle :935; reference: eventhandlers.go:364,
schedule_one.go handleSchedulingFailure :1022) that `BatchScheduler`
inherits. The per-pod Filter/Score cycle, the plugin framework with its
QueueingHints and preemption come with the serial framework and plugins
(ROADMAP.md queue 1 item 2): until then every cluster event that could make
a pod schedulable moves all unschedulable pods (the pre-hints behaviour of
the reference queue), and PreEnqueue is the SchedulingGates rule.

Gang plumbing (JAX serial.py :224-233, :397-414, :545-593): PodGroups are
listed before pods so the initial backlog stages under known quorums; every
pod event feeds the gang directory's placed counts, a membership change or a
PodGroup event re-evaluates the staged gangs, and a DELETED pod checks a
victim off the gang preemptor's in-flight covers. The directory and the
preemptor are installed by BatchScheduler; each hook is gated on them.
Failures are narrated as FailedScheduling events (api/events.py).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from ..api import Pod
from ..api.events import EventRecorder
from ..api.podgroup import pod_group_key
from ..api.types import DEFAULT_SCHEDULER_NAME, PodCondition
from ..store import (ADDED, DELETED, MODIFIED, APIStore, CoalescedEvent, NotFoundError)
from ..utils import Clock
from .cache import Cache
from .framework import Status
from .queue import (DEFAULT_POD_INITIAL_BACKOFF, DEFAULT_POD_MAX_BACKOFF, QueuedPodInfo,
                    SchedulingQueue)

_origin_seq = itertools.count()

NOT_PORTED = "not yet ported to the PyTorch/CUDA package (ROADMAP.md queue 1 item {})"


class Scheduler:
    """Wires store watch -> cache + queue -> a scheduling cycle -> bind writes.
    Subclasses provide schedule_cycle()."""

    WATCHED_KINDS = ("nodes", "pods", "namespaces", "podgroups")

    def __init__(self, store: APIStore, clock: Optional[Clock] = None,
                 pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
                 pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF):
        self.store = store
        self.clock = clock or Clock()
        self.cache = Cache()
        self.queue = SchedulingQueue(clock=self.clock, initial_backoff=pod_initial_backoff,
                                     max_backoff=pod_max_backoff,
                                     pre_enqueue=self._pre_enqueue)
        # our own bind batches come back tagged with this origin and need no
        # re-ingest (the bind path confirmed their assumes already)
        self._bind_origin = f"scheduler-torch-{next(_origin_seq)}"
        self._watch = None
        self.scheduled_count = 0
        self.failed_count = 0
        # event narration (EventRecorder, schedule_one.go:1008): best effort,
        # aggregated, never blocks scheduling
        self.recorder = EventRecorder(store, component="default-scheduler", clock=self.clock)
        # gang directory and preemptor (scheduler/gang.py, gangpreempt.py),
        # installed by BatchScheduler; every hook below is gated on them
        self.gangs = None
        self.gangpreempt = None
        # namespace labels for InterPodAffinity namespaceSelector
        self._ns_labels: Dict[str, Dict[str, str]] = {}

    # -- PreEnqueue (SchedulingGates, scheduling_gates.go) ----------------------

    @staticmethod
    def _pre_enqueue(pod: Pod) -> bool:
        return not pod.spec.scheduling_gates

    @staticmethod
    def _responsible(pod: Pod) -> bool:
        """responsibleForPod (eventhandlers.go): one default profile."""
        return pod.spec.scheduler_name == DEFAULT_SCHEDULER_NAME

    # -- informer-equivalent event handling (eventhandlers.go:364) -------------

    def sync(self) -> None:
        """Initial LIST of every watched kind under one RV, then WATCH from it
        (no event can fall between the list and the watch)."""
        self._rebuild_from_store(preserve_queue=False)

    def _rebuild_from_store(self, preserve_queue: bool) -> None:
        if self._watch is not None:
            self._watch.stop()
        self.cache = Cache()
        self._ns_labels.clear()
        lists, rv = self.store.list_many(self.WATCHED_KINDS)
        for n in lists["nodes"]:
            self.cache.add_node(n)
        if self.gangs is not None:
            # quorums must be known BEFORE pods are ingested, or the gang
            # members of the initial backlog would all wait in staging
            self.gangs.reset()
            for pg in lists["podgroups"]:
                self.gangs.observe_podgroup(ADDED, pg)
        known_pending = set()
        for p in lists["pods"]:
            if self.gangs is not None:
                self.gangs.observe_pod(ADDED, p)
            if p.spec.node_name:
                if not p.is_terminal():
                    self.cache.add_pod(p)
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
        self._watch = self.store.watch(kind=self.WATCHED_KINDS, since_rv=rv,
                                       maxsize=200_000, coalesce=True)

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
        if cev.kind == "pods" and cev.type == ADDED:
            admit: List[Pod] = []
            for ev in events:
                pod = ev.obj
                if pod.spec.node_name or pod.is_terminal() or not self._responsible(pod):
                    self._handle_pod(ADDED, pod)
                elif self._gate_pending_pod(pod):
                    admit.append(pod)
            self.queue.add_batch(admit)
            return len(events)
        for ev in events:
            self._handle_event(ev)
        return len(events)

    def _gate_pending_pod(self, pod: Pod) -> bool:
        """PreEnqueue one unbound pod: True admits it to the active queue; a
        gated pod is parked unschedulable, attributed to SchedulingGates."""
        if self._pre_enqueue(pod):
            return True
        self.queue.add_unschedulable(QueuedPodInfo(
            pod=pod, timestamp=self.clock.now(), unschedulable_plugins=("SchedulingGates",)))
        return False

    def _move_for_event(self) -> None:
        """A cluster event that can make pods schedulable (node add/update, a
        bound pod freeing resources): move every unschedulable pod."""
        self.queue.move_all_to_active_or_backoff()

    def _handle_event(self, ev) -> None:
        if ev.kind == "nodes":
            if ev.type == DELETED:
                self.cache.remove_node(ev.obj.metadata.name)
            else:
                self.cache.add_node(ev.obj)
            self._move_for_event()
        elif ev.kind == "pods":
            self._handle_pod(ev.type, ev.obj)
        elif ev.kind == "namespaces":
            self._ns_labels[ev.obj.metadata.name] = dict(ev.obj.metadata.labels)
        elif ev.kind == "podgroups":
            # a created or raised PodGroup can complete a staged gang's
            # quorum; a delete orphans its members (they schedule as ordinary
            # pods from then on)
            if self.gangs is not None:
                self.gangs.observe_podgroup(ev.type, ev.obj)
                self.queue.reconsider_gangs()
            self._move_for_event()

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
            if pod.spec.node_name:
                self.cache.remove_pod(pod)
                self._move_for_event()
            else:
                self.queue.delete(pod)
            return
        if pod.spec.node_name:
            if self.cache.is_assumed(pod.key):
                self.cache.add_pod(pod)  # confirm assumed
            elif etype == MODIFIED:
                self.cache.update_pod(pod)
                self._move_for_event()
            else:
                self.cache.add_pod(pod)
                self._move_for_event()
        else:
            if etype == MODIFIED and self.queue.update(pod):
                return  # status-only updates of queued pods don't requeue
            if self._gate_pending_pod(pod):
                self.queue.add(pod)

    # -- the cycle ----------------------------------------------------------------

    def schedule_cycle(self) -> int:
        """One scheduling cycle; returns the number of pods handled."""
        raise NotImplementedError(
            "the per-pod serial cycle is " + NOT_PORTED.format(2))

    def run_until_idle(self, max_cycles: int = 10_000) -> int:
        """Drive cycles until the active queue drains (test/bench harness)."""
        n = 0
        while n < max_cycles:
            if self.schedule_cycle() == 0:
                self.pump_events()
                if self.schedule_cycle() == 0:
                    break
            n += 1
        return n

    # -- failure ------------------------------------------------------------------

    def _handle_failure(self, qp: QueuedPodInfo, status: Status) -> None:
        """handleSchedulingFailure :1022 — park the pod unschedulable (it
        waits for a cluster event) and patch its PodScheduled condition."""
        self.failed_count += 1
        qp.unschedulable_plugins = (status.plugin,) if status.plugin else ()
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
